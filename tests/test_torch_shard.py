"""The port's sharded trees (``models/shard.py``: ``llama.shard_params``,
``moe.shard_moe_params``, ``gather_params``) against the JAX package's
``shard_params`` / ``shard_moe_params`` on a 4-device CPU mesh.

One gloo world of 4 (``tests/torch_port_cases.py:shard_worker``, one
spawn) runs every case of ``SHARD_CASES`` at the JAX tests' shapes
(Llama: vocab 128, dim 64, 2 layers, 4/2 heads of 16, ffn 128, 128
tokens in two causal documents; the MoE and the DiT at their
``tests/test_models`` configs; float32, the weights of JAX's
``init_*`` carried over by ``from_numpy``): Llama ZeRO-3 at cp 4, Llama
ZeRO-3 + TP at (cp 2, tp 2) with a ``head_axis="tp"`` key, the DiT
ZeRO-3 at cp 4, the MoE without EP (expert stacks over dp) and with EP
4, both ZeRO-3 elsewhere, and the MoE with EP over ``"tp"`` at (cp 2,
tp 2). JAX runs ``shard_*`` and its ``train_step`` / ``moe_train_step``
(the DiT: ``make_optax_train_step`` with ``optax.sgd``, the port's
``make_optim_train_step`` with ``torch.optim.SGD``) on the same mesh,
its key on the ``sdpa`` backend.

Held on every rank: the losses of three SGD steps (rel 1e-5), every
parameter after one and after three steps, gathered by
``gather_params``, within float32 1e-5 of JAX's; each rank's shard equal
to the slice of the whole tensor that the stated layout names (ZeRO-3:
row block ``c``; column-parallel: rows ``c``, columns ``t``;
row-parallel: row block ``t * cp + c``; expert blocks by EP coordinate);
the tree keeps its family's layout and gathers back bitwise; the
collectives of a step (all-gathers and reduce-scatters one a sharded
leaf a use, the ``all_reduce`` counts of each mode); under TP each
rank's attention on 2 of 4 q heads and 1 of 2 kv heads; the TP-sharded
tree under a key without ``head_axis`` equal to the TP step (1e-5);
``remat`` within 1e-6; three AdamW steps of ``make_optim_train_step``
against ``make_optax_train_step`` (``optax.adamw``). EP over ``"tp"``
against EP over ``"cp"`` of the same mesh (the same row block per EP
rank) runs in the tier; against JAX it is ``slow``.
"""

import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu.api import magi_attn_flex_key
from magiattention_tpu.models import llama as jax_llama
from magiattention_tpu.models import moe as jax_moe
from magiattention_tpu.models import video_dit as jax_dit
from magiattention_tpu_torch.models import llama, moe, video_dit
from magiattention_tpu_torch.testing import assert_close
from tests.torch_port_cases import (
    ADAMW,
    DIT_CFG,
    DIT_T,
    LLAMA_CP_CFG,
    LLAMA_CP_SEQ,
    MOE_CFG,
    SHARD_CASES,
    SHARD_LR,
    SHARD_STEPS,
    dit_data,
    llama_cp_data,
    moe_data,
    shard_mesh_shape,
    shard_worker,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
S = LLAMA_CP_SEQ
SDPA = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}
JCFG = {
    "llama": jax_llama.LlamaConfig(**LLAMA_CP_CFG),
    "moe": jax_moe.MoEConfig(**MOE_CFG),
    "dit": jax_dit.VideoDiTConfig(**DIT_CFG),
}
LAYOUT = {"llama": llama.LAYOUT, "moe": moe.LAYOUT, "dit": video_dit.LAYOUT}
FAST = ("llama_z3", "llama_tp", "dit_z3", "moe_noep", "moe_ep4")


def _jax_init(family: str):
    """Fresh JAX parameters (the train steps donate theirs)."""
    init = {"llama": jax_llama.init_params, "moe": jax_moe.init_moe_params,
            "dit": jax_dit.init_params}[family]
    return init(JCFG[family], jax.random.key(0))


@lru_cache(maxsize=None)
def _trees() -> dict:
    return {f: jax.tree.map(np.asarray, _jax_init(f)) for f in JCFG}


@lru_cache(maxsize=None)
def _port_run() -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_shard_")
    mp.start_processes(shard_worker, args=(4, os.path.join(out_dir, "init"), out_dir, _trees()),
                       nprocs=4, start_method="spawn", join=True)
    return out_dir


@lru_cache(maxsize=None)
def _got(rank: int):
    return dict(np.load(os.path.join(_port_run(), f"shard_{rank}.npz")))


def _jax_mesh(axes) -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:4]).reshape(shard_mesh_shape(axes)), axes)


def _jax_key(family: str, mesh: Mesh, key_kw: dict):
    if family == "dit":
        return jax_dit.make_video_attn_key(JCFG["dit"], mesh, "cp")
    docs = [[0, S // 2], [S // 2, S]]
    return magi_attn_flex_key(docs, docs, [1, 1], S, S, mesh=mesh, cp_axis="cp", chunk_size=16,
                              **key_kw)


def _jax_shard(family: str, params, mesh: Mesh, shard_kw: dict):
    if family == "moe":
        return jax_moe.shard_moe_params(params, mesh, dp_axis="cp", **shard_kw)
    return jax_llama.shard_params(params, mesh, "cp", **shard_kw)


def _leaves(family: str, tree) -> list[np.ndarray]:
    return [np.asarray(a) for a in LAYOUT[family].leaves(tree)]


def _sdpa(fn):
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in SDPA.items():
            mpatch.setenv(k, v)
        return fn()


@lru_cache(maxsize=None)
def _jax_traj(case: str, optimizer: str = "sgd"):
    """JAX's SHARD_STEPS steps of ``case`` on its mesh: (losses, leaves
    after step 1, leaves after the last step)."""
    family, axes, shard_kw, key_kw, ep_axis = SHARD_CASES[case]
    cfg, mesh = JCFG[family], _jax_mesh(axes)
    key = _jax_key(family, mesh, key_kw)
    params = _jax_shard(family, _jax_init(family), mesh, shard_kw)
    tokens, labels = (jnp.asarray(a) for a in llama_cp_data())
    m_tokens, m_labels, _ = (jnp.asarray(a) for a in moe_data())
    clean, noise = (jnp.asarray(a) for a in dit_data())
    if optimizer == "adamw":
        opt = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                          weight_decay=ADAMW["weight_decay"])
    else:
        opt = optax.sgd(SHARD_LR)
    state = opt.init(params)
    if family == "dit":
        optax_step = jax_dit.make_optax_train_step(cfg, key, opt)
    elif optimizer == "adamw":
        optax_step = jax_llama.make_optax_train_step(cfg, key, opt)

    def run():
        p, st = params, state
        losses, after = [], []
        for i in range(SHARD_STEPS):
            if family == "dit":
                p, st, loss = optax_step(p, st, clean, noise, jnp.float32(DIT_T))
            elif optimizer == "adamw":
                p, st, loss = optax_step(p, st, tokens, labels)
            elif family == "llama":
                p, loss = jax_llama.train_step(p, cfg, tokens, labels, key, SHARD_LR)
            else:
                p, loss = jax_moe.moe_train_step(p, cfg, m_tokens, m_labels, key, ep_axis,
                                                 lr=SHARD_LR)
            losses.append(float(loss))
            if i in (0, SHARD_STEPS - 1):
                after.append(_leaves(family, jax.tree.map(np.asarray, p)))
        return np.asarray(losses), after[0], after[1]

    return _sdpa(run)


def _check_traj(case: str, tag: str, want) -> None:
    family = SHARD_CASES[case][0]
    losses, step1, last = want
    names = LAYOUT[family].names(_trees()[family])
    for r in range(4):
        got = _got(r)
        np.testing.assert_allclose(got[f"{tag}losses"], losses, rtol=1e-5)
        for step, w_all in ((1, step1), (SHARD_STEPS, last)):
            for j, (name, w) in enumerate(zip(names, w_all)):
                assert_close(got[f"{tag}step{step}_p{j}"], w,
                             msg=f"{case} rank {r} step {step} {name}", **TOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("case", FAST)
def test_steps_match_jax(case):
    want = _jax_traj(case)
    for r in range(4):
        np.testing.assert_allclose(_got(r)[f"{case}_losses"], want[0], rtol=1e-5)
    _check_traj(case, f"{case}_", want)


@pytest.mark.slow
def test_ep_over_tp_matches_jax():
    _check_traj("moe_ep_tp", "moe_ep_tp_", _jax_traj("moe_ep_tp"))


def test_ep_over_tp_equals_ep_over_cp():
    """At (cp 2, tp 2) EP over ``"tp"`` gives EP rank t the rows of block t
    of the global dispatched array, the rows cp rank t holds: the same
    routing, aux and drops as EP over ``"cp"`` of the same mesh; and on
    the whole (unsharded) tree the same step as on the sharded one."""
    for r in range(4):
        got = _got(r)
        for other in ("moe_ep_cp22_", "moe_ep_tp_whole_"):
            np.testing.assert_allclose(got["moe_ep_tp_losses"][0], got[f"{other}loss"],
                                       rtol=1e-5)
            for j in range(len(moe.LAYOUT.names(_trees()["moe"]))):
                assert_close(got[f"moe_ep_tp_step1_p{j}"], got[f"{other}p{j}"],
                             msg=f"rank {r} {other} leaf {j}", **TOL)


def test_adamw_matches_optax():
    _check_traj("llama_z3", "adamw_", _jax_traj("llama_z3", "adamw"))


def _block(a: np.ndarray, dim: int, i: int, n: int) -> np.ndarray:
    size = a.shape[dim] // n
    return np.take(a, np.arange(i * size, (i + 1) * size), axis=dim)


def _want_shard(case: str, name: str, a: np.ndarray, rank: int) -> np.ndarray:
    """The stated layout, written out: rank = c * 2 + t on (cp 2, tp 2)."""
    family, axes, shard_kw, _, _ = SHARD_CASES[case]
    key = name.rsplit(".", 1)[-1]
    if len(axes) == 1:
        c, t, cp = rank, 0, 4
    else:
        c, t, cp = rank // 2, rank % 2, 2
    if key in ("w_gate", "w_up", "w_down") and a.ndim == 3:  # expert stacks
        ep_axis = shard_kw.get("ep_axis")
        i = t if ep_axis == "tp" else c
        return _block(a, 0, i, 2 if ep_axis == "tp" else cp)
    if a.ndim < 2 or a.shape[0] % cp:
        return a
    if shard_kw.get("tp_axis") and key in ("wq", "wk", "wv", "w_gate", "w_up"):
        return _block(_block(a, 0, c, cp), 1, t, 2)
    if shard_kw.get("tp_axis") and key in ("wo", "w_down"):
        return _block(a, 0, t * cp + c, 2 * cp)
    return _block(a, 0, c, cp)


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_shards_are_the_stated_blocks(case):
    family = SHARD_CASES[case][0]
    tree = _trees()[family]
    names = LAYOUT[family].names(tree)
    for r in range(4):
        got = _got(r)
        assert bool(got[f"{case}_layout"]) and bool(got[f"{case}_roundtrip"])
        for j, (name, a) in enumerate(zip(names, _leaves(family, tree))):
            np.testing.assert_array_equal(got[f"{case}_s{j}"], _want_shard(case, name, a, r),
                                          err_msg=f"{case} rank {r} {name}")


# (all_gather, reduce_scatter) of a step: one gather a ZeRO-3 leaf a use
# and its reduce-scatter (Llama: embed, lm_head, seven projections a
# layer; the DiT six top leaves and eight a layer; the MoE's attention and
# router, and without EP its three stacks), plus the MoE's rows: without
# EP one gather over cp a layer; EP over tp one over cp, one out of the EP
# region and one in the backward of the scatter into it
GATHERS = {"llama_z3": (16, 16), "llama_tp": (16, 16), "dit_z3": (22, 22),
           "moe_noep": (20, 20), "moe_ep4": (12, 12), "moe_ep_tp": (18, 14)}
# the label count and the flat sum (the DiT: the flat sum); TP four a
# layer; EP over cp the aux mean a layer; EP over tp the aux's and the
# router's region all-reduces a layer
ALL_REDUCES = {"llama_z3": 2, "llama_tp": 2 + 4 * 2, "dit_z3": 1, "moe_noep": 2,
               "moe_ep4": 2 + 2, "moe_ep_tp": 2 + 2 * 2}


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_collectives_of_a_step(case):
    for r in range(4):
        got = _got(r)
        counts = (int(got.get(f"{case}_count_all_gather", 0)),
                  int(got.get(f"{case}_count_reduce_scatter", 0)))
        assert counts == GATHERS[case], (case, counts)
        assert int(got[f"{case}_all_reduce_calls"]) == ALL_REDUCES[case], case


def test_tp_heads_and_tree_without_head_axis():
    """Under TP each rank's attention gets n_heads / tp q heads and
    n_kv_heads / tp kv heads; with a key without ``head_axis`` the same
    TP-sharded tree gathers every leaf and computes the TP step's loss
    and gradients on every head."""
    hq, hk = LLAMA_CP_CFG["n_heads"], LLAMA_CP_CFG["n_kv_heads"]
    names = llama.LAYOUT.names(_trees()["llama"])
    for r in range(4):
        got = _got(r)
        assert got["tp_heads"].tolist() == [[hq // 2, hk // 2]] * 2
        assert got["tpfull_heads"].tolist() == [[hq, hk]] * 2
        np.testing.assert_allclose(got["tpfull_loss"], got["llama_tp_losses"][0], rtol=1e-5)
        for j, name in enumerate(names):
            assert_close(got[f"tpfull_g{j}"], got[f"tp_g{j}"], msg=f"rank {r} {name}", **TOL)


def test_dit_megatron_equals_gathered():
    """The DiT's blocks under Megatron TP (a ``head_axis`` key over the
    TP-sharded tree, two kv heads) against the same tree under the video
    key (every leaf gathered, the compute replicated): loss and gathered
    gradients within 1e-5; the tree keeps its layout and gathers back."""
    for r in range(4):
        got = _got(r)
        assert bool(got["dit_tp_layout"]) and bool(got["dit_tp_roundtrip"])
        np.testing.assert_allclose(got["dit_tp_loss"], got["dit_tpfull_loss"], rtol=1e-5)
        for j, name in enumerate(video_dit.LAYOUT.names(_trees()["dit"])):
            want = got[f"dit_tpfull_g{j}"]
            assert_close(got[f"dit_tp_g{j}"], want, msg=f"rank {r} {name}",
                         **{**TOL, "atol": 1e-5 * max(1.0, float(np.abs(want).max()))})


def test_remat_gathers_again():
    for r in range(4):
        got = _got(r)
        assert float(got["remat_loss_diff"]) <= 1e-6
        assert float(got["remat_grad_diff"]) <= 1e-6
