"""The port's MoE family (``models/moe.py``) against the JAX package's on
the same numpy inputs, at the shapes of JAX's
``tests/test_models/test_moe.py`` (vocab 128, dim 64, 2 layers, 4/2 heads
of 16, ffn 96, 8 experts, top-2, 128 tokens in two causal documents,
chunk 16, float32), with the weights of JAX ``init_moe_params`` carried
over by ``moe_params_from_numpy``.

- Routing: the port's slot indices as dense ``(S, E, C)`` tensors equal
  JAX ``_route``'s dispatch (exactly) and combine (1e-6), aux 1e-6, over
  capacities with and without drops and on tied logits (integer-valued
  inputs, so the ties are exact on both sides: the lower expert wins).
- ``_moe_ffn_local`` against JAX's at cp 1 (float32 1e-5), and
  ``moe_ffn_reference`` against JAX's (1e-5).
- One gloo world of 4 (``tests/torch_port_cases.py:moe_worker``): EP at
  ep 2 and 4 against JAX's ``moe_ffn(mesh=..., ep_axis="ep")`` on a CPU
  mesh (output 1e-5, aux 1e-6), the layer's gradients at ep 4 against
  ``jax.grad`` (1e-5 of max(1, the largest |gradient|): the loss
  ``sum(y * y)`` puts them in the hundreds); the full model at cp 4 with ``ep_axis="cp"``
  against JAX's ``moe_forward`` / ``value_and_grad(moe_loss_fn)`` at the
  same key (JAX's ``sdpa`` backend), at capacity 8 and the default, on
  the tree of ``shard_moe_params(..., ep_axis="cp")`` (expert blocks,
  ZeRO-3 elsewhere): logits, aux, loss and every gradient (gathered by
  ``models.shard.gather_leaves``) within 1e-5, ``remat`` within 1e-6 of
  no remat; under one causal document, the step at overlap
  degree 2 (two stages) within 1e-5 of degree 1; three
  ``moe_train_step``s against JAX's trajectory
  (losses rel 1e-5, parameters 1e-5); the model without EP against
  JAX's; the divisibility error with JAX's message.

The test shapes divide evenly: each rank's 32 rows and capacity are JAX's
shard's. JAX pads dispatch plans to rank-uniform shapes, and padded rows
would take capacity like any other row.
"""

import dataclasses
import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu.api import magi_attn_flex_key, undispatch
from magiattention_tpu.models import moe as jax_moe
from magiattention_tpu_torch.models import moe
from magiattention_tpu_torch.testing import assert_close
from tests.torch_port_cases import (
    MOE_CFG,
    MOE_CFS,
    MOE_CHUNK,
    MOE_LR,
    MOE_SEQ,
    MOE_STEPS,
    moe_data,
    moe_worker,
)

S, CP = MOE_SEQ, 4
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)


def _tol(want) -> dict:
    """float32 1e-5, the absolute part relative to the array's scale."""
    return {**TOL, "atol": 1e-5 * max(1.0, float(np.abs(want).max()))}
JCFG = jax_moe.MoEConfig(**MOE_CFG)
PCFG = moe.MoEConfig(**MOE_CFG)
SDPA = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}


@lru_cache(maxsize=None)
def _jax_params():
    return jax_moe.init_moe_params(JCFG, jax.random.key(0))


@lru_cache(maxsize=None)
def _tree():
    return jax.tree.map(np.asarray, _jax_params())


def _leaves(tree) -> list[np.ndarray]:
    """The JAX pytree's arrays in the port's ``LAYOUT`` order."""
    return [np.asarray(a) for a in moe.LAYOUT.leaves(tree)]


def _port_layer(lyr) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in lyr.items()}


def _dense_route(slot, gates, n_experts: int, cap: int):
    """The port's route as JAX's (S, E, C) dispatch and combine tensors."""
    s = slot.shape[0]
    d = np.zeros((s, n_experts * cap + 1))
    c = np.zeros((s, n_experts * cap + 1))
    for k in range(slot.shape[1]):
        d[np.arange(s), slot[:, k]] += 1.0
        c[np.arange(s), slot[:, k]] += gates[:, k]
    shape = (s, n_experts, cap)
    return d[:, :-1].reshape(shape), c[:, :-1].reshape(shape)


def _check_route(h, router, cfg_kw):
    jcfg = dataclasses.replace(JCFG, **cfg_kw)
    disp, comb, aux = jax.jit(jax_moe._route, static_argnums=2)(jnp.asarray(h), jnp.asarray(router),
                                                                 jcfg)
    slot, gates, aux_p, cap = moe._route(torch.from_numpy(h), torch.from_numpy(router),
                                         dataclasses.replace(PCFG, **cfg_kw))
    assert cap == disp.shape[2]
    d, c = _dense_route(slot.numpy(), gates.numpy(), jcfg.n_experts, cap)
    np.testing.assert_array_equal(d, np.asarray(disp))
    np.testing.assert_allclose(c, np.asarray(comb), atol=1e-6)
    np.testing.assert_allclose(aux_p.item(), float(aux), rtol=1e-6)
    return d


# JAX _route: capacity 8 keeps every choice, the default and 0.25 drop
@pytest.mark.parametrize("seed,cf,top_k", [(0, 1.25, 2), (1, 0.25, 2), (2, 8.0, 2), (3, 0.5, 1)])
def test_route_matches_jax(seed, cf, top_k):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((S, PCFG.dim)).astype(np.float32)
    d = _check_route(h, _tree()["layers"][0]["router"], dict(capacity_factor=cf, top_k=top_k))
    kept = d.sum()
    assert (kept == S * top_k) if cf == 8.0 else (kept < S * top_k)


@pytest.mark.parametrize("router", ["zeros", "repeated_columns"])
def test_route_ties_take_the_lower_expert(router):
    """Integer-valued h and router: every logit is an exact integer on
    both sides, so tied logits tie exactly; JAX's ``lax.top_k`` takes
    the lower index, and so must the port."""
    rng = np.random.default_rng(4)
    h = rng.integers(-2, 3, (S, PCFG.dim)).astype(np.float32)
    w = np.zeros((PCFG.dim, PCFG.n_experts), np.float32)
    if router == "repeated_columns":
        w = rng.integers(-1, 2, (PCFG.dim, PCFG.n_experts)).astype(np.float32)
        w[:, 5] = w[:, 7] = w[:, 2]
        w[:, 6] = w[:, 1]
    logits = h @ w
    top2 = np.sort(logits, axis=1)[:, -2:]
    assert (top2[:, 0] == top2[:, 1]).sum() > S // 4  # ties decide many picks
    d = _check_route(h, w, {})
    if router == "zeros":  # all tie: experts 0 and 1 for every token, in order
        assert d[:, :2].sum() == min(S, d.shape[2]) * 2 and d[:, 2:].sum() == 0


@pytest.mark.parametrize("cf,top_k", [(8.0, 2), (1.25, 2), (0.25, 1)])
def test_moe_ffn_local_matches_jax(cf, top_k):
    lyr = _tree()["layers"][0]
    _, _, h = moe_data()
    jcfg = dataclasses.replace(JCFG, capacity_factor=cf, top_k=top_k)
    y, aux = jax.jit(
        lambda h: jax_moe._moe_ffn_local(h, lyr["router"], lyr["w_gate"], lyr["w_up"],
                                         lyr["w_down"], jcfg, None, 1)
    )(jnp.asarray(h))
    p = _port_layer(lyr)
    y_p, aux_p = moe._moe_ffn_local(torch.from_numpy(h), p["router"], p["w_gate"], p["w_up"],
                                    p["w_down"], dataclasses.replace(PCFG, capacity_factor=cf,
                                                                     top_k=top_k))
    assert_close(y_p, np.asarray(y), msg=f"cf {cf}", **TOL)
    np.testing.assert_allclose(aux_p.item(), float(aux), rtol=1e-6)
    ref_p = moe.moe_ffn_reference(torch.from_numpy(h), p, dataclasses.replace(PCFG, top_k=top_k))
    assert_close(ref_p, np.asarray(jax_moe.moe_ffn_reference(jnp.asarray(h), lyr, jcfg)),
                 msg="moe_ffn_reference", **TOL)
    if cf == 8.0:  # no drop: the routed FFN is the reference
        assert_close(y_p, ref_p, msg="routed vs reference", **TOL)


def test_entries_refuse_what_a_per_rank_process_cannot_do():
    """JAX's in-``shard_map`` form of ``moe_ffn`` has no per-rank
    counterpart, and EP over an axis the key's mesh lacks raises (JAX: a
    ``KeyError`` of the mesh). ``shard_moe_params`` without ``ep_axis``
    is JAX's ZeRO-3 of the expert stacks over dp: on a one-rank mesh every
    block is the whole leaf, and the step is the unsharded one bitwise."""
    cfg, lyr = PCFG, _port_layer(_tree()["layers"][0])
    h = torch.from_numpy(moe_data()[2])
    with pytest.raises(ValueError, match="no counterpart in a per-rank process"):
        moe.moe_ffn(h, lyr, cfg, mesh=None, ep_axis="ep")
    from magiattention_tpu_torch import api

    key = api.magi_attn_flex_key([[0, S]], [[0, S]], [1], S, S, device="cpu", chunk_size=MOE_CHUNK)
    tokens, labels, _ = (torch.from_numpy(a) for a in moe_data())
    params = moe.moe_params_from_numpy(_tree(), "cpu")
    with pytest.raises(ValueError, match="not an axis of the key's mesh"):
        moe.moe_forward(params, cfg, tokens, key, ep_axis="ep")
    sharded = moe.shard_moe_params(params, api.get_mesh(key))
    assert sharded["sharding"].layer["w_gate"].rows == ("cp",)
    loss, grads = moe.moe_value_and_grad(params, cfg, tokens, labels, key)
    loss_s, grads_s = moe.moe_value_and_grad(sharded, cfg, tokens, labels, key)
    assert torch.equal(loss_s, loss) and all(torch.equal(a, b) for a, b in zip(grads_s, grads))


# ---------------------------------------------------------------------------
# one gloo world of 4 against the JAX package on a 4-device CPU mesh
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _port_run() -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_moe_")
    mp.start_processes(moe_worker, args=(CP, os.path.join(out_dir, "init"), out_dir, _tree()),
                       nprocs=CP, start_method="spawn", join=True)
    return out_dir


def _got(rank: int):
    return np.load(os.path.join(_port_run(), f"moe_{rank}.npz"))


def _mesh(n: int, name: str) -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:n]), axis_names=(name,))


@lru_cache(maxsize=None)
def _jax_key():
    return magi_attn_flex_key([[0, S // 2], [S // 2, S]], [[0, S // 2], [S // 2, S]], [1, 1], S, S,
                              mesh=_mesh(CP, "cp"), chunk_size=MOE_CHUNK)


def _block(a: np.ndarray, rank: int) -> np.ndarray:
    n = a.shape[0] // CP
    return a[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_ffn_matches_jax(ep):
    lyr = _tree()["layers"][0]
    _, _, h = moe_data()
    y, aux = jax.jit(lambda h: jax_moe.moe_ffn(h, lyr, JCFG, mesh=_mesh(ep, "ep"), ep_axis="ep"))(
        jnp.asarray(h))
    y = np.asarray(y)
    for r in range(CP):
        c = r % ep  # ep 2: the ep coordinate of (dp 2, ep 2)
        got = _got(r)
        assert_close(got[f"ep{ep}_y"], y[c * S // ep:(c + 1) * S // ep], msg=f"ep {ep} rank {r}",
                     **TOL)
        np.testing.assert_allclose(float(got[f"ep{ep}_aux"]), float(aux), rtol=1e-6)


def test_ep_gradients_match_jax():
    lyr = _jax_params()["layers"][0]
    _, _, h = moe_data()

    def loss(lyr, h):
        y, aux = jax_moe.moe_ffn(h, lyr, JCFG, mesh=_mesh(CP, "ep"), ep_axis="ep")
        return jnp.sum(y * y) + aux

    grads = jax.jit(jax.grad(loss))(lyr, jnp.asarray(h))
    for r in range(CP):
        got = _got(r)
        for k in ("router", "w_gate", "w_up", "w_down"):
            want = np.asarray(grads[k])
            want = want if k == "router" else _block(want, r)
            assert_close(got[f"ep4_g_{k}"], want, msg=f"rank {r} {k}", **_tol(want))


@lru_cache(maxsize=None)
def _jax_model(cf: float, ep_axis):
    cfg = dataclasses.replace(JCFG, capacity_factor=cf)
    tokens, labels, _ = (jnp.asarray(a) for a in moe_data())
    key = _jax_key()
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in SDPA.items():
            mpatch.setenv(k, v)
        logits, aux = jax.jit(jax_moe.moe_forward, static_argnums=(1, 3, 4))(
            _jax_params(), cfg, tokens, key, ep_axis)
        vg = jax.jit(jax.value_and_grad(jax_moe.moe_loss_fn), static_argnums=(1, 4, 5))
        loss, grads = vg(_jax_params(), cfg, tokens, labels, key, ep_axis)
    return (np.asarray(undispatch(logits, key)), float(aux), float(loss),
            _leaves(jax.tree.map(np.asarray, grads)))


def _check_grads(tag: str, got, want: list, rank: int) -> None:
    names = moe.LAYOUT.names(_tree())
    for j, (name, w) in enumerate(zip(names, want)):
        assert_close(got[f"{tag}g{j}"], w, msg=f"rank {rank} {tag}{name}", **_tol(w))


@pytest.mark.parametrize("i", range(len(MOE_CFS)))
def test_model_at_cp4_with_ep_matches_jax(i):
    logits, aux, loss, grads = _jax_model(MOE_CFS[i], "cp")
    for r in range(CP):
        got = _got(r)
        assert_close(got[f"cf{i}_logits"], logits, msg=f"rank {r} logits", **TOL)
        np.testing.assert_allclose(float(got[f"cf{i}_aux"]), aux, rtol=1e-5)
        np.testing.assert_allclose(float(got[f"cf{i}_loss"]), loss, rtol=1e-5)
        # the label count, each layer's aux mean, the flat sum
        assert int(got[f"cf{i}_all_reduce_calls"]) == 2 + PCFG.n_layers
        _check_grads(f"cf{i}_", got, grads, r)
        # remat: the same step, each layer recomputed in the backward
        for name in ("logits", "loss"):
            np.testing.assert_allclose(got[f"cf{i}_remat_{name}"], got[f"cf{i}_{name}"],
                                       rtol=1e-6, atol=1e-6)
        for j in range(len(grads)):
            np.testing.assert_allclose(got[f"cf{i}_remat_g{j}"], got[f"cf{i}_g{j}"], rtol=1e-6,
                                       atol=1e-6)


def test_ep_at_overlap_degree2_equals_degree1():
    """The EP step under one causal document at overlap degree 2 (two
    stages: the staged GroupCasts and GroupReduces interleaved with the
    MoE exchanges on one group) equals degree 1 (one merged stage) within
    float32 1e-5: the dispatch, so the routing, is the same; the
    attention's partial results merge in another order."""
    names = moe.LAYOUT.names(_tree())
    for r in range(CP):
        got = _got(r)
        assert int(got["degree1_stages"]) == 1 and int(got["degree2_stages"]) == 2
        np.testing.assert_allclose(float(got["degree2_loss"]), float(got["degree1_loss"]),
                                   rtol=1e-5)
        for j, name in enumerate(names):
            want = got[f"degree1_g{j}"]
            assert_close(got[f"degree2_g{j}"], want, msg=f"rank {r} {name}", **_tol(want))


def test_train_steps_match_jax():
    tokens, labels, _ = moe_data()
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in SDPA.items():
            mpatch.setenv(k, v)
        params, losses = _jax_params(), []
        for _ in range(MOE_STEPS):
            params, loss = jax_moe.moe_train_step(params, JCFG, tokens, labels, _jax_key(), "cp",
                                                  lr=MOE_LR)
            losses.append(float(loss))
    final = _leaves(jax.tree.map(np.asarray, params))
    names = moe.LAYOUT.names(_tree())
    for r in range(CP):
        got = _got(r)
        np.testing.assert_allclose(got["train_losses"], losses, rtol=1e-5)
        for j, (name, w) in enumerate(zip(names, final)):
            assert_close(got[f"train_p{j}"], w, msg=f"rank {r} {name}", atol=1e-5, rtol=1e-5,
                         norm_rtol=1e-5)
    assert losses[-1] < losses[0]


def test_model_at_cp4_without_ep_matches_jax():
    """No EP at cp 4: each rank gathers every rank's rows and routes them
    all, as JAX's layer routes the global dispatched array."""
    _, _, loss, grads = _jax_model(MOE_CFS[1], None)
    for r in range(CP):
        got = _got(r)
        np.testing.assert_allclose(float(got["noep_loss"]), loss, rtol=1e-5)
        _check_grads("noep_", got, grads, r)


def test_shard_moe_params_divisibility_message_is_jax():
    with pytest.raises(ValueError) as err:
        jax_moe._check_experts_divisible(6, CP, "cp")
    for r in range(CP):
        assert str(_got(r)["divisibility_error"]) == str(err.value)
