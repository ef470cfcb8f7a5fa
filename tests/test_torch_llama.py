"""The port's Llama trainer on the CPU against the JAX package's.

A small config (dim 128, 2 layers, 4/2 heads, head_dim 64, ffn 256, vocab
512, 256 tokens, float32) with the weights of JAX ``init_params`` carried
over by ``params_from_numpy``, under the same two-document causal mask.
Both sides take attention through a cp = 1 runtime key of that mask: JAX's
``magi_attn_flex_key(..., mesh=Mesh(jax.devices("cpu")[:1]))`` with the
split FFA backward (Pallas in interpret mode), the port's
``magi_attn_flex_key(..., device="cpu")`` (the kernels' plain versions)
under a split or a fused backward pin.

Tolerances: loss rel 1e-5; every gradient atol 1e-5, rtol 1e-4, rel-norm
1e-4 (float32 through two layers of products summed in different orders);
three SGD steps at lr 1e-2: losses rel 1e-5, parameters atol 1e-5.

Also: ``remat=True`` within 1e-6 of no remat (the FFA plain versions run
twice per layer); the dense twin ``loss_fn_dense`` against JAX's (the
gradient gates above); three AdamW steps of ``make_optim_train_step``
(``torch.optim.AdamW``) against JAX ``make_optax_train_step`` with
``optax.adamw`` at the same hyperparameters, JAX's key on its ``sdpa``
backend: losses rel 1e-5, parameters rel-norm 1e-4 and atol 1e-5 on all
but 1e-3 of the elements (Adam divides each gradient by its own scale,
so an element whose gradient is within float32 rounding of 0 can step
the other way, by up to 2 lr a step); the dense twin's step within the
same of the CP step.
"""

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu.api import magi_attn_flex_key
from magiattention_tpu.models import llama as jax_llama
from magiattention_tpu_torch import api as port_api
import optax

from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts
from magiattention_tpu_torch.models import llama
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

CFG = dict(
    vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=64, ffn_hidden=256, dtype="float32",
)
S, LR, STEPS = 256, 1e-2, 3
RANGES = [[0, S // 2], [S // 2, S]]
GRAD_TOL = dict(atol=1e-5, rtol=1e-4, norm_rtol=1e-4)


def _data():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, CFG["vocab_size"], S).astype(np.int32)
    labels = np.roll(tokens, -1)
    labels[S // 2 - 1 :: S // 2] = -100  # each document's end
    return tokens, labels


def _jax_tree_leaves(tree) -> list[np.ndarray]:
    """The JAX pytree's arrays in the port's param_list order."""
    out = [tree["embed"], tree["final_norm"], tree["lm_head"]]
    for lyr in tree["layers"]:
        out += [lyr[k] for k in llama._LAYER_KEYS]
    return [np.asarray(a) for a in out]


@lru_cache(maxsize=None)
def _jax_run():
    """JAX init params, value_and_grad of loss_fn, and STEPS train_steps."""
    cfg = jax_llama.LlamaConfig(**CFG)
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), axis_names=("cp",))
    key = magi_attn_flex_key(RANGES, RANGES, [1, 1], S, S, mesh=mesh)
    params = jax_llama.init_params(cfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tokens, labels = (jnp.asarray(a) for a in _data())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
        vg = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(1, 4))
        loss, grads = vg(params, cfg, tokens, labels, key)
        losses = []
        for _ in range(STEPS):
            params, step_loss = jax_llama.train_step(params, cfg, tokens, labels, key, lr=LR)
            losses.append(float(step_loss))
    return dict(
        tree=tree, loss=float(loss), grads=_jax_tree_leaves(grads),
        losses=losses, final=_jax_tree_leaves(params),
    )


def _key(pin, monkeypatch):
    """The port's cp = 1 key of the mask, under a backward pin."""
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", pin)
    return port_api.magi_attn_flex_key(RANGES, RANGES, [1, 1], S, S, device="cpu")


def _check_mode(pin):
    """The plain version of the pinned backward ran, the other did not."""
    counts = launch_counts()
    other = "split" if pin == "fused" else "fused"
    name = {"fused": "ffa_bwd_fused_plain", "split": "ffa_bwd_dq_plain"}
    assert counts[name[pin]] > 0 and counts[name[other]] == 0, counts


def _port_inputs():
    cfg = llama.LlamaConfig(**CFG)
    params = llama.params_from_numpy(_jax_run()["tree"], device="cpu")
    tokens, labels = (torch.from_numpy(a) for a in _data())
    return cfg, params, tokens, labels


@pytest.mark.parametrize("path", ["split", "fused"])
def test_loss_and_grads_match_jax(path, monkeypatch):
    cfg, params, tokens, labels = _port_inputs()
    key = _key(path, monkeypatch)
    reset_launch_counts()
    loss, grads = llama.value_and_grad(params, cfg, tokens, labels, key)
    _check_mode(path)
    ref = _jax_run()
    assert abs(loss.item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    names = llama.param_names(params)
    assert len(grads) == len(ref["grads"]) == len(names)
    for name, g, want in zip(names, grads, ref["grads"]):
        assert g.dtype == torch.float32 and g.shape == want.shape
        assert_close(g, want, msg=f"{path} grad {name}", **GRAD_TOL)


@pytest.mark.parametrize("path", ["split", "fused"])
def test_three_train_steps_match_jax(path, monkeypatch):
    cfg, params, tokens, labels = _port_inputs()
    key = _key(path, monkeypatch)
    losses = []
    for _ in range(STEPS):
        params, loss = llama.train_step(params, cfg, tokens, labels, key, lr=LR)
        losses.append(loss.item())
    ref = _jax_run()
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    for name, p, want in zip(llama.param_names(params), llama.param_list(params), ref["final"]):
        assert_close(p, want, msg=f"{path} param {name}", atol=1e-5, rtol=1e-5, norm_rtol=1e-5)


def test_init_params_matches_jax_layout_and_is_seeded():
    cfg = llama.LlamaConfig(**CFG)
    a = llama.init_params(cfg, seed=3, device="cpu")
    b = llama.init_params(cfg, seed=3, device="cpu")
    c = llama.init_params(cfg, seed=4, device="cpu")
    ref = _jax_tree_leaves(_jax_run()["tree"])
    for x, y, z, want in zip(llama.param_list(a), llama.param_list(b), llama.param_list(c), ref):
        assert x.dtype == torch.float32 and tuple(x.shape) == want.shape
        assert torch.equal(x, y)
        if x.dim() == 2:
            assert not torch.equal(x, z)
            # dense(shape) = N(0, 1) / sqrt(fan_in), as in JAX
            assert abs(x.std().item() * x.shape[0] ** 0.5 - 1.0) < 0.1
        else:
            assert torch.equal(x, torch.ones_like(x))


def test_masked_ce_ignores_negative_labels():
    logits = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, -100, 3, 0, -1, 4])
    valid = labels >= 0
    want = torch.nn.functional.cross_entropy(logits[valid], labels[valid])
    torch.testing.assert_close(llama.masked_ce(logits, labels), want)
    assert llama.masked_ce(logits, torch.full((6,), -100)).item() == 0.0


@pytest.mark.parametrize("entry", ["loss_fn", "value_and_grad", "train_step"])
def test_training_at_cp_above_one_raises(entry, monkeypatch):
    """At cp > 1 each rank's gradients are partial and the trainer sums
    them over the key's cp group (tests/test_torch_llama_cp.py): a key
    that claims cp > 1 without its group is refused, instead of letting
    the ranks' weights drift apart."""
    cfg, params, tokens, labels = _port_inputs()
    key = dataclasses.replace(_key("split", monkeypatch), cp_size=2)
    with pytest.raises(ValueError, match="without its cp group"):
        getattr(llama, entry)(params, cfg, tokens, labels, key)


def _causal_docs_mask() -> np.ndarray:
    mask = np.zeros((S, S), dtype=bool)
    for a, b in RANGES:
        mask[a:b, a:b] = np.tril(np.ones((b - a, b - a), dtype=bool))
    return mask


@pytest.mark.parametrize("path", ["split", "fused"])
def test_remat_equals_no_remat(path, monkeypatch):
    cfg, params, tokens, labels = _port_inputs()
    key = _key(path, monkeypatch)
    loss, grads = llama.value_and_grad(params, cfg, tokens, labels, key)
    reset_launch_counts()
    loss_r, grads_r = llama.value_and_grad(params, dataclasses.replace(cfg, remat=True), tokens,
                                           labels, key)
    assert launch_counts()["sdpa_attn"] == 2 * cfg.n_layers  # the recompute's forward too
    np.testing.assert_allclose(loss_r.item(), loss.item(), rtol=1e-6)
    for g, g_r in zip(grads, grads_r):
        np.testing.assert_allclose(g_r.numpy(), g.numpy(), rtol=1e-6, atol=1e-6)
    assert abs(loss_r.item() - _jax_run()["loss"]) <= 1e-5 * abs(_jax_run()["loss"])


def test_dense_twin_matches_jax():
    cfg, params, tokens, labels = _port_inputs()
    mask = _causal_docs_mask()
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_llama.loss_fn_dense), static_argnums=(1,))(
        jax.tree.map(jnp.asarray, _jax_run()["tree"]), jax_llama.LlamaConfig(**CFG),
        *(jnp.asarray(a) for a in _data()), jnp.asarray(mask))
    loss, grads = llama.tree_value_and_grad(
        lambda live: llama.loss_fn_dense(live, cfg, tokens, labels, torch.from_numpy(mask)),
        params, llama.LAYOUT)
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for name, g, want in zip(llama.param_names(params), grads, _jax_tree_leaves(grads_j)):
        assert_close(g, want, msg=f"dense grad {name}", **GRAD_TOL)
    # the CP loss on the same mask is the dense twin's
    assert abs(loss.item() - _jax_run()["loss"]) <= 1e-5 * abs(_jax_run()["loss"])


ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)


def test_adamw_steps_match_optax(monkeypatch):
    opt = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                      weight_decay=ADAMW["weight_decay"])
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), axis_names=("cp",))
    jkey = magi_attn_flex_key(RANGES, RANGES, [1, 1], S, S, mesh=mesh)
    tokens, labels = (jnp.asarray(a) for a in _data())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa")
        step = jax_llama.make_optax_train_step(jax_llama.LlamaConfig(**CFG), jkey, opt)
        params = jax.tree.map(jnp.asarray, _jax_run()["tree"])
        state = opt.init(params)
        losses = []
        for _ in range(STEPS):
            params, state, loss = step(params, state, tokens, labels)
            losses.append(float(loss))
    final = _jax_tree_leaves(params)

    def run(make, arg):
        cfg, p, tok, lab = _port_inputs()
        optim = torch.optim.AdamW(llama.param_list(p), lr=ADAMW["lr"],
                                  betas=(ADAMW["b1"], ADAMW["b2"]), eps=ADAMW["eps"],
                                  weight_decay=ADAMW["weight_decay"])
        step_p = make(cfg, arg, optim)
        out = []
        for _ in range(STEPS):
            p, loss = step_p(p, tok, lab)
            out.append(loss.item())
        return out, llama.param_list(p)

    got, p_cp = run(llama.make_optim_train_step, _key("split", monkeypatch))
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert got[-1] < got[0]
    tol = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-4, mismatch_thres=1e-3)
    for name, p, want in zip(llama.param_names(_port_inputs()[1]), p_cp, final):
        assert_close(p, want, msg=f"adamw {name}", **tol)
    got_d, p_d = run(llama.make_optim_train_step_dense, torch.from_numpy(_causal_docs_mask()))
    np.testing.assert_allclose(got_d, got, rtol=1e-5)
    for p, q in zip(p_d, p_cp):
        assert_close(p, q, msg="dense step", **tol)


def test_shard_params_names_its_roadmap_item():
    """``shard_params`` (ZeRO-3 / Megatron TP, the video DiT's re-export
    of it, as in JAX) no longer raises: on a one-rank mesh every block is
    the whole leaf, the tree keeps its layout, gathers back bitwise, and
    its step is the unsharded step bitwise (one gloo world of 4 holds the
    sharded steps against JAX's: tests/test_torch_shard.py)."""
    from magiattention_tpu_torch.models import video_dit
    from magiattention_tpu_torch.parallel import ProcessMesh

    assert video_dit.shard_params is llama.shard_params
    cfg, params, tokens, labels = _port_inputs()
    mesh = ProcessMesh(np.arange(1), ("cp",))
    sharded = llama.shard_params(params, mesh)
    assert [k for k in sharded if k != "sharding"] == list(params)
    assert llama.param_names(sharded) == llama.param_names(params)
    back = llama.gather_params(sharded)
    assert all(torch.equal(a, b) for a, b in zip(llama.param_list(back), llama.param_list(params)))
    key = port_api.magi_attn_flex_key(RANGES, RANGES, [1, 1], S, S, device="cpu", chunk_size=64)
    loss, grads = llama.value_and_grad(params, cfg, tokens, labels, key)
    loss_s, grads_s = llama.value_and_grad(sharded, cfg, tokens, labels, key)
    assert torch.equal(loss_s, loss) and all(torch.equal(a, b) for a, b in zip(grads_s, grads))
