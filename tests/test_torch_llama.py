"""The port's Llama trainer on the CPU against the JAX package's.

A small config (dim 128, 2 layers, 4/2 heads, head_dim 32, ffn 256, vocab
512, 256 tokens, float32) with the weights of JAX ``init_params`` carried
over by ``params_from_numpy``, under the same two-document causal mask.
The JAX side runs ``loss_fn``/``train_step`` on a one-device mesh key
(``magi_attn_flex_key(..., mesh=Mesh(jax.devices("cpu")[:1]))``), whose
dispatch is the identity, with the split FFA backward (Pallas in interpret
mode). The port's attention callable is ``flex_flash_attn_func`` bound to
the slices (``ffa``: on CPU tensors ``sdpa_attn``, autograd), or
``_FFACore`` directly (``ffa_core``: the backward kernels' plain
versions).

Tolerances: loss rel 1e-5; every gradient atol 1e-5, rtol 1e-4, rel-norm
1e-4 (float32 through two layers of products summed in different orders);
three SGD steps at lr 1e-2: losses rel 1e-5, parameters atol 1e-5.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu.api import magi_attn_flex_key
from magiattention_tpu.models import llama as jax_llama
from magiattention_tpu_torch.kernels.ffa import _FFACore, plan_params
from magiattention_tpu_torch.models import llama
from magiattention_tpu_torch.testing import assert_close

CFG = dict(
    vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=32, ffn_hidden=256, dtype="float32",
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


def _attn(path):
    if path == "ffa":
        return llama.flex_attn(RANGES, RANGES, [1, 1])
    plan, params = plan_params(RANGES, RANGES, [1, 1], None, None, S, S, CFG["head_dim"], None, 0.0)

    def attn(q, k, v):
        return _FFACore.apply(q, k, v, plan, params)

    return attn


def _port_inputs():
    cfg = llama.LlamaConfig(**CFG)
    params = llama.params_from_numpy(_jax_run()["tree"], device="cpu")
    tokens, labels = (torch.from_numpy(a) for a in _data())
    return cfg, params, tokens, labels


@pytest.mark.parametrize("path", ["ffa", "ffa_core"])
def test_loss_and_grads_match_jax(path):
    cfg, params, tokens, labels = _port_inputs()
    loss, grads = llama.value_and_grad(params, cfg, tokens, labels, _attn(path))
    ref = _jax_run()
    assert abs(loss.item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    names = llama.param_names(params)
    assert len(grads) == len(ref["grads"]) == len(names)
    for name, g, want in zip(names, grads, ref["grads"]):
        assert g.dtype == torch.float32 and g.shape == want.shape
        assert_close(g, want, msg=f"{path} grad {name}", **GRAD_TOL)


@pytest.mark.parametrize("path", ["ffa", "ffa_core"])
def test_three_train_steps_match_jax(path):
    cfg, params, tokens, labels = _port_inputs()
    attn = _attn(path)
    losses = []
    for _ in range(STEPS):
        params, loss = llama.train_step(params, cfg, tokens, labels, attn, lr=LR)
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
