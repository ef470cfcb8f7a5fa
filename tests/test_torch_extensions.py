"""The port's ``extensions/`` against the JAX package's on the same numpy
inputs.

- ``fa3_func_with_sink`` (batch), ``fa3_varlen_func_with_sink`` and
  ``fa3_qkvpacked_func_with_sink``: causal, FA windows, a rectangular
  sk != sq, softcap, GQA (4 q heads over 2 kv heads), no sink and the
  ``sh`` / ``ssh`` sink layouts. The port runs its default backend (on
  CPU tensors, the FFA kernels' plain versions; with a sink,
  ``_FFASinkCore``), JAX its ``sdpa`` backend. Held: out, lse and the
  gradients of ``sum(out * dO)`` in q, k, v and the sink, float32
  atol/rtol/rel-norm 1e-5.
- ``dsa_attn_func``, backends ``gather`` and ``sdpa``, with duplicate
  indices: out, lse and the gradients against JAX's, float32 1e-5.
- The generation aliases name one function, and the ``shd`` layout
  raises, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu import extensions as jax_ext
from magiattention_tpu_torch import extensions as ext
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import TORCH_THREADS  # noqa: F401  (caps torch's threads)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
B, S, H, HK, D, S_SINK = 2, 128, 4, 2, 32, 3


def _sink(rng, layout, rows):
    if layout is None:
        return None
    shape = (S_SINK, H) if layout == "sh" else (*rows, S_SINK, H)
    return rng.standard_normal(shape).astype(np.float32)


def _compare(port_fn, jax_fn, arrays, msg):
    """out (and lse) of both, and the gradients of sum(out * dO) in every
    array (None entries skipped)."""
    live = [i for i, a in enumerate(arrays) if a is not None]
    rng = np.random.default_rng(99)
    leaves = [torch.from_numpy(a).requires_grad_(True) if a is not None else None for a in arrays]
    out, lse = port_fn(*leaves)
    do = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(do)).sum().backward()

    def loss(*xs):
        full = list(arrays)
        for i, x in zip(live, xs):
            full[i] = x
        o, l = jax_fn(*full)
        return jnp.sum(o * do), (o, l)

    (_, (o_j, l_j)), g_j = jax.value_and_grad(loss, argnums=tuple(range(len(live))), has_aux=True)(
        *(jnp.asarray(arrays[i]) for i in live)
    )
    assert_close(out.detach().numpy(), np.asarray(o_j), msg=f"{msg} out", **TOL)
    assert_close(lse.detach().numpy(), np.asarray(l_j), msg=f"{msg} lse", **TOL)
    for i, g in zip(live, g_j):
        assert_close(leaves[i].grad.numpy(), np.asarray(g), msg=f"{msg} grad {i}", **TOL)


BATCH_CASES = [
    # (causal, window, sk, softcap, sink layout)
    (True, (-1, -1), S, 0.0, None),
    (False, (-1, -1), S, 0.0, None),
    (True, (32, -1), S, 0.0, "sh"),
    (False, (16, 8), S, 0.0, "ssh"),
    (True, (-1, -1), 192, 0.0, None),
    (True, (64, -1), S, 30.0, "sh"),
]


@pytest.mark.parametrize("causal,window,sk,softcap,layout", BATCH_CASES)
def test_fa3_func_with_sink_matches_jax(causal, window, sk, softcap, layout):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, HK, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, HK, D)).astype(np.float32)
    sink = _sink(rng, layout, (B, S))
    kw = dict(sink_layout=layout or "sh", causal=causal, window_size=window, softcap=softcap,
              return_attn_probs=True)
    _compare(
        lambda q, k, v, s: ext.fa3_func_with_sink(q, k, v, s, **kw),
        lambda q, k, v, s: jax_ext.fa3_func_with_sink(q, k, v, s, backend="sdpa", **kw),
        [q, k, v, sink], f"batch causal={causal} window={window} sk={sk} sink={layout}",
    )


@pytest.mark.parametrize("layout", [None, "sh", "ssh"])
def test_fa3_varlen_func_with_sink_matches_jax(layout):
    rng = np.random.default_rng(1)
    cu_q, cu_k = [0, 100, 256], [0, 120, 256]
    q = rng.standard_normal((256, H, D)).astype(np.float32)
    k = rng.standard_normal((256, HK, D)).astype(np.float32)
    v = rng.standard_normal((256, HK, D)).astype(np.float32)
    sink = _sink(rng, layout, (256,))
    kw = dict(sink_layout=layout or "sh", causal=True, window_size=(32, -1), return_attn_probs=True)
    _compare(
        lambda q, k, v, s: ext.fa3_varlen_func_with_sink(q, k, v, cu_q, cu_k, sink=s, **kw),
        lambda q, k, v, s: jax_ext.fa3_varlen_func_with_sink(q, k, v, cu_q, cu_k, sink=s,
                                                             backend="sdpa", **kw),
        [q, k, v, sink], f"varlen sink={layout}",
    )


def test_fa3_qkvpacked_func_with_sink_matches_jax():
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((B, S, 3, H, D)).astype(np.float32)
    sink = _sink(rng, "sh", None)
    kw = dict(causal=True, window_size=(48, -1), return_attn_probs=True)
    _compare(
        lambda x, s: ext.fa3_qkvpacked_func_with_sink(x, s, **kw),
        lambda x, s: jax_ext.fa3_qkvpacked_func_with_sink(x, s, backend="sdpa", **kw),
        [qkv, sink], "qkvpacked",
    )


def test_aliases_and_shd_layout():
    assert ext.fa2_func_with_sink is ext.fa3_func_with_sink is ext.fa4_func_with_sink
    assert ext.fa2_varlen_func_with_sink is ext.fa3_varlen_func_with_sink
    assert ext.fa4_qkvpacked_func_with_sink is ext.fa3_qkvpacked_func_with_sink
    x = torch.zeros((1, 16, 2, 8))
    with pytest.raises(NotImplementedError):
        ext.fa3_func_with_sink(x, x, x, sink=torch.zeros((2, 2, 8)), sink_layout="shd")


def _dsa_inputs(seed, sq, skv, topk, duplicates):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((sq, H, D)).astype(np.float32)
    k = rng.standard_normal((skv, HK, D)).astype(np.float32)
    v = rng.standard_normal((skv, HK, D)).astype(np.float32)
    if duplicates:
        idx = np.zeros((HK, sq, topk), np.int32)
        idx[..., : topk // 2] = rng.integers(0, skv, (HK, sq, topk // 2))
        idx[..., topk // 2:] = idx[..., : topk // 2]
    else:
        idx = np.stack([np.stack([rng.choice(skv, topk, replace=False) for _ in range(sq)])
                        for _ in range(HK)]).astype(np.int32)
    return q, k, v, idx


@pytest.mark.parametrize("backend", ["gather", "sdpa"])
@pytest.mark.parametrize("duplicates", [False, True])
def test_dsa_attn_func_matches_jax(backend, duplicates):
    q, k, v, idx = _dsa_inputs(9 + duplicates, 64, 128, 16, duplicates)
    _compare(
        lambda q, k, v: ext.dsa_attn_func(q, k, v, torch.from_numpy(idx), backend=backend),
        lambda q, k, v: jax_ext.dsa_attn_func(q, k, v, jnp.asarray(idx), backend=backend),
        [q, k, v], f"dsa {backend} duplicates={duplicates}",
    )
