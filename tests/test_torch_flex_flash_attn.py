"""The port's ``flex_flash_attn_func`` on the CPU against the JAX package's.

Each backend (``ffa``, ``sdpa``, ``sdpa_online``), without a sink and with
an ``sh`` or ``ssh`` sink, runs the same numpy inputs through both packages'
``flex_flash_attn_func`` with the same backend. Compared: out, lse and the
gradients of sum(out * dO) in q, k, v and the sink. The JAX ``ffa`` backend
runs its Pallas kernels in interpret mode (tests/conftest.py) under the
split backward; the port's runs ``ffa_attn`` (on CPU tensors:
``sdpa_attn``, autograd) or, with a sink, ``_FFASinkCore`` over the
kernels' plain versions. Tolerance float32 atol/rtol/rel-norm 1e-5. The
max-logits output of each backend, with and without a sink and a softcap,
against the JAX package's on the same inputs.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.common.enum import AttnMaskType as JaxAttnMaskType
from magiattention_tpu.functional.flex_flash_attn import (
    flex_flash_attn_func as jax_flex_flash_attn_func,
)
from magiattention_tpu_torch import AttnForwardMeta, AttnMaskType, flex_flash_attn_func
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import qkv

SQ, HQ, HK, D, S_SINK = 160, 4, 2, 32, 3
Q_RANGES = np.array([[0, 40], [40, 100], [100, 150]], np.int32)
K_RANGES = np.array([[0, 40], [40, 100], [80, 160]], np.int32)
TYPES = np.array([1, 0, 3], np.int32)  # rows [150, 160) uncovered
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
BACKENDS = ("ffa", "sdpa", "sdpa_online")
SINKS = (None, "sh", "ssh")
NAMES = ("out", "lse", "dq", "dk", "dv", "dsink")


def _arrays(sink_layout, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = qkv(rng, SQ, SQ, HQ, HK, D)
    do = rng.standard_normal(q.shape).astype(np.float32)
    sink = None
    if sink_layout == "sh":
        sink = rng.standard_normal((S_SINK, HQ)).astype(np.float32)
    elif sink_layout == "ssh":
        sink = rng.standard_normal((SQ, S_SINK, HQ)).astype(np.float32)
    return q, k, v, do, sink


def _port(backend, sink_layout, softcap=0.0):
    q, k, v, do, sink = _arrays(sink_layout)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    sink_t = None if sink is None else torch.from_numpy(sink).requires_grad_(True)
    out, meta = flex_flash_attn_func(
        *leaves, Q_RANGES, K_RANGES, TYPES, softcap=softcap, sink=sink_t,
        sink_layout=sink_layout or "sh", backend=backend,
    )
    assert isinstance(meta, AttnForwardMeta) and meta.max_logits is None
    (out * torch.from_numpy(do)).sum().backward()
    grads = [t.grad for t in leaves] + ([] if sink_t is None else [sink_t.grad])
    return [t.detach().numpy() for t in (out, meta.lse, *grads)]


@lru_cache(maxsize=None)
def _jax(backend, sink_layout, softcap=0.0):
    q, k, v, do, sink = _arrays(sink_layout)

    def loss(q, k, v, sink):
        out, meta = jax_flex_flash_attn_func(
            q, k, v, Q_RANGES, K_RANGES, TYPES, softcap=softcap, sink=sink,
            sink_layout=sink_layout or "sh", backend=backend,
        )
        return jnp.sum(out * do), (out, meta.lse)

    argnums = (0, 1, 2) if sink is None else (0, 1, 2, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
        (_, (out, lse)), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if sink is None else jnp.asarray(sink),
        )
    return [np.asarray(t) for t in (out, lse, *grads)]


@pytest.mark.parametrize("sink_layout", SINKS, ids=str)
@pytest.mark.parametrize("backend", BACKENDS)
def test_flex_flash_attn_matches_jax(backend, sink_layout):
    got, want = _port(backend, sink_layout), _jax(backend, sink_layout)
    assert len(got) == len(want) == (5 if sink_layout is None else 6)
    np.testing.assert_array_equal(np.isneginf(got[1]), np.isneginf(want[1]))
    for name, a, b in zip(NAMES, got, want):
        assert np.isfinite(a[np.isfinite(b)]).all(), f"{name} not finite"
        assert_close(a, b, msg=f"{backend} sink={sink_layout} {name}", **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_flex_flash_attn_softcap_matches_jax(backend):
    got, want = _port(backend, "sh", softcap=30.0), _jax(backend, "sh", softcap=30.0)
    for name, a, b in zip(NAMES, got, want):
        assert_close(a, b, msg=f"{backend} softcap {name}", **TOL)


def test_backend_from_env(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa_online")
    q, k, v, _, _ = _arrays(None)
    out, meta = flex_flash_attn_func(
        *(torch.from_numpy(a) for a in (q, k, v)), Q_RANGES, K_RANGES, TYPES
    )
    want = _jax("sdpa_online", None)
    assert_close(out, want[0], **TOL)
    assert_close(meta.lse, want[1], **TOL)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sink_layout", SINKS, ids=str)
@pytest.mark.parametrize("backend", BACKENDS)
def test_max_logits_matches_jax(backend, sink_layout, softcap):
    """Per-head max of the scaled (softcapped) logits over the attended
    entries, the sink's excluded: the forward kernel's own output on
    ``ffa`` (on the CPU its plain version), the dense oracle on the plain
    backends, in both packages."""
    q, k, v, _, sink = _arrays(sink_layout)
    kw = dict(
        softcap=softcap, sink_layout=sink_layout or "sh", backend=backend,
        return_max_logits=True,
    )
    _, meta = flex_flash_attn_func(
        *(torch.from_numpy(a) for a in (q, k, v)), Q_RANGES, K_RANGES, TYPES,
        sink=None if sink is None else torch.from_numpy(sink), **kw,
    )
    _, jmeta = jax_flex_flash_attn_func(
        *(jnp.asarray(a) for a in (q, k, v)), Q_RANGES, K_RANGES, TYPES,
        sink=None if sink is None else jnp.asarray(sink), **kw,
    )
    got = meta.max_logits
    assert got.shape == (HQ,) and got.dtype == torch.float32 and not got.requires_grad
    assert_close(got, np.asarray(jmeta.max_logits), **TOL)


def test_unsupported_options_raise():
    q, k, v, _, _ = _arrays(None)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="backend"):
        flex_flash_attn_func(*t, Q_RANGES, K_RANGES, TYPES, backend="flash")
    with pytest.raises(NotImplementedError, match="shd"):
        flex_flash_attn_func(
            *t, Q_RANGES, K_RANGES, TYPES, sink=torch.zeros(2, HQ, D), sink_layout="shd"
        )
    with pytest.raises(ValueError, match="q_ranges"):
        flex_flash_attn_func(*t, Q_RANGES.reshape(-1), K_RANGES, TYPES)


def test_mask_type_codes_match_jax():
    for code in range(4):
        port, ref = AttnMaskType.from_int_type(code), JaxAttnMaskType.from_int_type(code)
        assert port.value == ref.value and port.to_int_type() == code
        assert AttnMaskType.normalize(ref.value) is port
        assert AttnMaskType.normalize(np.int32(code)) is port
