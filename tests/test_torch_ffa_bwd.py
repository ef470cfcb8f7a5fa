"""The port's FFA backward on the CPU against the JAX package's.

The same numpy inputs (q, k, v and the output cotangent dO) go through:

- the port's ``ffa_attn`` (on a CPU tensor: ``sdpa_attn``, differentiated
  by autograd) and the port's ``_FFACore`` (the autograd.Function the card
  runs; on CPU tensors its forward is ``sdpa_attn`` over the plan's slices
  and its backward the kernels' plain versions ``ffa_delta_plain``,
  ``ffa_bwd_dq_plain``, ``ffa_bwd_dkv_plain``);
- the JAX package's ``ffa_attn`` under ``MAGI_ATTENTION_BACKEND_FFA_BWD=
  split`` (Pallas in interpret mode, tests/conftest.py) and its
  ``sdpa_attn`` under ``jax.grad``.

Tolerance float32 atol/rtol/rel-norm 1e-5 (all sides accumulate in float32,
in different orders). Masks: causal, varlen block-causal, INVCAUSAL,
BICAUSAL, a sliding-window band and a mask with uncovered rows and
unreached k tiles; g in {1, 2, 4}; softcap 0 and 30 (interpret-mode Pallas
is slow, so g and softcap vary on the varlen mask only).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels.ffa import ffa_attn as jax_ffa_attn
from magiattention_tpu.kernels.sdpa import sdpa_attn as jax_sdpa_attn
from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.kernels.ffa import (
    _FFACore,
    ffa_attn,
    ffa_bwd_dkv_kernel,
    ffa_bwd_dkv_plain,
    ffa_bwd_dq_gqa_kernel,
    ffa_bwd_dq_kernel,
    ffa_bwd_dq_plain,
    ffa_bwd_fused_convert,
    ffa_bwd_fused_kernel,
    ffa_bwd_fused_plain,
    ffa_bwd_mode,
    ffa_delta_kernel,
    ffa_delta_plain,
    ffa_fwd_gqa_kernel,
    ffa_fwd_kernel,
    plan_params,
)
from magiattention_tpu_torch.kernels.sdpa import sdpa_attn
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import MASKS, _typed, qkv

HK, D = 2, 32
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
# q rows [0, 8) and [48, 80) uncovered; k rows [40, 100) and the k tile
# [128, 192) no slice reaches
UNREACHED = _typed([[0, 48], [80, 128]], [[0, 40], [100, 128]], [1, 0], 128, 192)
BWD_MASKS = {
    **{m: MASKS[m] for m in ("causal", "varlen", "invcausal", "bicausal", "sliding_band")},
    "unreached": UNREACHED,
}
CASES = [(m, 2, 0.0) for m in sorted(BWD_MASKS)] + [
    ("varlen", 1, 0.0),
    ("varlen", 4, 0.0),
    ("varlen", 2, 30.0),
]
GRAD_NAMES = ("out", "lse", "dq", "dk", "dv")


def _arrays(mask, g, seed=0):
    qr, kr, lo, hi, sq, sk = BWD_MASKS[mask]
    q, k, v = qkv(np.random.default_rng(seed), sq, sk, g * HK, HK, D)
    do = np.random.default_rng(seed + 100).standard_normal(q.shape).astype(np.float32)
    return (q, k, v, do), (qr, kr, lo, hi)


def _torch_grads(fn, q, k, v, do):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = fn(*leaves)
    (out * torch.from_numpy(do)).sum().backward()
    return [t.detach().numpy() for t in (out, lse, *(x.grad for x in leaves))]


def _jax_grads(fn, q, k, v, do):
    def loss(q, k, v):
        out, lse = fn(q, k, v)
        return jnp.sum(out * do), (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    return [np.asarray(t) for t in (out, lse, *grads)]


@lru_cache(maxsize=None)
def _jax_ffa(mask, g, softcap):
    """JAX ffa_attn's (out, lse, dq, dk, dv) under the split backward (the
    env pin is set only while it runs)."""
    (q, k, v, do), (qr, kr, lo, hi) = _arrays(mask, g)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
        return _jax_grads(
            lambda q, k, v: jax_ffa_attn(q, k, v, qr, kr, softcap=softcap, d_lo=lo, d_hi=hi),
            q, k, v, do,
        )


def _assert_all_close(got, want, msg):
    np.testing.assert_array_equal(np.isneginf(got[1]), np.isneginf(want[1]), msg)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert np.isfinite(a[np.isfinite(b)]).all(), f"{msg} {name} not finite"
        assert_close(a, b, msg=f"{msg} {name}", **TOL)


def _port_path(path, mask, softcap):
    """The port's attention under test, as a function of (q, k, v)."""
    qr, kr, lo, hi, sq, sk = BWD_MASKS[mask]
    if path == "ffa_attn":
        return lambda q, k, v: ffa_attn(q, k, v, qr, kr, softcap=softcap, d_lo=lo, d_hi=hi)
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, D, None, softcap)
    return lambda q, k, v: _FFACore.apply(q, k, v, plan, params)


@pytest.mark.parametrize("path", ["ffa_attn", "ffa_core"])
@pytest.mark.parametrize("mask,g,softcap", CASES, ids=str)
def test_ffa_grads_match_jax_split(path, mask, g, softcap):
    (q, k, v, do), _ = _arrays(mask, g)
    got = _torch_grads(_port_path(path, mask, softcap), q, k, v, do)
    _assert_all_close(got, _jax_ffa(mask, g, softcap), f"{path} {mask} g={g} cap={softcap}")


@pytest.mark.parametrize("mask,g,softcap", CASES, ids=str)
def test_sdpa_grads_match_jax_sdpa(mask, g, softcap):
    (q, k, v, do), (qr, kr, lo, hi) = _arrays(mask, g)
    got = _torch_grads(
        lambda q, k, v: sdpa_attn(q, k, v, qr, kr, softcap=softcap, d_lo=lo, d_hi=hi),
        q, k, v, do,
    )
    want = _jax_grads(
        lambda q, k, v: jax_sdpa_attn(
            q, k, v, jnp.asarray(qr), jnp.asarray(kr), softcap=softcap,
            d_lo=jnp.asarray(lo), d_hi=jnp.asarray(hi),
        ),
        q, k, v, do,
    )
    _assert_all_close(got, want, f"sdpa {mask} g={g} cap={softcap}")


@pytest.mark.parametrize("mask,g,softcap", CASES, ids=str)
def test_plain_backward_matches_autograd(mask, g, softcap):
    """ffa_*_plain (what chip_smoke.py holds the kernels against) equal
    torch autograd of sdpa_attn on the same inputs."""
    (q, k, v, do), (qr, kr, lo, hi) = _arrays(mask, g, seed=1)
    want = _torch_grads(
        lambda q, k, v: sdpa_attn(q, k, v, qr, kr, softcap=softcap, d_lo=lo, d_hi=hi),
        q, k, v, do,
    )
    sq, sk = q.shape[0], k.shape[0]
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, D, None, softcap)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = torch.from_numpy(want[0]), torch.from_numpy(want[1])
    delta = ffa_delta_plain(out, tdo)
    assert_close(delta, (want[0] * do).sum(-1), msg="delta", **TOL)
    args = (tq, tk, tv, tdo, lse, delta, plan, params)
    dq = ffa_bwd_dq_plain(*args)
    dk, dv = ffa_bwd_dkv_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want[2:]):
        assert a.dtype == torch.float32
        assert_close(a, b, msg=f"plain {name} {mask} g={g} cap={softcap}", **TOL)


@pytest.mark.parametrize("path", ["sdpa_attn", "ffa_core"])
def test_untouched_rows_have_zero_finite_grads(path):
    """Rows no slice covers give dq exactly 0, k rows no live pair touches
    give dk = dv = 0 exactly, and nothing is NaN (the backward leans on
    this: logsumexp of an all -inf row must not poison autograd)."""
    (q, k, v, do), (qr, kr, lo, hi) = _arrays("unreached", 2)
    fn = (
        _port_path("ffa_core", "unreached", 0.0) if path == "ffa_core"
        else lambda q, k, v: sdpa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
    )
    out, lse, dq, dk, dv = _torch_grads(fn, q, k, v, do)
    for t in (out, dq, dk, dv):
        assert np.isfinite(t).all()
    assert np.isneginf(lse[:8]).all() and np.isneginf(lse[48:80]).all()
    assert not dq[:8].any() and not dq[48:80].any() and not out[48:80].any()
    assert not dk[40:100].any() and not dv[40:100].any()
    assert not dk[128:].any() and not dv[128:].any()
    assert dk[:40].any() and dv[100:128].any()


@pytest.mark.parametrize("path", ["ffa_attn", "ffa_core"])
def test_lse_carries_no_gradient_as_in_jax(path):
    """JAX's _ffa_core ignores lse's cotangent, so a loss through lse alone
    has zero gradient there; the port's lse carries none on either route
    (before the CPU route detached it, sdpa_attn's autograd gave one)."""
    (q, k, v, w), (qr, kr, lo, hi) = _arrays("varlen", 2)
    w = w[..., 0]  # [sq, hq] weights on lse

    def jax_loss(q, k, v):
        _, lse = jax_ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
        return jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * w)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
        jax_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        )
    assert not any(np.asarray(g).any() for g in jax_grads)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = _port_path(path, "varlen", 0.0)(*leaves)
    assert out.requires_grad and not lse.requires_grad


def test_ffa_bwd_mode_is_split_and_refuses_fused(monkeypatch):
    """The mode follows the JAX package's precedence: a split pin (or the
    legacy flag at 0) wins, a fused pin (or the legacy flag at 1) wins where
    the fused kernel can run, and a head geometry it cannot hold (head_dim
    32: its threads own 64-column groups) runs split under any pin."""
    qr, kr, lo, hi, sq, sk = BWD_MASKS["causal"]
    plans = {d: plan_params(qr, kr, None, lo, hi, sq, sk, d, None, 0.0) for d in (32, 64)}
    for key, val, want in (
        ("MAGI_ATTENTION_BACKEND_FFA_BWD", "split", "split"),
        ("MAGI_ATTENTION_FFA_FUSED_BWD", "0", "split"),
        ("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused", "fused"),
        ("MAGI_ATTENTION_FFA_FUSED_BWD", "1", "fused"),
    ):
        monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
        monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
        monkeypatch.setenv(key, val)
        assert ffa_bwd_mode(*plans[64], 64, 64, 4, 4, 2) == want, (key, val)
        assert ffa_bwd_mode(*plans[32], 32, 32, 4, 4, 2) == "split", (key, val)


def test_fused_pin_raises_in_backward_not_forward(monkeypatch):
    """No silent downgrade: under a fused pin the backward runs the fused
    kernel's plain version and no split one, with the split path's
    gradients."""
    qr, kr, lo, hi, sq, sk = BWD_MASKS["varlen"]
    q, k, v = qkv(np.random.default_rng(7), sq, sk, 2 * HK, HK, 64)
    do = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, 64, None, 0.0)

    def run(pin):
        monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", pin)
        ffa_bwd_fused_plain.calls = ffa_bwd_dq_plain.calls = 0
        got = _torch_grads(lambda q, k, v: _FFACore.apply(q, k, v, plan, params), q, k, v, do)
        return got, ffa_bwd_fused_plain.calls, ffa_bwd_dq_plain.calls

    fused, n_fused, n_dq = run("fused")
    assert (n_fused, n_dq) == (1, 0)
    split, n_fused, n_dq = run("split")
    assert (n_fused, n_dq) == (0, 1)
    _assert_all_close(fused, split, "fused vs split")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises; only the routing in front of
    it sends CPU tensors to the plain versions."""
    (q, k, v, do), (qr, kr, lo, hi) = _arrays("causal", 2)
    plan, params = plan_params(qr, kr, None, lo, hi, 128, 128, D, None, 0.0)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = torch.zeros(q.shape[:2])
    with pytest.raises(ValueError, match="CUDA"):
        ffa_delta_kernel(tq, tdo)
    for kernel in (
        ffa_bwd_dq_kernel, ffa_bwd_dq_gqa_kernel, ffa_bwd_dkv_kernel, ffa_bwd_fused_kernel,
    ):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(tq, tk, tv, tdo, lse, lse, plan, params)
    with pytest.raises(ValueError, match="CUDA"):
        ffa_fwd_gqa_kernel(tq, tk, tv, plan, params)
    with pytest.raises(ValueError, match="CUDA"):
        ffa_fwd_kernel(tq, tk, tv, plan, params, return_max_logits=True)
    with pytest.raises(ValueError, match="CUDA"):
        ffa_bwd_fused_convert(torch.zeros(tq.shape), params.softmax_scale)


def test_backward_sources_are_built_at_first_use():
    for name in (
        "ffa_bwd_delta", "ffa_bwd_dq", "ffa_bwd_dkv", "ffa_bwd_fused", "ffa_fwd_gqa",
        "ffa_bwd_dq_gqa",
    ):
        assert name in _build.SOURCES
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces: magiattention_tpu/kernels/ffa.py" in src
        assert any(
            f'#include "{h}"' in src
            for h in ("common.cuh", "bwd_kv.cuh", "ffa_fwd.cuh", "ffa_bwd_dq.cuh")
        )
