"""The port's FFA forward on the CPU against the JAX package's.

On a CPU tensor the port's ``ffa_attn`` runs its plain version
(``sdpa_attn``); the JAX side runs the Pallas FFA kernel in interpret mode
(tests/conftest.py). The same numpy inputs go through both. Interpret-mode
Pallas is slow, so the cases are every mask at float32 with g = 2, then the
varlen mask with g in {1, 4}, bfloat16 and softcap 30, each varied alone.

Tolerances: float32 atol/rtol/rel-norm 1e-5 (both sides accumulate in
float32, in different orders); bfloat16 atol 2e-2, rel-norm 1e-2 (the JAX
kernel rounds the probabilities to bf16 before P V). Rows no slice covers
must be -inf in both lse outputs, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels.ffa import ffa_attn as jax_ffa_attn
from magiattention_tpu.kernels.sdpa import sdpa_attn as jax_sdpa_attn
from magiattention_tpu_torch.kernels.ffa import ffa_attn, ffa_attn_with_plan
from magiattention_tpu_torch.kernels.ffa import FFAParams
from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan
from magiattention_tpu_torch.kernels.sdpa import sdpa_attn
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import MASKS, qkv

HK, D = 2, 16
TOL = {
    "float32": dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5),
    "bfloat16": dict(atol=2e-2, rtol=2e-2, norm_rtol=1e-2),
}
CASES = [(m, 2, "float32", 0.0) for m in sorted(MASKS)] + [
    ("varlen", 1, "float32", 0.0),
    ("varlen", 4, "float32", 0.0),
    ("varlen", 2, "bfloat16", 0.0),
    ("varlen", 2, "float32", 30.0),
]


def _inputs(mask, g, dtype, seed=0):
    qr, kr, lo, hi, sq, sk = MASKS[mask]
    q, k, v = qkv(np.random.default_rng(seed), sq, sk, g * HK, HK, D)
    if dtype == "bfloat16":  # both sides see the same bf16 values
        q, k, v = (
            torch.from_numpy(a).bfloat16().float().numpy() for a in (q, k, v)
        )
    return (q, k, v), (qr, kr, lo, hi)


def _torch(arrays, dtype):
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(dt) for a in arrays]


def _jax(arrays, dtype):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return [jnp.asarray(a).astype(dt) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _assert_match(got, want, dtype, msg):
    (go, gl), (wo, wl) = [tuple(_np(t) for t in pair) for pair in (got, want)]
    np.testing.assert_array_equal(np.isneginf(gl), np.isneginf(wl), msg)
    assert_close(go, wo, msg=f"{msg} out", **TOL[dtype])
    assert_close(gl, wl, msg=f"{msg} lse", **TOL[dtype])


@pytest.mark.parametrize(
    "mask,g,dtype,softcap", CASES, ids=lambda c: str(c)
)
def test_ffa_attn_matches_jax(mask, g, dtype, softcap):
    arrays, (qr, kr, lo, hi) = _inputs(mask, g, dtype)
    got = ffa_attn(
        *_torch(arrays, dtype), qr, kr, softcap=softcap, d_lo=lo, d_hi=hi
    )
    want = jax_ffa_attn(
        *_jax(arrays, dtype), qr, kr, softcap=softcap, d_lo=lo, d_hi=hi
    )
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == torch.float32
    _assert_match(got, want, dtype, f"ffa {mask} g={g} {dtype} cap={softcap}")


@pytest.mark.parametrize(
    "mask,g,dtype,softcap", CASES, ids=lambda c: str(c)
)
def test_sdpa_attn_matches_jax(mask, g, dtype, softcap):
    arrays, (qr, kr, lo, hi) = _inputs(mask, g, dtype, seed=1)
    got = sdpa_attn(
        *_torch(arrays, dtype), qr, kr, softcap=softcap, d_lo=lo, d_hi=hi
    )
    want = jax_sdpa_attn(
        *_jax(arrays, dtype), jnp.asarray(qr), jnp.asarray(kr),
        softcap=softcap, d_lo=jnp.asarray(lo), d_hi=jnp.asarray(hi),
    )
    _assert_match(got, want, dtype, f"sdpa {mask} g={g} {dtype} cap={softcap}")


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_ffa_attn_with_plan_covers_the_mask(mask):
    """On the CPU, ffa_attn_with_plan reads the slices back from the plan's
    items; that must cover exactly the mask the slices give."""
    arrays, (qr, kr, lo, hi) = _inputs(mask, 2, "float32", seed=2)
    q, k, v = _torch(arrays, "float32")
    sq, sk = q.shape[0], k.shape[0]
    plan = get_ffa_plan(qr, kr, lo, hi, sq, sk, 64, 64)
    params = FFAParams(
        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
        block_q=64, block_k=64, softmax_scale=D ** -0.5, softcap=0.0,
    )
    got = ffa_attn_with_plan(q, k, v, plan, params)
    want = ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
    _assert_match(got, want, "float32", f"with_plan {mask}")


def test_uncovered_rows_are_zero_and_neg_inf():
    arrays, (qr, kr, lo, hi) = _inputs("uncovered", 2, "float32")
    out, lse = ffa_attn(*_torch(arrays, "float32"), qr, kr, d_lo=lo, d_hi=hi)
    assert not out[48:80].any()
    assert torch.isneginf(lse[48:80]).all()
    assert torch.isfinite(lse[:48]).all() and torch.isfinite(lse[80:]).all()


def test_forward_only_raises_on_grad():
    """The forward-only guard is gone: with grad enabled, ffa_attn returns
    differentiable outputs (on a CPU tensor through sdpa_attn's autograd;
    tests/test_torch_ffa_bwd.py holds the gradients against the JAX
    package), equal to its no-grad outputs."""
    arrays, (qr, kr, lo, hi) = _inputs("causal", 2, "float32")
    q, k, v = _torch(arrays, "float32")
    q.requires_grad_(True)
    out, lse = ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
    assert out.requires_grad
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    with torch.no_grad():
        out0, lse0 = ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
    assert torch.equal(out.detach(), out0) and torch.equal(lse.detach(), lse0)
