"""The port's GQA-packed FFA routes and its max-logits output on the CPU,
against the JAX package's.

Under ``MAGI_ATTENTION_FFA_GQA_PACK=1`` and ``MAGI_ATTENTION_FFA_GQA_PACK_DQ=1``
(with the split backward pinned, so dq has a kernel of its own) the JAX
package runs its packed Pallas kernels ``_ffa_fwd_pallas_gqa`` and
``_ffa_bwd_dq_pallas_gqa`` in interpret mode (tests/conftest.py), and the
port takes its packed routes ``ffa_fwd_gqa`` / ``ffa_bwd_dq_gqa`` through
``_FFACore`` (on the CPU: their plain versions, ``sdpa_attn`` over the
plan's slices and ``ffa_bwd_dq_plain``; the CUDA kernels are held against
those on the card by chip_smoke.py). Both sides are spied on, so each test
shows the packed route ran. Same numpy inputs: float32, sq = sk = 320 (not
a multiple of the tiles), hk 2, head_dim 64, g 2 and 4, a mask with
uncovered rows and unreached k rows and a mask of two bands;
``flex_flash_attn_func`` under the flags too. Tolerance: atol, rtol and
rel-norm 1e-5 (float32 sums in other orders).

Also: the port's guard picks the packed route exactly where the JAX
package's does (flag, group > 1, no max-logits for the forward), and
max-logits through ``flex_flash_attn_func`` equals the JAX package's
(softcap off and on, a sink, the plain backend, a mask with no live pair).
Max-logits through ``calc_attn`` at cp 2 is in tests/test_torch_cp.py.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.functional.flex_flash_attn import (
    flex_flash_attn_func as jax_flex_flash_attn_func,
)
from magiattention_tpu.kernels import ffa as jax_ffa
from magiattention_tpu_torch.functional import flex_flash_attn_func
from magiattention_tpu_torch.kernels import ffa as port_ffa
from magiattention_tpu_torch.kernels.ffa import _FFACore, plan_params
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import BAND_INF, qkv

SEQ, HK, D = 320, 2, 64
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
PACK = {"MAGI_ATTENTION_FFA_GQA_PACK": "1", "MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1"}
SPLIT = {"MAGI_ATTENTION_BACKEND_FFA_BWD": "split"}
# name -> (q_ranges, k_ranges, d_lo, d_hi)
GQA_MASKS = {
    # causal then full: rows [250, 320) uncovered, k rows [300, 320) unreached
    "uncovered": ([[0, 100], [100, 250]], [[0, 100], [60, 300]], [-BAND_INF, -BAND_INF], [0, BAND_INF]),
    # a causal band over the first half of k, a 48-key sliding band over the rest
    "bands": ([[0, 320], [64, 320]], [[0, 160], [160, 320]], [-BAND_INF, -48], [0, 0]),
    # one slice whose band misses its rectangle: no live pair at all
    "none": ([[0, 100]], [[150, 200]], [-300], [-250]),
}
CASES = [("uncovered", 4), ("bands", 2)]


def _meta(mask):
    return tuple(np.asarray(a, np.int32) for a in GQA_MASKS[mask])


def _inputs(mask, g):
    q, k, v = qkv(np.random.default_rng(g), SEQ, SEQ, g * HK, HK, D)
    do = np.random.default_rng(100 + g).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


@lru_cache(maxsize=None)
def _jax_packed(mask, g):
    """JAX ffa_attn's (out, lse, dq, dk, dv) under both pack flags and the
    split pin, and the packed kernels it ran."""
    q, k, v, do = _inputs(mask, g)
    qr, kr, lo, hi = _meta(mask)
    calls = []

    def loss(q, k, v):
        out, lse = jax_ffa.ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
        return jnp.sum(out * do), (out, lse)

    with pytest.MonkeyPatch.context() as mp:
        for key, val in {**PACK, **SPLIT}.items():
            mp.setenv(key, val)
        _spy(mp, jax_ffa, "_ffa_fwd_pallas_gqa", calls)
        _spy(mp, jax_ffa, "_ffa_bwd_dq_pallas_gqa", calls)
        (_, (out, lse)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v))
        )
    return [np.asarray(x) for x in (out, lse, *grads)], tuple(sorted(set(calls)))


def _port_packed(mask, g, monkeypatch):
    """The port's (out, lse, dq, dk, dv) through _FFACore under the same
    env, and the packed routes it took."""
    q, k, v, do = _inputs(mask, g)
    qr, kr, lo, hi = _meta(mask)
    for key, val in {**PACK, **SPLIT}.items():
        monkeypatch.setenv(key, val)
    calls = []
    _spy(monkeypatch, port_ffa, "ffa_fwd_gqa", calls)
    _spy(monkeypatch, port_ffa, "ffa_bwd_dq_gqa", calls)
    plan, params = plan_params(qr, kr, None, lo, hi, SEQ, SEQ, D, None, 0.0)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = _FFACore.apply(*leaves, plan, params)
    (out * torch.from_numpy(do)).sum().backward()
    got = [out.detach().numpy(), lse.numpy(), *(x.grad.numpy() for x in leaves)]
    return got, tuple(sorted(set(calls)))


@pytest.mark.parametrize("mask,g", CASES)
def test_packed_forward_matches_jax(mask, g, monkeypatch):
    (want, jax_calls) = _jax_packed(mask, g)
    got, calls = _port_packed(mask, g, monkeypatch)
    assert "_ffa_fwd_pallas_gqa" in jax_calls and "ffa_fwd_gqa" in calls
    np.testing.assert_array_equal(np.isneginf(got[1]), np.isneginf(want[1]))
    for name, a, b in zip(("out", "lse"), got, want):
        assert_close(a, b, msg=f"{mask} g{g} {name}", **TOL)
    if mask == "uncovered":
        assert not got[0][250:].any() and np.isneginf(got[1][250:]).all()


@pytest.mark.parametrize("mask,g", CASES)
def test_packed_dq_matches_jax(mask, g, monkeypatch):
    (want, jax_calls) = _jax_packed(mask, g)
    got, calls = _port_packed(mask, g, monkeypatch)
    assert "_ffa_bwd_dq_pallas_gqa" in jax_calls and "ffa_bwd_dq_gqa" in calls
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert np.isfinite(a).all(), f"{name} not finite"
        assert_close(a, b, msg=f"{mask} g{g} {name}", **TOL)
    if mask == "uncovered":
        assert not got[2][250:].any() and not got[3][300:].any()


@pytest.mark.parametrize("mask,g", CASES)
def test_flex_flash_attn_under_pack_flags_matches_jax(mask, g, monkeypatch):
    q, k, v, _ = _inputs(mask, g)
    qr, kr, lo, hi = _meta(mask)
    for key, val in PACK.items():
        monkeypatch.setenv(key, val)
    out, meta = flex_flash_attn_func(
        *(torch.from_numpy(a) for a in (q, k, v)), qr, kr, d_lo=lo, d_hi=hi
    )
    want, _ = _jax_packed(mask, g)
    assert_close(out, want[0], msg=f"{mask} g{g} out", **TOL)
    assert_close(meta.lse, want[1], msg=f"{mask} g{g} lse", **TOL)


def _jax_params(plan, g, emit_max_logits):
    return jax_ffa.FFAParams(
        num_work=plan.num_work, num_work_t=plan.num_work_t,
        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
        block_q=64, block_k=64, softmax_scale=D ** -0.5, softcap=0.0,
        group=g, interpret=True, emit_max_logits=emit_max_logits,
    )


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("flag", ["0", "1"])
def test_guard_takes_the_packed_route_where_jax_does(flag, itemsize, monkeypatch):
    """Flag, group > 1 and (forward) no max-logits, at geometries both
    packages' budgets fit (head_dim 64 and 128, 64 x 64 tiles), for
    float32 and bf16 inputs (bf16's forward and dq run the tensor-core
    bodies, whose own head counts the guards take)."""
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK", flag)
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", flag)
    plan, _ = plan_params(*_meta("bands")[:2], None, *_meta("bands")[2:], SEQ, SEQ, D, None, 0.0)
    seen = set()
    for d in (64, 128):
        for g in (1, 2, 4):
            for ml in (False, True):
                want = jax_ffa._use_gqa_pack(_jax_params(plan, g, ml), d, d, itemsize)
                got = port_ffa._use_gqa_pack(g, d, d, ml, itemsize) > 1
                assert got == want, (flag, d, g, ml)
                seen.add(got)
            want_dq = jax_ffa._use_gqa_pack_dq(_jax_params(plan, g, False), d, d, itemsize)
            assert (port_ffa._use_gqa_pack_dq(g, d, d, itemsize) > 1) == want_dq, (flag, d, g)
    assert seen == ({True, False} if flag == "1" else {False})


def test_pack_heads_follow_the_budget():
    """Heads per CTA: the largest of 4 and 2 dividing the group whose
    tiles fit 227 KB of shared memory (dq: 2 tiles per head) and whose
    accumulators fit the register limit; 1 (unpacked) otherwise."""
    assert port_ffa.PACK_HEADS == (4, 2)
    assert port_ffa.SMEM_PER_CTA == 232_448
    for g, d, fwd, dq in (
        (2, 64, 2, 2), (4, 64, 4, 4), (8, 64, 4, 4), (3, 64, 1, 1), (6, 64, 2, 2),
        (2, 128, 2, 2), (4, 128, 4, 2), (8, 128, 4, 2), (1, 128, 1, 1),
    ):
        assert port_ffa.fwd_pack_heads(g, d, d) == fwd, (g, d)
        assert port_ffa.dq_pack_heads(g, d, d) == dq, (g, d)
    assert port_ffa.fwd_pack_smem_bytes(128, 4) == 223_232 <= port_ffa.SMEM_PER_CTA
    assert port_ffa.dq_pack_smem_bytes(128, 4) > port_ffa.SMEM_PER_CTA
    assert port_ffa.fwd_pack_heads(4, 128, 64) == 1  # d != dv: unpacked
    assert port_ffa.gqa_pack_variant("dkv") == "gqa_packed"  # the JAX default
    with pytest.raises(ValueError, match="kind"):
        port_ffa.gqa_pack_variant("bwd")


def _max_logits_pair(softcap=0.0, sink=None, backend="ffa", mask="uncovered", g=2):
    q, k, v, _ = _inputs(mask, g)
    qr, kr, lo, hi = _meta(mask)
    kw = dict(softcap=softcap, backend=backend, d_lo=lo, d_hi=hi, return_max_logits=True)
    _, meta = flex_flash_attn_func(
        *(torch.from_numpy(a) for a in (q, k, v)), qr, kr,
        sink=None if sink is None else torch.from_numpy(sink), **kw,
    )
    _, jmeta = jax_flex_flash_attn_func(
        *(jnp.asarray(a) for a in (q, k, v)), qr, kr,
        sink=None if sink is None else jnp.asarray(sink), **kw,
    )
    return meta.max_logits.numpy(), np.asarray(jmeta.max_logits)


@pytest.mark.parametrize(
    "softcap,sink,backend",
    [(0.0, False, "ffa"), (30.0, False, "ffa"), (0.0, True, "ffa"), (0.0, False, "sdpa")],
)
def test_max_logits_matches_jax(softcap, sink, backend):
    sink_arr = np.random.default_rng(7).standard_normal((3, 2 * HK)).astype(np.float32) if sink else None
    got, want = _max_logits_pair(softcap, sink_arr, backend)
    assert got.shape == (2 * HK,) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert_close(got, want, **TOL)


def test_max_logits_of_a_mask_with_no_live_pair_is_minus_inf():
    got, want = _max_logits_pair(mask="none")
    assert np.isneginf(got).all() and np.isneginf(want).all()
