"""The port's fused one-pass FFA backward on the CPU against the JAX
package's.

The same numpy inputs go through the JAX package's ``ffa_attn`` under
``MAGI_ATTENTION_BACKEND_FFA_BWD=fused`` (its ``_bwd_fused_kernel[_gqa]``,
Pallas in interpret mode, tests/conftest.py) and through the port's fused
backward: its plain version ``ffa_bwd_fused_plain`` (the function the
CUDA kernel ``csrc/ffa_bwd_fused.cu`` is held against on the card) and
``_FFACore``'s backward under the same pin. Float32, atol/rtol/rel-norm
1e-5 (all sides accumulate in float32 in different orders); head_dim 64
(the fused kernel's smallest); g in {1, 2, 4}; softcap 30; a mask with
uncovered rows and unreached k tiles, whose gradients must be exact
zeros.

Also: ``ffa_bwd_mode`` follows the JAX package's precedence (a split pin
wins, a fused pin wins where the kernel fits), and unpinned, its cost-model
choice on a plan equals JAX's ``choose_bwd_mode`` on the JAX plan of the
same slices, with the JAX model's balance constant set to the port's
(the port re-derives it for the H100: 295 against the TPU's 240).
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import ffa as jax_ffa
from magiattention_tpu.kernels import tile_policy as jax_tile_policy
from magiattention_tpu.kernels.ffa_plan import build_ffa_plan
from magiattention_tpu_torch.kernels import ffa as port_ffa
from magiattention_tpu_torch.kernels import tile_policy
from magiattention_tpu_torch.kernels.ffa import (
    _FFACore,
    ffa_bwd_fused_plain,
    ffa_bwd_mode,
    ffa_delta_plain,
    ffa_fwd,
    plan_params,
)
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import MASKS, _typed, qkv

HK, D = 2, 64
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
# q rows [0, 8) and [48, 80) uncovered; k rows [40, 100) and the k tile
# [128, 192) no slice reaches
UNREACHED = _typed([[0, 48], [80, 128]], [[0, 40], [100, 128]], [1, 0], 128, 192)
FUSED_MASKS = {
    **{m: MASKS[m] for m in ("causal", "varlen", "bicausal", "sliding_band")},
    "unreached": UNREACHED,
}
CASES = [(m, 2, 0.0) for m in sorted(FUSED_MASKS)] + [
    ("varlen", 1, 0.0),
    ("varlen", 4, 0.0),
    ("varlen", 2, 30.0),
]


def _arrays(mask, g, seed=0):
    qr, kr, lo, hi, sq, sk = FUSED_MASKS[mask]
    q, k, v = qkv(np.random.default_rng(seed), sq, sk, g * HK, HK, D)
    do = np.random.default_rng(seed + 100).standard_normal(q.shape).astype(np.float32)
    return (q, k, v, do), (qr, kr, lo, hi, sq, sk)


@lru_cache(maxsize=None)
def _jax_fused(mask, g, softcap):
    """JAX ffa_attn's (dq, dk, dv) under the fused backward pin."""
    (q, k, v, do), (qr, kr, lo, hi, _, _) = _arrays(mask, g)

    def loss(q, k, v):
        out, _ = jax_ffa.ffa_attn(q, k, v, qr, kr, softcap=softcap, d_lo=lo, d_hi=hi)
        return jnp.sum(out * do)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused")
        grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in grads]


def _assert_grads_close(got, want, msg):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        assert np.isfinite(a).all(), f"{msg} {name} not finite"
        assert_close(a, b, msg=f"{msg} {name}", **TOL)


def _plain_fused(mask, g, softcap):
    (q, k, v, do), (qr, kr, lo, hi, sq, sk) = _arrays(mask, g)
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, D, None, softcap)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ffa_fwd(q, k, v, plan, params)
    delta = ffa_delta_plain(out, do)
    return ffa_bwd_fused_plain(q, k, v, do, lse, delta, plan, params)


@pytest.mark.parametrize("mask,g,softcap", CASES)
def test_fused_plain_matches_jax_fused(mask, g, softcap):
    _assert_grads_close(_plain_fused(mask, g, softcap), _jax_fused(mask, g, softcap), mask)


@pytest.mark.parametrize("mask,g,softcap", CASES)
def test_ffa_core_under_fused_pin_matches_jax(mask, g, softcap, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused")
    (q, k, v, do), (qr, kr, lo, hi, sq, sk) = _arrays(mask, g)
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, D, None, softcap)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ffa_bwd_fused_plain.calls = 0
    out, _ = _FFACore.apply(*leaves, plan, params)
    (out * torch.from_numpy(do)).sum().backward()
    assert ffa_bwd_fused_plain.calls == 1
    _assert_grads_close([x.grad for x in leaves], _jax_fused(mask, g, softcap), mask)


def test_uncovered_rows_and_unreached_k_get_exact_zeros():
    dq, dk, dv = _plain_fused("unreached", 2, 0.0)
    assert not dq[0:8].any() and not dq[48:80].any()
    for t in (dk, dv):
        assert not t[40:100].any() and not t[128:192].any()
    assert dq[8:48].abs().sum() > 0 and dk[0:40].abs().sum() > 0


@pytest.mark.parametrize("pin", ["split", "fused", None])
def test_mode_precedence_matches_jax(pin, monkeypatch):
    """Pinned, the port resolves what the JAX package resolves (both
    kernels fit at head_dim 64); a split pin wins over everything."""
    monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
    if pin is None:
        monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
    else:
        monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", pin)
    qr, kr, lo, hi, sq, sk = FUSED_MASKS["causal"]
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, D, None, 0.0)
    got = ffa_bwd_mode(plan, params, D, D, 4, 2)
    if pin is None:
        assert got in ("split", "fused")
        return
    jp = jax_ffa.FFAParams(
        num_work=plan.num_work, num_work_t=plan.num_work_t,
        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
        block_q=64, block_k=64, softmax_scale=D ** -0.5, softcap=0.0,
        group=2, interpret=True,
    )
    want = jax_ffa.ffa_bwd_mode(jp, plan.num_q_tiles * 64, D, D, 4, plan.meta.shape[1])
    assert got == want == pin


# (q_ranges, k_ranges, types, seqlen): causal, two documents, a shared
# prefix with a causal tail, and a sparse band, at 4096 tokens
COST_MASKS = {
    "causal": ([[0, 4096]], [[0, 4096]], [1], 4096),
    "docs": ([[0, 2048], [2048, 4096]], [[0, 2048], [2048, 4096]], [1, 1], 4096),
    "prefix": ([[0, 4096], [512, 4096]], [[0, 512], [512, 4096]], [0, 1], 4096),
    "band": ([[0, 4096]], [[0, 4096]], [3], 4096),
}


def test_cost_model_choice_equals_jax(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
    monkeypatch.setattr(
        jax_tile_policy, "BWD_MXU_ELEMS_PER_HBM_BYTE", tile_policy.BWD_MXU_ELEMS_PER_HBM_BYTE
    )
    seen = set()
    for name, (qr, kr, types, s) in COST_MASKS.items():
        lo, hi = port_ffa.types_to_bands(np.array(qr), np.array(kr), np.array(types))
        ref = build_ffa_plan(np.array(qr, np.int32), np.array(kr, np.int32), lo, hi, s, s, 64, 64)
        for d in (64, 128):
            plan, params = plan_params(qr, kr, types, None, None, s, s, d, None, 0.0)
            assert (plan.num_work, plan.num_work_t) == (ref.num_work, ref.num_work_t)
            for itemsize in (2, 4):
                for g in (1, 2, 4):
                    got = ffa_bwd_mode(plan, params, d, d, itemsize, g)
                    want = jax_tile_policy.choose_bwd_mode(
                        ref.num_work, 64, 64, ref.num_work_t, 64, 64, d, d,
                        itemsize=itemsize, group=g,
                    )
                    assert got == want, (name, d, itemsize, g)
                    seen.add(got)
    assert seen == {"split", "fused"}  # both branches of the model are reached


def test_balance_constant_is_the_h100_data_sheet_ratio():
    assert tile_policy.BWD_MXU_ELEMS_PER_HBM_BYTE == round(989e12 / 3.35e12)


def test_train_shape_picks_split_in_both_models(monkeypatch):
    """At the trainer's attention shape (two causal documents of 4096,
    group 4, head_dim 128, bf16) the port's model picks split at the
    Hopper tiles, and so does the JAX package's at its own TPU tiles and
    balance constant: unpinned, the port runs the reference's default
    backward there. The per-item dq read-modify-write term decides it in
    both (ROADMAP lists re-deriving it for the H100 kernel)."""
    monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
    qr, kr, types, s = [[0, 4096], [4096, 8192]], [[0, 4096], [4096, 8192]], [1, 1], 8192
    plan, params = plan_params(qr, kr, types, None, None, s, s, 128, None, 0.0)
    assert ffa_bwd_mode(plan, params, 128, 128, 2, 4) == "split"
    bq, bk = jax_ffa.default_blocks(s, s)
    lo, hi = port_ffa.types_to_bands(np.array(qr), np.array(kr), np.array(types))
    ref = build_ffa_plan(np.array(qr, np.int32), np.array(kr, np.int32), lo, hi, s, s, bq, bk)
    assert jax_tile_policy.BWD_MXU_ELEMS_PER_HBM_BYTE == 240
    got = jax_tile_policy.choose_bwd_mode(
        ref.num_work, bq, bk, ref.num_work_t, bq, bk, 128, 128, itemsize=2, group=4
    )
    assert got == "split", (bq, bk)
