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
wins, a fused pin wins where the kernel fits), and unpinned, its cost
model (derived for the port's kernels, its constants measured on an NVIDIA
H100 80GB HBM3 at 700 W by chip_smoke.py's ``bwd_mode`` phase) picks the
mode the card measured faster at the shapes that phase times (either where
the two are within 5%, as that phase's gate), where the JAX package's model (which prices TPU tensor-core tiles and a per-item dq
read-modify-write in HBM) picks split at all of them.
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

from tests.torch_port_cases import BAND_INF, MASKS, _typed, qkv

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
    got = ffa_bwd_mode(plan, params, D, D, 4, 2 * HK, HK)
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


def _sink_window(seq=8192):
    from magiattention_tpu_torch.api.functools import infer_attn_mask_from_cu_seqlens

    qr, kr, types = infer_attn_mask_from_cu_seqlens(
        [0, seq], causal=False, window_size=(64, 0), global_window_size=64
    )
    return qr.to_naive_ranges(), kr.to_naive_ranges(), [t.to_int_type() for t in types]


_DOCS = [[0, 4096], [4096, 8192]]
_VARLEN_Q = [[0, 3072], [3072, 6144], [6144, 7168], [7168, 7680]]
_VARLEN_K = [[0, 3072], [3072, 6144], [6144, 7168], [6144, 7680]]
# chip_smoke.py's backward shapes: (q_ranges, k_ranges, types, sq, sk, hq,
# hk, itemsize), head_dim 128, and the fused and split (dq + dk/dv) ms the
# card measured there (NVIDIA H100 80GB HBM3, 700.00 W; bf16 runs the
# tensor-core bodies, whose times these are: the CUDA-core bodies' times,
# under which split won only the sink window, at 13.38 / 11.05, are in
# tests/test_torch_tensor_cores.py)
MEASURED_SHAPES = {
    "causal_8192_bf16": (([[0, 8192]], [[0, 8192]], [1], 8192, 8192, 16, 8, 2), (4.44, 4.76)),
    "varlen_8192_bf16": ((_VARLEN_Q, _VARLEN_K, [1, 1, 2, 3], 8192, 8192, 16, 8, 2), (1.54, 1.64)),
    "serving_prefill_f32": (([[0, 512]], [[0, 2048]], None, 512, 4096, 32, 8, 4), (1.57, 2.00)),
    "train_docs_8192_bf16": ((_DOCS, _DOCS, [1, 1], 8192, 8192, 32, 8, 2), (4.90, 4.88)),
    "sink_window_8192_bf16": ((*_sink_window(), 8192, 8192, 32, 8, 2), (3.21, 2.50)),
}
# the train shape's kernel times in the same run (ms; dq_gqa: the packed dq
# kernel, 2 heads per CTA)
MEASURED_TRAIN_MS = {"dq": 13.314752, "dq_gqa": 13.263728, "dkv": 18.575008, "fused": 25.490304}


def _measured_plan(name):
    """Plan, params, heads and itemsize of a measured shape, and the modes
    chip_smoke.py's bwd_mode gate accepts there: the faster, and the other
    too where the two are within 5%."""
    (qr, kr, types, sq, sk, hq, hk, itemsize), (fused, split) = MEASURED_SHAPES[name]
    if types is None:  # the serving prefill chunk: queries at 1536.. over 2048 stored rows
        plan, params = plan_params(qr, kr, None, [-BAND_INF], [1536], sq, sk, 128, None, 0.0)
    else:
        plan, params = plan_params(qr, kr, types, None, None, sq, sk, 128, None, 0.0)
    if abs(fused - split) / min(fused, split) <= 0.05:
        accepted = {"fused", "split"}
    else:
        accepted = {"fused" if fused < split else "split"}
    return plan, params, hq, hk, itemsize, accepted


def test_cost_model_choice_equals_jax(monkeypatch):
    """Unpinned, the port picks the mode the card measured faster at each
    timed shape (either at the train shape, where the two are 0.3% apart):
    fused at four, split at the sink window. The JAX package's model, on
    the same plans at the same tiles, picks split at all of them: it
    equals the port's choice only at the sink window."""
    monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
    for name in MEASURED_SHAPES:
        plan, params, hq, hk, itemsize, accepted = _measured_plan(name)
        got = ffa_bwd_mode(plan, params, 128, 128, itemsize, hq, hk)
        assert got in accepted, name
        want = jax_tile_policy.choose_bwd_mode(
            plan.num_work, 64, 64, plan.num_work_t, 64, 64, 128, 128,
            itemsize=itemsize, group=hq // hk,
        )
        assert want == "split" and (got == want) == name.startswith("sink_window"), name


def test_balance_constant_is_the_h100_data_sheet_ratio():
    """The model's card figures are the H100 SXM data sheet's (132 SMs,
    3.35 TB/s), and its measured constants of the CUDA-core kernels are
    what ``tile_policy.calibrate`` derives from the kernel times measured
    at the train shape (in a run of the fused kernel's CUDA-core body),
    and the model reproduces the split kernels' times there."""
    assert tile_policy.NUM_SMS == 132 and tile_policy.HBM_BYTES_PER_S == 3.35e12
    plan, _, hq, hk, itemsize, _ = _measured_plan("train_docs_8192_bf16")
    shape = port_ffa.bwd_shape(plan, hq, hk, 128, 128, itemsize)
    got = tile_policy.calibrate(shape, MEASURED_TRAIN_MS)
    got.update(tile_policy.calibrate(
        shape, dict(MEASURED_TRAIN_MS, dq=MEASURED_TRAIN_MS["dq_gqa"]), dq_heads_per_cta=2
    ))
    for key, us in tile_policy.ITEM_US.items():
        assert us == pytest.approx(got[key], rel=2e-3), key
    assert tile_policy.ATOMIC_ADDS_PER_S == pytest.approx(got["atomic_adds_per_s"], rel=2e-3)
    modeled = tile_policy.fma_ms(shape)
    for key in ("dq", "dkv"):
        assert modeled[key] == pytest.approx(MEASURED_TRAIN_MS[key], rel=5e-3), key


def test_train_shape_picks_split_in_both_models(monkeypatch):
    """At the trainer's attention shape (two causal documents of 4096,
    group 4, head_dim 128, bf16) the JAX package's model picks split, at
    its own TPU tiles and balance constant as at the port's tiles; the
    port's model picks fused there, with the split or packed dq kernel
    alike: the H100 measured fused faster with the CUDA-core bodies
    (25.49 against 31.89 ms) and the two 0.3% apart with the tensor-core
    bodies (4.90 against 4.88 ms), where chip_smoke.py's gate takes
    either."""
    monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
    qr, kr, types, s = _DOCS, _DOCS, [1, 1], 8192
    plan, params = plan_params(qr, kr, types, None, None, s, s, 128, None, 0.0)
    assert ffa_bwd_mode(plan, params, 128, 128, 2, 32, 8) == "fused"
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "1")
    assert ffa_bwd_mode(plan, params, 128, 128, 2, 32, 8) == "fused"
    bq, bk = jax_ffa.default_blocks(s, s)
    lo, hi = port_ffa.types_to_bands(np.array(qr), np.array(kr), np.array(types))
    ref = build_ffa_plan(np.array(qr, np.int32), np.array(kr, np.int32), lo, hi, s, s, bq, bk)
    assert jax_tile_policy.BWD_MXU_ELEMS_PER_HBM_BYTE == 240
    got = jax_tile_policy.choose_bwd_mode(
        ref.num_work, bq, bk, ref.num_work_t, bq, bk, 128, 128, itemsize=2, group=4
    )
    assert got == "split", (bq, bk)
