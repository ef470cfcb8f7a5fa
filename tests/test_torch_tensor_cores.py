"""The port's bf16 FFA kernels on Hopper's tensor cores, checked on the CPU.

The bf16 instances of B1/B2 (``csrc/ffa_fwd_tc.cuh``), B3/B4
(``csrc/ffa_bwd_dq_tc.cuh``), B5/B6 and B8/B9 (``csrc/bwd_kv_tc.cuh``)
run on the card only; what the CPU can check is what surrounds them:

- the backward-mode cost model per dtype: the CUDA-core kernels keep
  their constants (the split pair at chip_smoke.py's five ``bwd_mode``
  masks in the run where every backward kernel had its CUDA-core body;
  the float32 serving prefill, which keeps that body, and its choice in
  both runs); bf16 prices the tensor-core bodies (dq, packed dq, dk/dv,
  fused) with the constants fitted to the times the card measured
  (``calibrate_tc``) and picks the mode the card timed faster at each
  mask; the precedence (deterministic, then the pins, then the model)
  holds for bf16 too;
- every ``<name>_{f32,bf16}`` symbol ``kernels/ffa.py:_launch`` looks up
  is an ``extern "C"`` function of ``csrc/<name>.cu`` with the argument
  count the ctypes binding passes (read from the source: nothing compiles
  here);
- the tensor cores' rounding in plain PyTorch: P rounded to bf16 before
  P V (per 64-key tile, in the online softmax's running max); P^T split
  into bf16 hi + lo before dV = P^T dO and dS before dK = dS^T Q (two
  products each), dS rounded to bf16 (hi) before dQ = dS K; all summed in
  float32. It stays within chip_smoke.py's bf16 bounds (atol 2e-2,
  rel-norm 1e-2) of the float32 plain versions on five mask kinds, and a
  k row every q row sees (a global token) shows why dK and dV take the lo
  products. The split dq (q-major) rounds dS once, as the A operand of
  dQ = dS K; at the longest q rows of chip_smoke.py's masks (causal 8192,
  the sink window) that stays within the bf16 bounds;
- the bf16 packed dq's heads per CTA follow the tensor-core budget.
"""

import ast
import math
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.kernels import ffa as port_ffa
from magiattention_tpu_torch.kernels import tile_policy
from magiattention_tpu_torch.kernels.ffa import (
    bwd_shape,
    ffa_bwd_fused_plain,
    ffa_bwd_mode,
    ffa_delta_plain,
    plan_params,
)
from magiattention_tpu_torch.kernels.mask_utils import BAND_INF, build_dense_mask_band
from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

from tests.torch_port_cases import MASKS, _typed

_DOCS = [[0, 4096], [4096, 8192]]
_VARLEN_Q = [[0, 3072], [3072, 6144], [6144, 7168], [7168, 7680]]
_VARLEN_K = [[0, 3072], [3072, 6144], [6144, 7168], [6144, 7680]]


def _sink_window(seq):
    from magiattention_tpu_torch.api.functools import infer_attn_mask_from_cu_seqlens

    qr, kr, types = infer_attn_mask_from_cu_seqlens(
        [0, seq], causal=False, window_size=(64 if seq > 1024 else 16, 0),
        global_window_size=64 if seq > 1024 else 16,
    )
    return qr.to_naive_ranges(), kr.to_naive_ranges(), [t.to_int_type() for t in types]


# chip_smoke.py's bwd_mode masks: (q_ranges, k_ranges, types, sq, sk, hq, hk,
# itemsize), head_dim 128, with the kernel ms the card measured, NVIDIA
# H100 80GB HBM3, 700.00 W: a run in which every backward kernel had its
# CUDA-core body (fused, split = dq + dk/dv), and a run in which bf16's
# have the tensor-core bodies (fused, dq, dk/dv, and the packed dq where
# bwd_mode times it; the float32 serving prefill keeps the CUDA-core
# bodies)
BWD_MODE_MASKS = {
    "causal_8192_bf16": ([[0, 8192]], [[0, 8192]], [1], 8192, 8192, 16, 8, 2),
    "varlen_8192_bf16": (_VARLEN_Q, _VARLEN_K, [1, 1, 2, 3], 8192, 8192, 16, 8, 2),
    "serving_prefill_f32": ([[0, 512]], [[0, 2048]], None, 512, 4096, 32, 8, 4),
    "train_docs_8192_bf16": (_DOCS, _DOCS, [1, 1], 8192, 8192, 32, 8, 2),
    "sink_window_8192_bf16": (None, None, None, 8192, 8192, 32, 8, 2),
}
CUDA_CORE_MS = {  # fused, split
    "causal_8192_bf16": (22.99, 29.93),
    "varlen_8192_bf16": (8.41, 10.54),
    "serving_prefill_f32": (1.59, 2.01),
    "train_docs_8192_bf16": (25.49, 31.89),
    "sink_window_8192_bf16": (13.38, 11.05),
}
TENSOR_CORE_MS = {
    "causal_8192_bf16": dict(
        fused=4.442320108413696, dq=1.8497440218925476, dkv=2.9060639142990112,
    ),
    "varlen_8192_bf16": dict(
        fused=1.5441120266914368, dq=0.627232015132904, dkv=1.0124159455299377,
    ),
    "serving_prefill_f32": dict(
        fused=1.5692960023880005, dq=0.8346880078315735, dkv=1.1694879531860352,
    ),
    "train_docs_8192_bf16": dict(
        fused=4.896015882492065, dq=1.8622080087661743, dkv=3.021343946456909,
        dq_gqa=1.8099040389060974,
    ),
    "sink_window_8192_bf16": dict(
        fused=3.209391951560974, dq=0.2612544059753418, dkv=2.235632061958313,
        dq_gqa=0.2705600023269653,
    ),
}


@lru_cache(maxsize=None)
def _bwd_mode_plan(name):
    qr, kr, types, sq, sk, hq, hk, itemsize = BWD_MODE_MASKS[name]
    if name.startswith("sink_window"):
        qr, kr, types = _sink_window(sq)
    if types is None:  # the serving prefill chunk: queries at 1536.. over 2048 stored rows
        plan, params = plan_params(qr, kr, None, [-BAND_INF], [1536], sq, sk, 128, None, 0.0)
    else:
        plan, params = plan_params(qr, kr, types, None, None, sq, sk, 128, None, 0.0)
    return plan, params, bwd_shape(plan, hq, hk, 128, 128, itemsize)


def _faster(fused, split):
    return "fused" if fused <= split else "split"


def _accepted(fused, split):
    """The modes chip_smoke.py's bwd_mode gate accepts: the faster one, and
    the other too where the two are within 5%."""
    if abs(fused - split) / min(fused, split) <= 0.05:
        return {"fused", "split"}
    return {_faster(fused, split)}


def _tc_run(name):
    """(fused, split) ms of the tensor-core run at one mask."""
    t = TENSOR_CORE_MS[name]
    return t["fused"], t["dq"] + t["dkv"]


@pytest.mark.parametrize("name", sorted(BWD_MODE_MASKS))
def test_cuda_core_body_keeps_its_choices(name):
    """The CUDA-core kernels keep their constants: in the CUDA-core body
    the split pair (dq, then dk/dv) is modeled within 10% of its time in
    the run where every kernel had that body, at every mask; the float32
    mask, where that body still runs, is modeled within 10% in the
    tensor-core run too, and the model picks the mode the card timed
    faster there in both runs. bf16 masks price the tensor-core bodies."""
    assert tile_policy.ITEM_US == {"dq": 11.50, "dq_gqa": 11.73, "dkv": 15.27}
    assert tile_policy.FUSED_BODY_OVER_DKV == 1.25
    assert tile_policy.ATOMIC_ADDS_PER_S == 4.45e11
    _, _, shape = _bwd_mode_plan(name)
    fma = tile_policy.fma_ms(shape)
    assert fma["dq"] + fma["dkv"] == pytest.approx(CUDA_CORE_MS[name][1], rel=0.1)
    if shape.itemsize == 4:
        assert tile_policy.dtype_body(shape) == "fma"
        assert tile_policy.bwd_mode_ms(shape)["split"] == pytest.approx(_tc_run(name)[1], rel=0.1)
        for run in (CUDA_CORE_MS[name], _tc_run(name)):
            assert tile_policy.choose_bwd_mode(shape) == _faster(*run)
    else:
        assert tile_policy.dtype_body(shape) == "tc"


@pytest.mark.parametrize("name", sorted(BWD_MODE_MASKS))
def test_dtype_body_picks_the_faster_mode(name, monkeypatch):
    """Unpinned, ``ffa_bwd_mode`` prices the dtype's bodies and picks the
    mode the card timed faster at every mask with the tensor-core bodies
    (split at the sink window, whose one long k-major run holds the fused
    kernel back longer than the lighter dk/dv kernel), or either where the
    two are within 5% (the train shape: fused 4.90, split 4.88 ms)."""
    monkeypatch.delenv("MAGI_ATTENTION_BACKEND_FFA_BWD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_FFA_FUSED_BWD", raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_DETERMINISTIC_MODE", raising=False)
    plan, params, shape = _bwd_mode_plan(name)
    *_, hq, hk, itemsize = BWD_MODE_MASKS[name]
    assert tile_policy.dtype_body(shape) == ("tc" if itemsize == 2 else "fma")
    assert ffa_bwd_mode(plan, params, 128, 128, itemsize, hq, hk) in _accepted(*_tc_run(name))


_BF16_MASKS = [n for n in sorted(BWD_MODE_MASKS) if BWD_MODE_MASKS[n][-1] == 2]


def test_tensor_core_constants_are_the_fit():
    """The bf16 fused body's constant in the code is what ``calibrate_tc``
    fits to the four bf16 fused times measured, and the model then lands
    within 10% of each of them, the sink window's one long run included."""
    shapes = [_bwd_mode_plan(n)[2] for n in _BF16_MASKS]
    got = tile_policy.calibrate_tc("fused", shapes, [TENSOR_CORE_MS[n]["fused"] for n in _BF16_MASKS])
    assert tile_policy.TC_ITEM_US["fused"] == pytest.approx(got, rel=2e-3)
    for n, s in zip(_BF16_MASKS, shapes):
        assert tile_policy.kernel_ms(s)["fused"] == pytest.approx(TENSOR_CORE_MS[n]["fused"], rel=0.1), n


# per split kernel: its dq heads per CTA, and how close the one-constant
# model lands at each mask it was fitted to
SPLIT_FIT = {"dq": (1, 0.1), "dq_gqa": (2, 0.15), "dkv": (1, 0.25)}


@pytest.mark.parametrize("kernel", sorted(SPLIT_FIT))
def test_split_tensor_core_constants_are_the_fit(kernel):
    """The bf16 split kernels' constants in the code are what
    ``calibrate_tc`` fits to their times measured at the bf16 masks (the
    packed dq at the two that time it, 2 heads per CTA), and the model
    lands near each of them: dq within 10% (the packed dq 15%), dk/dv
    within 25%, the sink window's one 516-step k-major run alone on an SM
    being 23% slower than the fitted pace (the other masks within 8%)."""
    heads, rel = SPLIT_FIT[kernel]
    names = [n for n in _BF16_MASKS if kernel in TENSOR_CORE_MS[n]]
    shapes = [_bwd_mode_plan(n)[2] for n in names]
    times = [TENSOR_CORE_MS[n][kernel] for n in names]
    got = tile_policy.calibrate_tc(kernel, shapes, times, dq_heads_per_cta=heads)
    assert tile_policy.TC_ITEM_US[kernel] == pytest.approx(got, rel=2e-3)
    key = "dkv" if kernel == "dkv" else "dq"
    for n, s, t in zip(names, shapes, times):
        assert tile_policy.kernel_ms(s, heads)[key] == pytest.approx(t, rel=rel), n


def test_precedence_holds_for_bf16(monkeypatch):
    """Deterministic first, then the split pin, then a fused pin, then the
    model, at the train shape in bf16 (where the model picks fused)."""
    plan, params, _ = _bwd_mode_plan("train_docs_8192_bf16")
    for key in ("MAGI_ATTENTION_BACKEND_FFA_BWD", "MAGI_ATTENTION_FFA_FUSED_BWD",
                "MAGI_ATTENTION_DETERMINISTIC_MODE"):
        monkeypatch.delenv(key, raising=False)
    args = (plan, params, 128, 128, 2, 32, 8)
    assert ffa_bwd_mode(*args) == "fused"
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
    assert ffa_bwd_mode(*args) == "split"
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused")
    assert ffa_bwd_mode(*args) == "fused"
    monkeypatch.setenv("MAGI_ATTENTION_DETERMINISTIC_MODE", "1")
    assert ffa_bwd_mode(*args) == "split"
    monkeypatch.delenv("MAGI_ATTENTION_DETERMINISTIC_MODE")
    import dataclasses

    assert ffa_bwd_mode(plan, dataclasses.replace(params, deterministic=True), *args[2:]) == "split"


def _launch_names():
    """The library names ``_launch`` looks symbols up in, with the
    argument count each ctypes binding passes (the stream last)."""
    return {name: len(types) for name, types in port_ffa._ARGTYPES.items()}


def _extern_c(source: str) -> dict[str, int]:
    """``extern "C"`` functions of a CUDA source: name -> argument count."""
    found = {}
    for m in re.finditer(r'extern "C" \w+\*? (\w+)\(([^)]*)\)', source):
        found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


@pytest.mark.parametrize("name", sorted(_launch_names()))
def test_launch_symbols_are_exported(name):
    """``_launch(name, dtype, ...)`` calls ``<name>_f32`` or ``<name>_bf16``
    of ``csrc/<name>.cu``: both are ``extern "C"`` there, with the argument
    count the binding passes, and the source is one ``_build`` compiles;
    so are the convert pass and the shared-memory queries ``_lib`` binds."""
    assert name in _build.SOURCES
    src = (_build.CSRC / f"{name}.cu").read_text()
    exported = _extern_c(src)
    for suffix in ("f32", "bf16"):
        assert exported.get(f"{name}_{suffix}") == _launch_names()[name], (name, suffix)
    if name == "ffa_bwd_fused":
        assert exported.get("ffa_bwd_fused_convert") == 4
    assert exported.get(f"{name}_smem_bytes") == port_ffa._SMEM_ARGS.get(name)


def test_launch_names_are_the_lookups():
    """The names ``_launch`` is called with in ``kernels/ffa.py`` are the
    keys of ``_ARGTYPES`` (so the guard above covers every lookup)."""
    tree = ast.parse(Path(port_ffa.__file__).read_text())
    called = {
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_launch"
        and isinstance(node.args[0], ast.Constant)
    }
    assert called == set(port_ffa._ARGTYPES)


# ---------------------------------------------------------------------------
# the tensor cores' rounding, in plain PyTorch
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
ATOL, RNORM = 2e-2, 1e-2  # chip_smoke.py's bf16 bounds
S_TC, HQ, HK, D = 256, 4, 2, 64


def _rounding_masks():
    qr, kr, types = _sink_window(S_TC)
    return {
        "causal": MASKS["causal"],
        "uncovered": MASKS["uncovered"],
        "paged_prefill": MASKS["paged_prefill"],
        "docs": _typed([[0, 128], [128, 256]], [[0, 128], [128, 256]], [1, 1], 256, 256),
        "sink_window": _typed(qr, kr, types, S_TC, S_TC),
    }


def _inputs(name, seed):
    qr, kr, lo, hi, sq, sk = _rounding_masks()[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
        for shape in ((sq, HQ, D), (sk, HK, D), (sk, HK, D), (sq, HQ, D))
    )
    mask = build_dense_mask_band(qr, kr, lo, hi, sq, sk, device="cpu")
    return (qr, kr, lo, hi, sq, sk), (q, k, v, do), mask


def _tc_forward(q, k, v, mask, scale):
    """The tensor-core forward's arithmetic: float32 scores of bf16 inputs,
    the exp2-domain online softmax over 64-key tiles, P rounded to bf16
    before P V, float32 sums, out rounded to bf16."""
    g = q.shape[1] // k.shape[1]
    qf = q.float().transpose(0, 1)
    kf = k.float().repeat_interleave(g, 1).transpose(0, 1)
    vf = v.float().repeat_interleave(g, 1).transpose(0, 1)
    s = (qf @ kf.transpose(1, 2)) * (scale * LOG2E)
    s = s.masked_fill(~mask[None], -math.inf)
    hq, sq, sk = s.shape
    m = torch.full((hq, sq), -math.inf)
    l = torch.zeros((hq, sq))
    acc = torch.zeros((hq, sq, vf.shape[-1]))
    for k0 in range(0, sk, 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(st - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, k0:k0 + 64]
        m = m_new
    empty = l == 0
    out = torch.where(empty[..., None], 0.0, acc / l.clamp_min(1e-30)[..., None])
    lse = torch.where(empty, -math.inf, (m + torch.log2(l)) / LOG2E)
    return out.transpose(0, 1).bfloat16(), lse.T.contiguous()


def _hi_lo(x):
    """bf16 hi = bf16(x) and lo = bf16(x - hi), as float32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _tc_backward(q, k, v, do, lse, delta, mask, scale, split=True):
    """The tensor-core fused backward's arithmetic: float32 S^T and dP^T of
    bf16 inputs, P and dS in float32, then P^T as bf16 hi + lo for dV, dS
    as hi + lo for dK (``split``; else hi alone) and dS as hi for dQ,
    float32 sums."""
    g = q.shape[1] // k.shape[1]
    qf, dof = q.float().transpose(0, 1), do.float().transpose(0, 1)
    kf = k.float().repeat_interleave(g, 1).transpose(0, 1)
    vf = v.float().repeat_interleave(g, 1).transpose(0, 1)
    lse_t = lse.T[..., None]
    live = mask[None] & torch.isfinite(lse_t)
    s = (qf @ kf.transpose(1, 2)) * scale
    p = torch.where(live, torch.exp(s - torch.where(live, lse_t, 0.0)), 0.0)
    ds = p * (dof @ vf.transpose(1, 2) - delta.T[..., None])
    p_hi, p_lo = _hi_lo(p)
    ds_hi, ds_lo = _hi_lo(ds)
    if not split:
        p_lo, ds_lo = torch.zeros_like(p_lo), torch.zeros_like(ds_lo)
    dq = (ds_hi @ kf) * scale
    dk = (ds_hi.transpose(1, 2) @ qf + ds_lo.transpose(1, 2) @ qf) * scale
    dv = p_hi.transpose(1, 2) @ dof + p_lo.transpose(1, 2) @ dof
    sk = k.shape[0]

    def per_kv(x):  # [hq, sk, d] -> [sk, hk, d], summed over each group
        return x.transpose(0, 1).reshape(sk, k.shape[1], g, -1).sum(2)

    return dq.transpose(0, 1), per_kv(dk), per_kv(dv)


def _within_bounds(got, want, what):
    a, b = got.double(), want.double()
    max_abs = (a - b).abs().max().item()
    rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    assert max_abs <= ATOL and rel <= RNORM, (what, max_abs, rel)


@pytest.mark.parametrize("name", sorted(_rounding_masks()))
def test_tensor_core_forward_rounding_within_bounds(name):
    (qr, kr, lo, hi, _, _), (q, k, v, _), mask = _inputs(name, 11)
    scale = D ** -0.5
    out, lse = _tc_forward(q, k, v, mask, scale)
    want_out, want_lse = sdpa_attn(q.float(), k.float(), v.float(), qr, kr, d_lo=lo, d_hi=hi)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= ATOL
    _within_bounds(out.float(), want_out, f"{name} out")


@pytest.mark.parametrize("name", sorted(_rounding_masks()))
def test_tensor_core_backward_rounding_within_bounds(name):
    (qr, kr, lo, hi, sq, sk), (q, k, v, do), mask = _inputs(name, 13)
    scale = D ** -0.5
    plan, params = plan_params(qr, kr, None, lo, hi, sq, sk, D, scale, 0.0)
    args32 = [t.float() for t in (q, k, v, do)]
    out, lse = sdpa_attn(*args32[:3], qr, kr, d_lo=lo, d_hi=hi)
    delta = ffa_delta_plain(out, args32[3])
    want = ffa_bwd_fused_plain(*args32, lse, delta, plan, params)
    got = _tc_backward(q, k, v, do, lse, delta, mask, scale)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        _within_bounds(a, b, f"{name} {gname}")


def test_global_token_needs_the_lo_products():
    """A k row that every q row and head sees (64 global tokens before a
    64-key window, 8192 tokens, 4 q heads of one kv head, head_dim 128,
    the shape of chip_smoke.py's sink-window mask): its dk and dv sum 32768
    (row, head) terms. One bf16 rounding of dS and P leaves them more than
    1e-2 from float32 (2e-2 is chip_smoke.py's bound); the hi + lo products
    bring them within 1e-3. Only the 64 global k rows are computed."""
    S, g, d = 8192, 4, 128
    qr, kr, types = _sink_window(S)
    qr, kr, lo, hi, _, _ = _typed(qr, kr, types, S, S)
    mask = build_dense_mask_band(qr, kr, lo, hi, S, S, device="cpu")
    gen = torch.Generator().manual_seed(0)
    q, do = (torch.randn((S, g, d), generator=gen).bfloat16().float() for _ in range(2))
    k, v = (torch.randn((S, d), generator=gen).bfloat16().float() for _ in range(2))
    scale = d ** -0.5
    want, one, two = ([torch.zeros(64, d) for _ in range(2)] for _ in range(3))
    for h in range(g):
        s = (q[:, h] @ k.T) * scale
        s.masked_fill_(~mask, -math.inf)
        p = torch.softmax(s, -1)
        delta = ((p @ v).bfloat16().float() * do[:, h]).sum(-1)
        p = p[:, :64].contiguous()
        del s
        ds = p * (do[:, h] @ v[:64].T - delta[:, None])
        for acc, (pp, dd) in zip(
            (want, one, two),
            ((p, ds), (p.bfloat16().float(), ds.bfloat16().float()),
             (sum(_hi_lo(p)), sum(_hi_lo(ds)))),
        ):
            acc[0] += dd.T @ q[:, h] * scale
            acc[1] += pp.T @ do[:, h]
    err_one = max((a - b).abs().max().item() for a, b in zip(one, want))
    err_two = max((a - b).abs().max().item() for a, b in zip(two, want))
    assert err_one > 1e-2 and err_two < 1e-3, (err_one, err_two)


@pytest.mark.parametrize("mask", ["causal", "sink_window"])
def test_dq_one_rounding_holds_at_the_longest_rows(mask):
    """The tensor-core dq's rounding (csrc/ffa_bwd_dq_tc.cuh): float32 S
    and dP of bf16 inputs, dS rounded once to bf16 as the A operand of
    dQ = dS K, float32 sums. At the longest q rows chip_smoke.py's masks
    give it (causal 8192, whose last row sees 8192 keys; the sink window,
    64 global keys and a 64-key window) and the train shape's head_dim 128
    it stays within the bf16 bounds of the float32 dq, where dK and dV
    need the hi + lo products (test_global_token_needs_the_lo_products): a
    q row sums its own keys, at most sk terms of one head, not every row
    and head of a group. The last 256 q rows of 4 heads are computed; lse
    and delta come from the full rows, out rounded to bf16 as the forward
    emits it."""
    S, hq, d, n = 8192, 4, 128, 256
    if mask == "causal":
        qr, kr, types = [[0, S]], [[0, S]], [1]
    else:
        qr, kr, types = _sink_window(S)
    qr, kr, lo, hi, _, _ = _typed(qr, kr, types, S, S)
    live = build_dense_mask_band(qr, kr, lo, hi, S, S, device="cpu")[S - n:]
    gen = torch.Generator().manual_seed(1)
    q, do = (torch.randn((n, hq, d), generator=gen).bfloat16().float() for _ in range(2))
    k, v = (torch.randn((S, d), generator=gen).bfloat16().float() for _ in range(2))
    scale = d ** -0.5
    got, want = torch.zeros(n, hq, d), torch.zeros(n, hq, d)
    for h in range(hq):
        s = (q[:, h] @ k.T) * scale
        s.masked_fill_(~live, -math.inf)
        p = torch.softmax(s, -1)
        del s
        delta = ((p @ v).bfloat16().float() * do[:, h]).sum(-1)
        ds = p * (do[:, h] @ v.T - delta[:, None])
        want[:, h] = ds @ k * scale
        got[:, h] = ds.bfloat16().float() @ k * scale
    _within_bounds(got, want, f"{mask} dq")


@pytest.mark.parametrize(
    "g, d, heads",
    [(2, 64, 2), (4, 64, 2), (8, 64, 2), (3, 64, 1), (6, 64, 2), (2, 128, 2), (4, 128, 2), (8, 128, 2), (1, 128, 1)],
)
def test_bf16_dq_pack_heads_follow_the_tensor_core_budget(g, d, heads, monkeypatch):
    """bf16 packs a group's dq into one CTA of one warpgroup per head: 2
    heads at head_dim 64 and 128 (four warpgroups would leave 128
    registers a thread, where a dq thread holds its dQ accumulator, d / 2,
    beside S, dP and dS's fragments: 181 and 147 registers at one head in
    the build), within the shared-memory limit; float32 keeps the
    CUDA-core budget (4 heads at 64). The dispatch reads the dtype from
    q."""
    assert port_ffa.dq_pack_heads(g, d, d, 2) == heads
    assert port_ffa.dq_pack_smem_bytes(128, 2, 2) == 132_096
    assert port_ffa.dq_pack_smem_bytes(128, 1, 2) == 99_328
    if heads > 1:
        assert port_ffa.dq_pack_smem_bytes(d, heads, 2) <= port_ffa.SMEM_PER_CTA
    assert port_ffa.dq_pack_heads(4, 64, 64) == 4
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "1")
    assert port_ffa._use_gqa_pack_dq(g, d, d, 2) == (heads if g > 1 else 1)
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "0")
    assert port_ffa._use_gqa_pack_dq(g, d, d, 2) == 1


@pytest.mark.parametrize(
    "g, d, heads",
    [(2, 64, 2), (4, 64, 4), (8, 64, 4), (3, 64, 1), (2, 128, 2), (4, 128, 2), (8, 128, 2), (1, 128, 1)],
)
def test_bf16_pack_heads_follow_the_tensor_core_budget(g, d, heads, monkeypatch):
    """bf16 packs the heads of a group into one CTA of one warpgroup per
    head: 4 heads at head_dim 64, 2 at 128 (four warpgroups would leave 128
    registers a thread for an O accumulator of 64 and S, P beside it),
    within the shared-memory limit; float32 has its own 3xTF32 budget (2
    heads at 128). The dispatch reads the dtype from q."""
    assert port_ffa.fwd_pack_heads(g, d, d, 2) == heads
    if heads > 1:
        assert port_ffa.fwd_pack_smem_bytes(d, heads, 2) <= port_ffa.SMEM_PER_CTA
    assert port_ffa.fwd_pack_heads(4, 128, 128) == 2
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK", "1")
    assert port_ffa._use_gqa_pack(g, d, d, False, 2) == (heads if g > 1 else 1)
    assert port_ffa._use_gqa_pack(g, d, d, True, 2) == 1  # max-logits: unpacked
