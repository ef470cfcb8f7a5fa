"""Flex-flash-attention: the Hopper kernels behind a host plan.

The port's counterpart of the single-device surface of
``magiattention_tpu/kernels/ffa.py`` (``FFAParams``, ``default_blocks``,
``ffa_attn_with_plan``, ``ffa_attn``, the custom VJP ``_ffa_core`` and
``ffa_bwd_mode``). Slices are diagonal bands; the host plan
(:mod:`.ffa_plan`) lists the (q tile, k tile, slice) work items, q-major
for the forward and dq, k-major for dk/dv. Four CUDA kernels walk them:

- ``csrc/ffa_fwd.cu``: out and lse, one CTA per (q-tile run, q head);
- ``csrc/ffa_bwd_delta.cu``: delta = rowsum(dO * O);
- ``csrc/ffa_bwd_dq.cu``: dq over the q-major runs;
- ``csrc/ffa_bwd_dkv.cu``: dk, dv over the k-major runs, the GQA group
  looped inside the CTA (the split backward: atomic-free, deterministic).

Each kernel has a plain PyTorch version beside it (``sdpa_attn`` for the
forward, ``ffa_*_plain`` for the backward), which CPU tensors take. A CUDA
tensor launches the kernel or raises: a kernel that fails to build or
launch is an error, never a quiet switch to the plain version.

:class:`_FFACore` pairs the forward with the backward kernels as a
``torch.autograd.Function``; ``ffa_attn``/``ffa_attn_with_plan`` go
through it on CUDA, and stay the autograd-differentiable ``sdpa_attn`` on
the CPU. As in the JAX package, lse carries no gradient on either route
(the backward ignores its cotangent; the CPU route detaches it).
The TPU package's fused one-pass backward, mixed-granularity dispatch,
auto-tile policy, GQA-packed forward and max-logits output are not ported
yet (ROADMAP).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..env import backend as env_backend
from ..env import kernel as env_kernel
from . import _build
from .ffa_plan import DHI, DLO, KE, KS, QE, QS, FFAPlan, get_ffa_plan
from .mask_utils import build_dense_mask_band, types_to_bands
from .sdpa import sdpa_attn

# the one tile shape the csrc/ffa_*.cu kernels are compiled for
KERNEL_BLOCKS = (64, 64)
KERNEL_HEAD_DIMS = (64, 128)


@dataclass(frozen=True)
class FFAParams:
    """Static kernel parameters of one plan."""

    num_q_tiles: int
    num_k_tiles: int
    block_q: int
    block_k: int
    softmax_scale: float
    softcap: float


def default_blocks(sq: int, sk: int, block_q=None, block_k=None) -> tuple[int, int]:
    """Tile sizes of a plan: the caller's, else the env's (Hopper defaults
    64 x 64). The TPU package rounds small sequences down to 16/128-row
    tiles; the CUDA kernel's tiles are compile-time, so the port keeps the
    requested size and the kernel masks the ragged edge."""
    return block_q or env_kernel.ffa_block_q(), block_k or env_kernel.ffa_block_k()


def plan_params(
    q_ranges, k_ranges, attn_type_map, d_lo, d_hi, sq: int, sk: int, d: int,
    softmax_scale: float | None, softcap: float,
    block_q: int | None = None, block_k: int | None = None,
) -> tuple[FFAPlan, FFAParams]:
    """The (cached) plan of host slice metadata, and its kernel params.
    Slices are mask types (``attn_type_map``, None = all FULL) unless
    explicit bands ``d_lo``/``d_hi`` are given."""
    qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
    if d_lo is None or d_hi is None:
        tm = (
            np.zeros(len(qr), dtype=np.int32)
            if attn_type_map is None
            else np.asarray(attn_type_map, dtype=np.int32)
        )
        d_lo, d_hi = types_to_bands(qr, kr, tm)
    bq, bk = default_blocks(sq, sk, block_q, block_k)
    plan = get_ffa_plan(qr, kr, d_lo, d_hi, sq, sk, bq, bk)
    params = FFAParams(
        num_q_tiles=plan.num_q_tiles,
        num_k_tiles=plan.num_k_tiles,
        block_q=bq,
        block_k=bk,
        softmax_scale=float(d) ** -0.5 if softmax_scale is None else float(softmax_scale),
        softcap=float(softcap),
    )
    return plan, params


# ---------------------------------------------------------------------------
# the CUDA kernels (ctypes launchers)
# ---------------------------------------------------------------------------

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_ARGTYPES = {
    # q k v out lse | work_kt meta run_ptr | sq sk hq hk d nqt | scale cap | stream
    "ffa_fwd": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    # out do delta | rows d | stream
    "ffa_bwd_delta": [_P] * 3 + [_L, _I, _P],
    # q k v do lse delta dq | work_kt meta run_ptr | sq sk hq hk d nqt | ...
    "ffa_bwd_dq": [_P] * 10 + [_I] * 6 + [_F, _F, _P],
    # q k v do lse delta dk dv | work_qt_t meta_t run_ptr_t | ... nkt | ...
    "ffa_bwd_dkv": [_P] * 11 + [_I] * 6 + [_F, _F, _P],
}


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    lib = _lib(name)
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}")
    code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, f"{name}_kernel")


def _kernel_inputs(name, params: FFAParams, q, k, v, *rest) -> list[torch.Tensor]:
    """Check what the FFA kernels take and return ``[q, k, v, *rest]``
    contiguous in q's dtype (``rest``: tensors shaped like q, e.g. dO)."""
    sq, hq, d = q.shape
    sk, hk, dv = v.shape
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *rest))):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if (params.block_q, params.block_k) != KERNEL_BLOCKS:
        raise ValueError(
            f"{name} is compiled for blocks {KERNEL_BLOCKS}, "
            f"plan has ({params.block_q}, {params.block_k})"
        )
    if d != dv or d not in KERNEL_HEAD_DIMS or hq % hk:
        raise ValueError(
            f"{name}: head dims d={d}, dv={dv} (need equal, one of "
            f"{KERNEL_HEAD_DIMS}) and hq={hq} a multiple of hk={hk}"
        )
    if params.num_q_tiles * params.block_q < sq or params.num_k_tiles * params.block_k < sk:
        raise ValueError("plan tiles do not cover the sequences")
    if any(t.shape != q.shape for t in rest):
        raise ValueError(f"{name}: dO must have q's shape {tuple(q.shape)}")
    out = [q.contiguous()] + [t.to(q.dtype).contiguous() for t in (k, v, *rest)]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    return out


def _row_stats(q: torch.Tensor, *stats: torch.Tensor) -> list[torch.Tensor]:
    """lse/delta as contiguous float32 ``[sq, hq]`` on q's device."""
    want = tuple(q.shape[:2])
    if any(tuple(s.shape) != want or s.device != q.device for s in stats):
        raise ValueError(f"lse and delta must be [sq, hq] = {want} on {q.device}")
    return [s.float().contiguous() for s in stats]


def ffa_fwd_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: FFAPlan,
    params: FFAParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ffa_fwd.cu`` on CUDA tensors ``q [sq, hq, d]``,
    ``k/v [sk, hk, d]`` of one dtype (float32 or bfloat16). Returns
    (out ``[sq, hq, d]`` in q's dtype, lse ``[sq, hq]`` float32). Adds one
    to ``ffa_fwd_kernel.launches`` per launch."""
    q, k, v = _kernel_inputs("ffa_fwd_kernel", params, q, k, v)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((sq, hq), dtype=torch.float32, device=q.device)
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    _launch(
        "ffa_fwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), work_kt.data_ptr(), meta.data_ptr(),
        run_ptr.data_ptr(), sq, sk, hq, hk, d, params.num_q_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_fwd_kernel.launches += 1
    return out, lse


def ffa_delta_kernel(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ffa_bwd_delta.cu``: delta ``[sq, hq]`` float32 =
    rowsum(dO * O) of CUDA tensors ``out/do [sq, hq, dv]`` (do is cast to
    out's dtype, float32 or bfloat16). Adds one to
    ``ffa_delta_kernel.launches`` per launch."""
    if not (out.is_cuda and do.device == out.device):
        raise ValueError("ffa_delta_kernel takes CUDA tensors on one device")
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffa_delta_kernel: dtype {out.dtype} not supported")
    if do.shape != out.shape or out.dim() != 3:
        raise ValueError("ffa_delta_kernel: out and do must be [sq, hq, dv]")
    out = out.contiguous()
    do = do.to(out.dtype).contiguous()
    sq, hq, dv = out.shape
    if (dv * out.element_size()) % 16 or out.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("ffa_delta_kernel needs 16-byte aligned rows")
    delta = torch.empty((sq, hq), dtype=torch.float32, device=out.device)
    _launch(
        "ffa_bwd_delta", out.dtype, out.device,
        out.data_ptr(), do.data_ptr(), delta.data_ptr(), sq * hq, dv,
    )
    ffa_delta_kernel.launches += 1
    return delta


def ffa_bwd_dq_kernel(
    q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams
) -> torch.Tensor:
    """Launch ``csrc/ffa_bwd_dq.cu`` over the plan's q-major runs. Takes the
    forward's inputs, dO ``[sq, hq, d]``, lse and delta ``[sq, hq]``;
    returns dq ``[sq, hq, d]`` float32. Adds one to
    ``ffa_bwd_dq_kernel.launches`` per launch."""
    q, k, v, do = _kernel_inputs("ffa_bwd_dq_kernel", params, q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    _launch(
        "ffa_bwd_dq", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        work_kt.data_ptr(), meta.data_ptr(), run_ptr.data_ptr(),
        sq, sk, hq, hk, d, params.num_q_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_bwd_dq_kernel.launches += 1
    return dq


def ffa_bwd_dkv_kernel(
    q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ffa_bwd_dkv.cu`` over the plan's k-major runs, one CTA
    per (k tile, kv head) looping the GQA group. Returns (dk, dv)
    ``[sk, hk, d]`` float32, per kv head. Adds one to
    ``ffa_bwd_dkv_kernel.launches`` per launch."""
    q, k, v, do = _kernel_inputs("ffa_bwd_dkv_kernel", params, q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    work_qt_t, meta_t, run_ptr_t = plan.device_arrays_t(q.device)
    _launch(
        "ffa_bwd_dkv", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        work_qt_t.data_ptr(), meta_t.data_ptr(), run_ptr_t.data_ptr(),
        sq, sk, hq, hk, d, params.num_k_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_bwd_dkv_kernel.launches += 1
    return dk, dv


for _kernel in (ffa_fwd_kernel, ffa_delta_kernel, ffa_bwd_dq_kernel, ffa_bwd_dkv_kernel):
    _kernel.launches = 0


# ---------------------------------------------------------------------------
# plain versions of the backward kernels (dense, float32)
# ---------------------------------------------------------------------------


def _plan_slices(plan: FFAPlan):
    """The (merged) band slices a plan covers, read back from its items."""
    meta = plan.meta
    real = meta[meta[:, QE] > meta[:, QS]]
    cols = np.unique(real[:, [QS, QE, KS, KE, DLO, DHI]], axis=0)
    return cols[:, 0:2], cols[:, 2:4], cols[:, 4], cols[:, 5]


def ffa_delta_plain(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ffa_delta_kernel`."""
    ffa_delta_plain.calls += 1
    return (out.float() * do.float()).sum(-1)


def _bwd_dense(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """P and dS ``[hq, sq, sk]`` float32 of the plan's mask, with k
    repeated over the GQA group: the arithmetic of the dq and dkv kernels
    written densely (P = exp(s - lse), 0 off the mask and on rows with
    lse = -inf; dS = P * (dP - delta), times 1 - tanh^2 under a softcap)."""
    sq, hq, _ = q.shape
    sk, hk, _ = k.shape
    g = hq // hk
    qr, kr, lo, hi = _plan_slices(plan)
    mask = build_dense_mask_band(qr, kr, lo, hi, sq, sk, device=q.device)
    kf = k.float().repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), kf).mul_(params.softmax_scale)
    dcap = None
    if params.softcap > 0.0:
        t = torch.tanh(s / params.softcap)
        s = t * params.softcap
        dcap = 1.0 - t * t
        del t
    lse_t = lse.float().T[..., None]  # [hq, sq, 1]
    finite = torch.isfinite(lse_t)
    p = s.sub_(torch.where(finite, lse_t, 0.0)).exp_()
    p.masked_fill_(~(mask[None] & finite), 0.0)
    dp = torch.einsum("qhd,khd->hqk", do.float(), v.float().repeat_interleave(g, dim=1))
    ds = dp.sub_(delta.float().T[..., None]).mul_(p)
    if dcap is not None:
        ds.mul_(dcap)
    return p, ds, kf, g


def ffa_bwd_dq_plain(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """Plain version of :func:`ffa_bwd_dq_kernel`: dq ``[sq, hq, d]``
    float32."""
    ffa_bwd_dq_plain.calls += 1
    _, ds, kf, _ = _bwd_dense(q, k, v, do, lse, delta, plan, params)
    return torch.einsum("hqk,khd->qhd", ds, kf).mul_(params.softmax_scale)


def ffa_bwd_dkv_plain(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """Plain version of :func:`ffa_bwd_dkv_kernel`: (dk, dv)
    ``[sk, hk, d]`` float32, summed over each kv head's query group."""
    ffa_bwd_dkv_plain.calls += 1
    p, ds, _, g = _bwd_dense(q, k, v, do, lse, delta, plan, params)
    sk, hk, d = k.shape
    dk = torch.einsum("hqk,qhd->khd", ds, q.float()).mul_(params.softmax_scale)
    dv = torch.einsum("hqk,qhd->khd", p, do.float())
    return (
        dk.reshape(sk, hk, g, d).sum(2),
        dv.reshape(sk, hk, g, v.shape[-1]).sum(2),
    )


for _plain in (ffa_delta_plain, ffa_bwd_dq_plain, ffa_bwd_dkv_plain):
    _plain.calls = 0


# ---------------------------------------------------------------------------
# device routing: a CUDA tensor launches the kernel, a CPU tensor takes the
# plain version
# ---------------------------------------------------------------------------


def ffa_fwd(q, k, v, plan: FFAPlan, params: FFAParams):
    """(out, lse) over a plan: the kernel on CUDA, ``sdpa_attn`` over the
    plan's slices on the CPU."""
    if q.is_cuda:
        return ffa_fwd_kernel(q, k, v, plan, params)
    qr, kr, lo, hi = _plan_slices(plan)
    return sdpa_attn(
        q, k, v, qr, kr, softmax_scale=params.softmax_scale,
        softcap=params.softcap, d_lo=lo, d_hi=hi,
    )


def ffa_delta(out, do):
    return ffa_delta_kernel(out, do) if out.is_cuda else ffa_delta_plain(out, do)


def ffa_bwd_dq(q, k, v, do, lse, delta, plan, params):
    fn = ffa_bwd_dq_kernel if q.is_cuda else ffa_bwd_dq_plain
    return fn(q, k, v, do, lse, delta, plan, params)


def ffa_bwd_dkv(q, k, v, do, lse, delta, plan, params):
    fn = ffa_bwd_dkv_kernel if q.is_cuda else ffa_bwd_dkv_plain
    return fn(q, k, v, do, lse, delta, plan, params)


def ffa_bwd_mode() -> str:
    """The backward's execution mode: always "split" (delta, then dq over
    the q-major plan, then dk/dv over the k-major plan; atomic-free and
    deterministic). A ``fused`` pin (MAGI_ATTENTION_BACKEND_FFA_BWD, or the
    legacy MAGI_ATTENTION_FFA_FUSED_BWD=1) raises: the fused one-pass
    kernels need fp32 atomics on a GPU and are not ported yet."""
    if env_backend.ffa_bwd_pin() == "fused":
        raise NotImplementedError(
            "the fused FFA backward is not ported yet (ROADMAP queue B, "
            "_bwd_fused_kernel[_gqa]); unset the fused pin to run split"
        )
    return "split"


class _FFACore(torch.autograd.Function):
    """FFA forward + split backward over one plan (the port's ``_ffa_core``).

    Saves q, k, v, out and lse. The backward runs delta, then dq, then
    dk/dv, each through :func:`ffa_delta`/:func:`ffa_bwd_dq`/
    :func:`ffa_bwd_dkv` (kernels on CUDA, plain versions on the CPU), and
    returns gradients in the input dtypes (the kernels emit float32). lse
    is an auxiliary output: its cotangent is ignored, as in the JAX
    package."""

    @staticmethod
    def forward(ctx, q, k, v, plan: FFAPlan, params: FFAParams):
        out, lse = ffa_fwd(q, k, v, plan, params)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan, ctx.params = plan, params
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        ffa_bwd_mode()
        q, k, v, out, lse = ctx.saved_tensors
        plan, params = ctx.plan, ctx.params
        delta = ffa_delta(out, dout)
        dq = ffa_bwd_dq(q, k, v, dout, lse, delta, plan, params)
        dk, dv = ffa_bwd_dkv(q, k, v, dout, lse, delta, plan, params)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ffa_attn_with_plan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: FFAPlan,
    params: FFAParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FFA over an explicit plan, differentiable.

    Args:
        q/k/v: ``[sq,hq,d] / [sk,hk,d] / [sk,hk,dv]``, seq-major.
        plan: the host work list (its device arrays are cached on it).
        params: static dims + scalars; sq/sk must fit the tile counts.

    Returns (out ``[sq,hq,dv]``, lse ``[sq,hq]`` float32).
    """
    if q.is_cuda:
        return _FFACore.apply(q, k, v, plan, params)
    out, lse = ffa_fwd(q, k, v, plan, params)
    return out, lse.detach()


def ffa_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map=None,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    block_q: int | None = None,
    block_k: int | None = None,
    d_lo=None,
    d_hi=None,
):
    """FFA over slice metadata. Same contract as :func:`~.sdpa.sdpa_attn`,
    differentiable in q, k and v.

    Slices may be given as mask types (``attn_type_map``) or directly as
    diagonal bands (``d_lo``/``d_hi``). The metadata must be host values —
    it builds the plan. CUDA tensors run the kernels through
    :class:`_FFACore`; CPU tensors run :func:`~.sdpa.sdpa_attn` (autograd).
    lse carries no gradient on either route, as in the JAX package.

    Returns (out ``[sq,hq,dv]`` in q's dtype, lse ``[sq,hq]`` float32,
    natural log, ``-inf`` on rows no slice covers, whose out is 0).
    """
    if not q.is_cuda:
        qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
        kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
        out, lse = sdpa_attn(
            q, k, v, qr, kr, attn_type_map, softmax_scale=softmax_scale,
            softcap=softcap, d_lo=d_lo, d_hi=d_hi,
        )
        return out, lse.detach()
    plan, params = plan_params(
        q_ranges, k_ranges, attn_type_map, d_lo, d_hi, q.shape[0],
        k.shape[0], q.shape[-1], softmax_scale, softcap, block_q, block_k,
    )
    return _FFACore.apply(q, k, v, plan, params)
