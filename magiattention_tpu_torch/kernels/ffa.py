"""Flex-flash-attention forward: the Hopper kernel behind a host plan.

The port's counterpart of the forward surface of
``magiattention_tpu/kernels/ffa.py`` (``FFAParams``, ``default_blocks``,
``ffa_attn_with_plan``, ``ffa_attn``). Slices are diagonal bands; the host
plan (:mod:`.ffa_plan`) lists the (q tile, k tile, slice) work items and the
CUDA kernel ``csrc/ffa_fwd.cu`` walks them, one CTA per (q-tile run, head).

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
:func:`~.sdpa.sdpa_attn`. There is no other route: a kernel that fails to
build or launch raises.

Forward only. The backward kernels (ROADMAP queue B items 3-9) are not
ported, so calling with inputs that require grad raises
``NotImplementedError`` rather than returning outputs without a gradient.
The TPU package's mixed-granularity dispatch, auto-tile policy, GQA-packed
forward and max-logits output are not on the serving path and are not
ported yet (ROADMAP).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..env import kernel as env_kernel
from . import _build
from .ffa_plan import DHI, DLO, KE, KS, QE, QS, FFAPlan, get_ffa_plan
from .mask_utils import types_to_bands
from .sdpa import sdpa_attn

# the one tile shape csrc/ffa_fwd.cu is compiled for
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


def _check_no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ffa_attn is forward only in the port: the FFA backward kernels "
            "(ROADMAP queue B items 3-9) are not ported yet"
        )


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("ffa_fwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.ffa_fwd_f32, lib.ffa_fwd_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return lib


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
    sq, hq, d = q.shape
    sk, hk, dv = v.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("ffa_fwd_kernel takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffa_fwd_kernel: dtype {q.dtype} not supported")
    if (params.block_q, params.block_k) != KERNEL_BLOCKS:
        raise ValueError(
            f"ffa_fwd_kernel is compiled for blocks {KERNEL_BLOCKS}, "
            f"plan has ({params.block_q}, {params.block_k})"
        )
    if d != dv or d not in KERNEL_HEAD_DIMS or hq % hk:
        raise ValueError(
            f"ffa_fwd_kernel: head dims d={d}, dv={dv} (need equal, one of "
            f"{KERNEL_HEAD_DIMS}) and hq={hq} a multiple of hk={hk}"
        )
    if params.num_q_tiles * params.block_q < sq or params.num_k_tiles * params.block_k < sk:
        raise ValueError("plan tiles do not cover the sequences")
    q = q.contiguous()
    k = k.to(q.dtype).contiguous()
    v = v.to(q.dtype).contiguous()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("ffa_fwd_kernel needs 16-byte aligned tensors")
    out = torch.empty_like(q)
    lse = torch.empty((sq, hq), dtype=torch.float32, device=q.device)
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    lib = _lib()
    fn = lib.ffa_fwd_f32 if q.dtype == torch.float32 else lib.ffa_fwd_bf16
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), work_kt.data_ptr(), meta.data_ptr(),
        run_ptr.data_ptr(), sq, sk, hq, hk, d, params.num_q_tiles,
        params.softmax_scale, params.softcap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "ffa_fwd_kernel")
    ffa_fwd_kernel.launches += 1
    return out, lse


ffa_fwd_kernel.launches = 0


def _plan_slices(plan: FFAPlan):
    """The (merged) band slices a plan covers, read back from its items."""
    meta = plan.meta
    real = meta[meta[:, QE] > meta[:, QS]]
    cols = np.unique(real[:, [QS, QE, KS, KE, DLO, DHI]], axis=0)
    return cols[:, 0:2], cols[:, 2:4], cols[:, 4], cols[:, 5]


def ffa_attn_with_plan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: FFAPlan,
    params: FFAParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FFA over an explicit plan.

    Args:
        q/k/v: ``[sq,hq,d] / [sk,hk,d] / [sk,hk,dv]``, seq-major.
        plan: the host work list (its device arrays are cached on it).
        params: static dims + scalars; sq/sk must fit the tile counts.

    Returns (out ``[sq,hq,dv]``, lse ``[sq,hq]`` float32).
    """
    _check_no_grad(q, k, v)
    if q.is_cuda:
        return ffa_fwd_kernel(q, k, v, plan, params)
    qr, kr, lo, hi = _plan_slices(plan)
    return sdpa_attn(
        q, k, v, qr, kr, softmax_scale=params.softmax_scale,
        softcap=params.softcap, d_lo=lo, d_hi=hi,
    )


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
    """FFA over slice metadata. Same contract as :func:`~.sdpa.sdpa_attn`.

    Slices may be given as mask types (``attn_type_map``) or directly as
    diagonal bands (``d_lo``/``d_hi``). The metadata must be host values —
    it builds the plan. CUDA tensors run the kernel; CPU tensors run
    :func:`~.sdpa.sdpa_attn`.

    Returns (out ``[sq,hq,dv]`` in q's dtype, lse ``[sq,hq]`` float32,
    natural log, ``-inf`` on rows no slice covers, whose out is 0).
    """
    _check_no_grad(q, k, v)
    qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
    if d_lo is None or d_hi is None:
        tm = (
            np.zeros(len(qr), dtype=np.int32)
            if attn_type_map is None
            else np.asarray(attn_type_map, dtype=np.int32)
        )
        d_lo, d_hi = types_to_bands(qr, kr, tm)
    else:
        d_lo = np.asarray(d_lo, dtype=np.int32)
        d_hi = np.asarray(d_hi, dtype=np.int32)

    sq, sk, d = q.shape[0], k.shape[0], q.shape[-1]
    if softmax_scale is None:
        softmax_scale = float(d) ** -0.5
    if not q.is_cuda:
        return sdpa_attn(
            q, k, v, qr, kr, softmax_scale=softmax_scale, softcap=softcap,
            d_lo=d_lo, d_hi=d_hi,
        )
    bq, bk = default_blocks(sq, sk, block_q, block_k)
    plan = get_ffa_plan(qr, kr, d_lo, d_hi, sq, sk, bq, bk)
    params = FFAParams(
        num_q_tiles=plan.num_q_tiles,
        num_k_tiles=plan.num_k_tiles,
        block_q=bq,
        block_k=bk,
        softmax_scale=float(softmax_scale),
        softcap=float(softcap),
    )
    return ffa_fwd_kernel(q, k, v, plan, params)
