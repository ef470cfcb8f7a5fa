"""Paged decode attention straight from the pages: one query row per slot,
speculative verify (spec_k draft rows per slot) and int8 pages.

The port's counterpart of ``paged_decode_attn``, ``paged_decode_attn_spec``
and ``paged_decode_attn_int8`` in ``magiattention_tpu/kernels/paged_decode.py``.
A CUDA tensor launches the matching kernel (``csrc/paged_decode.cu``,
``csrc/paged_decode_spec.cu``, ``csrc/paged_decode_int8.cu``: one body,
``csrc/paged_decode.cuh``, one CTA per (kv head, slot), lengths and page
table read on the device, so one launch serves every tick); a CPU tensor
takes the plain version. There is no other route: a kernel that fails to
build or launch raises.

The head-sharded variant of the TPU module is not ported (ROADMAP).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .paged_kv import PagedKVCache

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8  # GMAX in csrc/paged_decode.cu and paged_decode_int8.cu
KERNEL_MAX_SPEC_ROWS = 32  # largest RMAX in csrc/paged_decode_spec.cu


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "paged_decode":
        fns, args = (lib.paged_decode_f32, lib.paged_decode_bf16), [
            p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    elif name == "paged_decode_spec":
        fns, args = (lib.paged_decode_spec_f32, lib.paged_decode_spec_bf16), [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
    else:
        fns, args = (lib.paged_decode_int8_f32, lib.paged_decode_int8_bf16), [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    for fn in fns:
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check_launch(what: str, q: torch.Tensor, cache: PagedKVCache, rows: int,
                  page_dtype: torch.dtype, max_rows: int) -> None:
    """What every paged-decode kernel takes; raises before any launch."""
    S = q.shape[0]
    hq, d = q.shape[-2:]
    num_pages, ps, hk, dv = cache.v_pages.shape
    if not (q.is_cuda and cache.k_pages.device == q.device):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {q.dtype} not supported")
    if cache.k_pages.dtype != page_dtype or cache.v_pages.dtype != page_dtype:
        raise TypeError(f"{what}: pages must be {page_dtype}")
    if d != dv or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dims d={d}, dv={dv}")
    if hq % hk or rows > max_rows:
        raise ValueError(
            f"{what}: hq={hq} must be a multiple of hk={hk}, with at most "
            f"{max_rows} query rows per kv head (got {rows})"
        )
    if cache.page_table.shape[0] != S or cache.lengths.shape != (S,):
        raise ValueError(f"{what}: one query block per cache slot")
    tensors = [q, cache.k_pages, cache.v_pages, cache.page_table, cache.lengths]
    if cache.quantized:
        tensors += [cache.k_scales, cache.v_scales]
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous, aligned tensors")
    if cache.page_table.dtype != torch.int32 or cache.lengths.dtype != torch.int32:
        raise TypeError(f"{what}: table and lengths must be int32")


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def paged_decode_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode.cu``: ``q (S, hq, d)`` CUDA tensor of the
    pages' dtype (float32 or bfloat16). Adds one to
    ``paged_decode_kernel.launches`` per launch."""
    q = q.contiguous()
    S, hq, d = q.shape
    num_pages, ps, hk, _ = cache.v_pages.shape
    _check_launch("paged_decode_kernel", q, cache, hq // hk, q.dtype,
                  KERNEL_MAX_GROUP)
    out = torch.empty_like(q)
    lse = torch.empty((S, hq), dtype=torch.float32, device=q.device)
    lib = _lib("paged_decode")
    fn = lib.paged_decode_f32 if q.dtype == torch.float32 else lib.paged_decode_bf16
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), S, hq, hk, d, ps,
        cache.page_table.shape[1], softmax_scale, _stream(q),
    )
    _build.check(lib, code, "paged_decode_kernel")
    paged_decode_kernel.launches += 1
    return out, lse


paged_decode_kernel.launches = 0


def paged_decode_spec_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode_spec.cu``: ``q (S, spec_k, hq, d)`` CUDA
    tensor of the pages' dtype, ``spec_k * hq / hk <= 32``. Adds one to
    ``paged_decode_spec_kernel.launches`` per launch."""
    q = q.contiguous()
    S, spec_k, hq, d = q.shape
    num_pages, ps, hk, _ = cache.v_pages.shape
    if spec_k < 1:
        raise ValueError(f"spec_k={spec_k} must be >= 1")
    _check_launch("paged_decode_spec_kernel", q, cache, spec_k * (hq // hk),
                  q.dtype, KERNEL_MAX_SPEC_ROWS)
    out = torch.empty_like(q)
    lse = torch.empty((S, spec_k, hq), dtype=torch.float32, device=q.device)
    lib = _lib("paged_decode_spec")
    fn = (lib.paged_decode_spec_f32 if q.dtype == torch.float32
          else lib.paged_decode_spec_bf16)
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), S, spec_k, hq, hk, d, ps,
        cache.page_table.shape[1], softmax_scale, _stream(q),
    )
    _build.check(lib, code, "paged_decode_spec_kernel")
    paged_decode_spec_kernel.launches += 1
    return out, lse


paged_decode_spec_kernel.launches = 0


def paged_decode_int8_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode_int8.cu``: ``q (S, hq, d)`` CUDA tensor
    (float32 or bfloat16) over an int8 cache with its scales. Adds one to
    ``paged_decode_int8_kernel.launches`` per launch."""
    if not cache.quantized:
        raise ValueError("paged_decode_int8_kernel needs an int8 cache")
    q = q.contiguous()
    S, hq, d = q.shape
    num_pages, ps, hk, _ = cache.v_pages.shape
    _check_launch("paged_decode_int8_kernel", q, cache, hq // hk, torch.int8,
                  KERNEL_MAX_GROUP)
    if cache.k_scales.dtype != torch.float32 or cache.v_scales.dtype != torch.float32:
        raise TypeError("paged_decode_int8_kernel: scales must be float32")
    out = torch.empty_like(q)
    lse = torch.empty((S, hq), dtype=torch.float32, device=q.device)
    lib = _lib("paged_decode_int8")
    fn = (lib.paged_decode_int8_f32 if q.dtype == torch.float32
          else lib.paged_decode_int8_bf16)
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.k_scales.data_ptr(), cache.v_scales.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), S, hq, hk, d, ps,
        cache.page_table.shape[1], softmax_scale, _stream(q),
    )
    _build.check(lib, code, "paged_decode_int8_kernel")
    paged_decode_int8_kernel.launches += 1
    return out, lse


paged_decode_int8_kernel.launches = 0


def _plain_pages(cache: PagedKVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """Every slot's pages gathered (-1 entries clamp to page 0) as float32
    ``(S, P * ps, hk, d)`` K and V, dequantized on an int8 cache."""
    S, P = cache.page_table.shape
    num_pages, ps, hk, d = cache.k_pages.shape
    table = cache.page_table.clamp_min(0).long()  # (S, P)
    k = cache.k_pages[table].float()  # (S, P, ps, hk, d)
    v = cache.v_pages[table].float()
    if cache.quantized:
        k = k * cache.k_scales[table][:, :, None, :, None]
        v = v * cache.v_scales[table][:, :, None, :, None]
    return k.reshape(S, P * ps, hk, d), v.reshape(S, P * ps, hk, -1)


def _plain_attend(q, k, v, limits, softmax_scale):
    """Softmax attention in float32 of ``q (S, T, hq, d)`` over ``k/v (S, L,
    hk, d)``, row (s, t) over columns ``< limits[s, t]``; empty rows give
    (0, -inf). Returns out ``(S, T, hq, dv)`` in q's dtype, lse ``(S, T,
    hq)``."""
    S, T, hq, d = q.shape
    L, hk, dv = v.shape[1:]
    g = hq // hk
    qf = q.float().reshape(S, T, hk, g, d)
    scores = torch.einsum("sthgd,slhd->sthgl", qf, k) * softmax_scale
    cols = torch.arange(L, device=q.device)
    live = cols[None, None, :] < limits[:, :, None]  # (S, T, L)
    scores = scores.masked_fill(~live[:, :, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m.isfinite(), m, 0.0)
    p = torch.exp(scores - m_safe)  # exactly 0 on masked rows
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    out = torch.einsum("sthgl,slhd->sthgd", p, v) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, float("-inf"), m_safe + torch.log(l))
    return out.reshape(S, T, hq, dv).to(q.dtype), lse.reshape(S, T, hq)


def paged_decode_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`paged_decode_attn`: gather every slot's
    pages, mask rows at or past the slot's length, softmax in float32.
    Counts its calls in ``paged_decode_plain.calls``."""
    paged_decode_plain.calls += 1
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    k, v = _plain_pages(cache)
    limits = cache.lengths.long()[:, None]
    out, lse = _plain_attend(q[:, None], k, v, limits, softmax_scale)
    return out[:, 0], lse[:, 0]


paged_decode_plain.calls = 0


def paged_decode_spec_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`paged_decode_attn_spec`: draft token t of
    slot s attends columns ``< lengths[s] - (spec_k - 1 - t)``. Counts its
    calls in ``paged_decode_spec_plain.calls``."""
    paged_decode_spec_plain.calls += 1
    S, spec_k = q.shape[:2]
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    k, v = _plain_pages(cache)
    t = torch.arange(spec_k, device=q.device)
    limits = cache.lengths.long()[:, None] - (spec_k - 1 - t)[None, :]
    return _plain_attend(q, k, v, limits, softmax_scale)


paged_decode_spec_plain.calls = 0


def paged_decode_int8_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`paged_decode_attn_int8`: the pages
    dequantized (code * scale) to float32, then :func:`paged_decode_plain`'s
    arithmetic. Counts its calls in ``paged_decode_int8_plain.calls``."""
    paged_decode_int8_plain.calls += 1
    if not cache.quantized:
        raise ValueError("paged_decode_int8_plain needs an int8 cache")
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    k, v = _plain_pages(cache)
    limits = cache.lengths.long()[:, None]
    out, lse = _plain_attend(q[:, None], k, v, limits, softmax_scale)
    return out[:, 0], lse[:, 0]


paged_decode_int8_plain.calls = 0


def paged_decode_attn(
    q: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched decode step: each slot's single query token attends over
    its own paged KV rows ``[0, lengths[slot])``.

    Args:
        q: ``(max_seqs, hq, d)`` — one query row per slot. Slots with
            ``lengths == 0`` are inactive and yield (out=0, lse=-inf).
        cache: the paged cache after this step's k/v rows were appended.
        softmax_scale: defaults to ``d ** -0.5``.

    Returns:
        (out ``(max_seqs, hq, dv)`` in q's dtype, lse ``(max_seqs, hq)``
        float32, ``-inf`` on inactive slots).
    """
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return paged_decode_kernel(q, cache, float(softmax_scale))
    return paged_decode_plain(q, cache, softmax_scale)


def paged_decode_attn_spec(
    q: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify step: each slot's ``spec_k`` draft-token query
    rows (already appended to the cache, so ``lengths`` includes them)
    attend their own causal prefixes in one launch.

    Args:
        q: ``(max_seqs, spec_k, hq, d)`` — draft token ``t`` of a slot sits
            at absolute position ``lengths[slot] - spec_k + t``. Rows with
            no live column (inactive slots, slots shorter than spec_k)
            yield (out=0, lse=-inf). The kernel takes at most 32 rows per
            kv head (``spec_k * hq / hk``).

    Returns:
        (out ``(max_seqs, spec_k, hq, dv)`` in q's dtype,
        lse ``(max_seqs, spec_k, hq)`` float32).
    """
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return paged_decode_spec_kernel(q, cache, float(softmax_scale))
    return paged_decode_spec_plain(q, cache, softmax_scale)


def paged_decode_attn_int8(
    q: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched decode step over an int8 cache (``PagedKVCache.create(
    ..., dtype=torch.int8)``). Same contract as :func:`paged_decode_attn`."""
    if not cache.quantized:
        raise ValueError(
            "paged_decode_attn_int8 needs a quantized cache "
            "(PagedKVCache.create(..., dtype=torch.int8))"
        )
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return paged_decode_int8_kernel(q, cache, float(softmax_scale))
    return paged_decode_int8_plain(q, cache, softmax_scale)
