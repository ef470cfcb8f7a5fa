"""Paged decode attention: one query row per slot, straight from the pages.

The port's counterpart of ``paged_decode_attn`` in
``magiattention_tpu/kernels/paged_decode.py``. A CUDA tensor launches
``csrc/paged_decode.cu`` (one CTA per (kv head, slot), lengths and page
table read on the device, so one launch serves every tick); a CPU tensor
takes the plain version :func:`paged_decode_plain`. There is no other
route: a kernel that fails to build or launch raises.

The speculative-verify, int8 and head-sharded variants of the TPU module
are not ported yet (ROADMAP kernels B11, B12 and the sharded rung).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .paged_kv import PagedKVCache

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8  # GMAX in csrc/paged_decode.cu


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("paged_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.paged_decode_f32, lib.paged_decode_bf16):
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode.cu``: ``q (S, hq, d)`` CUDA tensor of the
    pages' dtype (float32 or bfloat16). Adds one to
    ``paged_decode_kernel.launches`` per launch."""
    S, hq, d = q.shape
    num_pages, ps, hk, dv = cache.v_pages.shape
    if not (q.is_cuda and cache.k_pages.device == q.device):
        raise ValueError("paged_decode_kernel takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_decode_kernel: dtype {q.dtype} not supported")
    if cache.k_pages.dtype != q.dtype or cache.v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_kernel: q and the pages differ in dtype")
    if d != dv or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode_kernel: head dims d={d}, dv={dv}")
    if hq % hk or hq // hk > KERNEL_MAX_GROUP:
        raise ValueError(
            f"paged_decode_kernel: hq={hq} must be a multiple of hk={hk} "
            f"with hq / hk <= {KERNEL_MAX_GROUP}"
        )
    if cache.page_table.shape[0] != S or cache.lengths.shape != (S,):
        raise ValueError("paged_decode_kernel: one query row per cache slot")
    q = q.contiguous()
    tensors = (q, cache.k_pages, cache.v_pages, cache.page_table, cache.lengths)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_decode_kernel needs contiguous, aligned tensors")
    if cache.page_table.dtype != torch.int32 or cache.lengths.dtype != torch.int32:
        raise TypeError("paged_decode_kernel: table and lengths must be int32")
    out = torch.empty_like(q)
    lse = torch.empty((S, hq), dtype=torch.float32, device=q.device)
    lib = _lib()
    fn = lib.paged_decode_f32 if q.dtype == torch.float32 else lib.paged_decode_bf16
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), S, hq, hk, d, ps,
        cache.page_table.shape[1], softmax_scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "paged_decode_kernel")
    paged_decode_kernel.launches += 1
    return out, lse


paged_decode_kernel.launches = 0


def paged_decode_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather every slot's pages (-1 entries clamp to
    page 0), mask rows at or past the slot's length, softmax in float32.
    Same contract as :func:`paged_decode_attn`. Counts its calls in
    ``paged_decode_plain.calls``."""
    paged_decode_plain.calls += 1
    S, hq, d = q.shape
    num_pages, ps, hk, dv = cache.v_pages.shape
    g = hq // hk
    if softmax_scale is None:
        softmax_scale = float(d) ** -0.5
    P = cache.page_table.shape[1]
    table = cache.page_table.clamp_min(0).long()  # (S, P)
    k = cache.k_pages[table].reshape(S, P * ps, hk, d).float()
    v = cache.v_pages[table].reshape(S, P * ps, hk, dv).float()
    cols = torch.arange(P * ps, device=q.device)
    live = cols[None, :] < cache.lengths[:, None].long()  # (S, L)

    qf = q.float().reshape(S, hk, g, d)
    scores = torch.einsum("shgd,slhd->shgl", qf, k) * softmax_scale
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m.isfinite(), m, 0.0)
    p = torch.exp(scores - m_safe)  # exactly 0 on masked rows
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    out = torch.einsum("shgl,slhd->shgd", p, v) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, float("-inf"), m_safe + torch.log(l))
    return (
        out.reshape(S, hq, dv).to(q.dtype),
        lse.reshape(S, hq),
    )


paged_decode_plain.calls = 0


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
