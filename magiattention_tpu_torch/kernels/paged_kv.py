"""Paged KV cache + paged attention over it (float or int8 pages).

The port's counterpart of ``magiattention_tpu/kernels/paged_kv.py``. K/V
live in fixed-size pages indexed by a per-sequence page table. The TPU
package updates its cache functionally (``.at[].set``) and returns a new
pytree; the port updates :class:`PagedKVCache` IN PLACE (``index_put_`` and
slice assignment, no copy of the pages) and returns the same object, so
call sites read the same (``cache = append_kv(cache, ...)``).

An int8 cache stores symmetric codes with one float32 scale per (page, kv
head); :func:`append_kv` quantizes on the way in, :func:`gather_kv`
dequantizes on the way out, so prefill and the oracle see float32.

Prefill attention gathers a sequence's pages into contiguous ``[sk, hk, d]``
rows and runs :func:`~.ffa.ffa_attn` with a one-slice plan whose k range
ends at the host-static ``kv_len``; rows past it are never attended.

A cache on the card stores its pages at the decode kernels' width
(:func:`.head_dims.kernel_head_dim` of ``head_dim`` and ``head_dim_v``),
allocated once when it is created, so no tick copies the pool: the extra
columns stay zero (appends write zeros there, and an int8 page's row
scale, a max over the row, is unchanged by them). ``head_dim`` and
``head_dim_v`` stay the cache's logical widths, and appends, gathers and
the plain versions read only those columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .ffa import ffa_attn
from .head_dims import kernel_head_dim, pad_head_dim
from .mask_utils import BAND_INF


@dataclass
class PagedKVCache:
    """Paged KV storage for one attention layer.

    Attributes:
        k_pages / v_pages: ``(num_pages, page_size, hk, d)``.
        page_table: ``(max_seqs, max_pages_per_seq)`` int32 page ids
            (-1 = unallocated).
        lengths: ``(max_seqs,)`` int32 tokens currently stored per sequence.
        k_scales / v_scales: ``(num_pages, hk)`` float32 per-(page, kv
            head) scales of an int8 cache (value = code * scale); None on
            a float cache.
        head_dim / head_dim_v: the logical k and v widths (default: the
            pages' own); the pages may be wider, the extra columns zero.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None
    head_dim: int | None = None
    head_dim_v: int | None = None

    def __post_init__(self) -> None:
        if self.head_dim is None:
            self.head_dim = self.k_pages.shape[-1]
        if self.head_dim_v is None:
            self.head_dim_v = self.v_pages.shape[-1]
        if self.head_dim > self.k_pages.shape[-1] or self.head_dim_v > self.v_pages.shape[-1]:
            raise ValueError(
                f"head dims {self.head_dim}, {self.head_dim_v} exceed the "
                f"pages' widths {self.k_pages.shape[-1]}, {self.v_pages.shape[-1]}"
            )

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @property
    def device(self) -> torch.device:
        return self.k_pages.device

    @classmethod
    def create(
        cls,
        num_pages: int,
        page_size: int,
        n_kv_heads: int,
        head_dim: int,
        max_seqs: int,
        max_pages_per_seq: int,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
        head_dim_v: int | None = None,
    ) -> "PagedKVCache":
        """Zeroed pages and an all -1 table, on the card unless ``device``
        says otherwise. ``dtype=torch.int8`` adds zeroed scales. v rows are
        ``head_dim_v`` wide (default ``head_dim``). On the card both page
        tensors take the decode kernels' width (raises above 256)."""
        if dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise ValueError(
                f"PagedKVCache dtype {dtype}: float32, bfloat16 or int8"
            )
        device = resolve_device(device)
        dv = head_dim if head_dim_v is None else head_dim_v
        widths = (head_dim, dv)
        if device.type == "cuda":
            widths = (kernel_head_dim(head_dim, dv),) * 2
        shape = (num_pages, page_size, n_kv_heads)
        scales = None
        if dtype == torch.int8:
            scales = torch.zeros(
                (num_pages, n_kv_heads), dtype=torch.float32, device=device
            )
        return cls(
            k_pages=torch.zeros((*shape, widths[0]), dtype=dtype, device=device),
            v_pages=torch.zeros((*shape, widths[1]), dtype=dtype, device=device),
            page_table=torch.full(
                (max_seqs, max_pages_per_seq), -1, dtype=torch.int32,
                device=device,
            ),
            lengths=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
            k_scales=scales,
            v_scales=None if scales is None else torch.zeros_like(scales),
            head_dim=head_dim,
            head_dim_v=dv,
        )


def assign_pages(
    cache: PagedKVCache, seq_id: int, page_ids
) -> PagedKVCache:
    """Install ``page_ids`` as the head of ``seq_id``'s table (in place)."""
    ids = torch.as_tensor(np.asarray(page_ids, dtype=np.int32))
    cache.page_table[seq_id, : len(ids)] = ids.to(cache.device)
    return cache


def rollback_kv(cache: PagedKVCache, seq_id: int, new_length: int) -> PagedKVCache:
    """Discard a sequence's rows past ``new_length`` (in place; the rows
    stay as garbage in their pages, dead under the length mask; an int8
    page keeps its scale, which the rescale-on-append algebra handles)."""
    cache.lengths[seq_id] = new_length
    return cache


def _quantize_rows(pages, scales, page_idx, row, x):
    """Quantize ``x`` ``(n, hk, d)`` into row ``row[i]`` of page
    ``page_idx[i]`` (distinct pages), in place: a row may raise its page's
    scale per head to ``max(old, max|x| / 127)``; the page's codes are then
    rescaled by ``round(code * old / new)`` before the row is quantized
    (half-to-even rounding, clipped to +-127). Each op is elementwise or a
    per-(page, head) max, so a page's result does not depend on which other
    pages share the call."""
    x = x.float()
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which may round differently
    cand = x.abs().amax(dim=-1) / x.new_full((), 127.0)  # (n, hk)
    old = scales[page_idx]
    new = torch.maximum(old, cand)
    safe = torch.where(new > 0.0, new, 1.0)
    ratio = old / safe  # 0 where the page was fresh
    page = torch.round(pages[page_idx].float() * ratio[:, None, :, None])
    page = page.clamp(-127, 127)
    row_q = torch.round(x / safe[:, :, None]).clamp(-127, 127)
    page[torch.arange(len(row), device=row.device), row] = row_q
    pages[page_idx] = page.to(torch.int8)
    scales[page_idx] = new


def _quantize_append(pages, scales, page_idx, row, x_new):
    """The plain version: one appended row at a time, in order, as the JAX
    package's ``_quantize_append`` does."""
    for i in range(x_new.shape[0]):
        _quantize_rows(
            pages, scales, page_idx[i : i + 1], row[i : i + 1], x_new[i : i + 1]
        )


def append_waves(start: int, t: int, ps: int) -> list[list[int]]:
    """The rows of an append of ``t`` rows at position ``start``, grouped
    in waves: wave w holds the w-th appended row of every page the append
    touches, so a wave's pages are distinct and each page sees its rows in
    order. At most ``min(t, ps)`` waves."""
    pos = start + np.arange(t)
    first = np.maximum(pos // ps * ps, start)  # first appended row of its page
    wave = pos - first
    return [np.flatnonzero(wave == w).tolist() for w in range(int(wave.max()) + 1)]


def _quantize_append_waves(pages, scales, page_idx, row, x_new, start):
    """:func:`_quantize_append` in waves (:func:`append_waves`): the same
    operations on every (page, head) in the same order, so the same bits,
    in at most ``page_size`` batched steps instead of one per row."""
    for rows in append_waves(start, x_new.shape[0], pages.shape[1]):
        sel = torch.tensor(rows, device=x_new.device)
        _quantize_rows(pages, scales, page_idx[sel], row[sel], x_new[sel])


def append_kv(
    cache: PagedKVCache, seq_id: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> PagedKVCache:
    """Append ``(t, hk, d)`` / ``(t, hk, dv)`` rows to a sequence whose
    pages are assigned.

    Positions are ``lengths[seq_id] .. +t``, computed on the device. An
    int8 cache quantizes the rows on the way in: row by row on the CPU, in
    waves on the card (which reads the start position on the host). Rows
    are padded with zero columns to the pages' width. In place."""
    t = k_new.shape[0]
    k_new = pad_head_dim(k_new, cache.k_pages.shape[-1])
    v_new = pad_head_dim(v_new, cache.v_pages.shape[-1])
    ps = cache.page_size
    pos = cache.lengths[seq_id] + torch.arange(
        t, dtype=torch.int32, device=cache.device
    )
    page_idx = cache.page_table[seq_id, (pos // ps).long()].long()
    row = (pos % ps).long()
    if cache.quantized:
        start = int(cache.lengths[seq_id]) if cache.k_pages.is_cuda else None
        for pages, scales, x in (
            (cache.k_pages, cache.k_scales, k_new),
            (cache.v_pages, cache.v_scales, v_new),
        ):
            if start is None:
                _quantize_append(pages, scales, page_idx, row, x)
            else:
                _quantize_append_waves(pages, scales, page_idx, row, x, start)
    else:
        cache.k_pages.index_put_((page_idx, row), k_new.to(cache.k_pages.dtype))
        cache.v_pages.index_put_((page_idx, row), v_new.to(cache.v_pages.dtype))
    cache.lengths[seq_id] += t
    return cache


def gather_kv(
    cache: PagedKVCache, seq_id: int, max_pages: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """A sequence's pages as ``(cap, hk, head_dim)`` K and ``(cap, hk,
    head_dim_v)`` V (cap = max_pages * page_size): the logical columns.
    -1 entries clamp to page 0; rows beyond ``lengths[seq_id]`` are
    whatever the pages hold and must be masked by the caller. An int8
    cache is dequantized to float32 (code * scale)."""
    table = cache.page_table[seq_id]
    if max_pages is not None:
        table = table[:max_pages]
    safe = table.clamp_min(0).long()
    k = cache.k_pages.index_select(0, safe)  # (P, ps, hk, d)
    v = cache.v_pages.index_select(0, safe)
    if cache.quantized:
        ks = cache.k_scales.index_select(0, safe)  # (P, hk)
        vs = cache.v_scales.index_select(0, safe)
        k = k.float() * ks[:, None, :, None]
        v = v.float() * vs[:, None, :, None]
    return k.flatten(0, 1)[..., : cache.head_dim], v.flatten(0, 1)[..., : cache.head_dim_v]


def paged_attn(
    q: torch.Tensor,
    cache: PagedKVCache,
    seq_id: int,
    q_start: int,
    max_pages: int,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q`` (``(t, hq, d)`` at positions ``q_start..+t``)
    against a sequence's paged KV, with an optional ``softcap`` (passed to
    FFA) and, under ``causal`` (the default), the causal band; ``causal``
    False lets every row see the sequence's ``kv_len`` tokens (the JAX
    package's ``paged_attn``).

    The valid-length mask is FFA slice metadata (band with ``ke =
    kv_len``), so the kernel computes only real rows; ``kv_len`` is
    host-static per call (it parameterizes the plan, which is cached by
    geometry).

    Returns (out ``(t, hq, dv)``, lse ``(t, hq)``).
    """
    t = q.shape[0]
    kv_len = int(q_start) + t  # tokens stored so far incl. this chunk
    k, v = gather_kv(cache, seq_id, max_pages)
    # one slice: q rows [0,t) at global positions [q_start, q_start+t)
    # attending k rows [0, kv_len) with an optional causal band; in local
    # coords the causal diagonal sits at offset q_start
    d_hi = int(q_start) if causal else BAND_INF
    return ffa_attn(
        q, k, v,
        q_ranges=[[0, t]],
        k_ranges=[[0, kv_len]],
        softmax_scale=softmax_scale,
        softcap=softcap,
        d_lo=np.array([-BAND_INF], np.int32),
        d_hi=np.array([d_hi], np.int32),
    )
