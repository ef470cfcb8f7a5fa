"""Paged KV cache + paged attention over it (float pages).

The port's counterpart of ``magiattention_tpu/kernels/paged_kv.py``. K/V
live in fixed-size pages indexed by a per-sequence page table. The TPU
package updates its cache functionally (``.at[].set``) and returns a new
pytree; the port updates :class:`PagedKVCache` IN PLACE (``index_put_`` and
slice assignment, no copy of the pages) and returns the same object, so
call sites read the same (``cache = append_kv(cache, ...)``).

Prefill attention gathers a sequence's pages into contiguous ``[sk, hk, d]``
rows and runs :func:`~.ffa.ffa_attn` with a one-slice plan whose k range
ends at the host-static ``kv_len``; rows past it are never attended.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .ffa import ffa_attn
from .mask_utils import BAND_INF


@dataclass
class PagedKVCache:
    """Paged KV storage for one attention layer.

    Attributes:
        k_pages / v_pages: ``(num_pages, page_size, hk, d)``.
        page_table: ``(max_seqs, max_pages_per_seq)`` int32 page ids
            (-1 = unallocated).
        lengths: ``(max_seqs,)`` int32 tokens currently stored per sequence.
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[1]

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
    ) -> "PagedKVCache":
        """Zeroed pages and an all -1 table, on the card unless ``device``
        says otherwise (int8 pages are not ported: ROADMAP kernel B12)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"PagedKVCache dtype {dtype}: the port serves float pages "
                "only; int8 pages wait for kernel B12 (ROADMAP)"
            )
        device = resolve_device(device)
        shape = (num_pages, page_size, n_kv_heads, head_dim)
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            page_table=torch.full(
                (max_seqs, max_pages_per_seq), -1, dtype=torch.int32,
                device=device,
            ),
            lengths=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
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
    stay as garbage in their pages, dead under the length mask)."""
    cache.lengths[seq_id] = new_length
    return cache


def append_kv(
    cache: PagedKVCache, seq_id: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> PagedKVCache:
    """Append ``(t, hk, d)`` rows to a sequence whose pages are assigned.

    Positions are ``lengths[seq_id] .. +t``, computed on the device (no
    host sync). In place."""
    t = k_new.shape[0]
    ps = cache.page_size
    pos = cache.lengths[seq_id] + torch.arange(
        t, dtype=torch.int32, device=cache.device
    )
    page_idx = cache.page_table[seq_id, (pos // ps).long()].long()
    row = (pos % ps).long()
    cache.k_pages.index_put_((page_idx, row), k_new.to(cache.k_pages.dtype))
    cache.v_pages.index_put_((page_idx, row), v_new.to(cache.v_pages.dtype))
    cache.lengths[seq_id] += t
    return cache


def gather_kv(
    cache: PagedKVCache, seq_id: int, max_pages: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """A sequence's pages as contiguous ``(cap, hk, d)`` K/V (cap =
    max_pages * page_size). -1 entries clamp to page 0; rows beyond
    ``lengths[seq_id]`` are whatever the pages hold and must be masked by
    the caller."""
    table = cache.page_table[seq_id]
    if max_pages is not None:
        table = table[:max_pages]
    safe = table.clamp_min(0).long()
    k = cache.k_pages.index_select(0, safe)  # (P, ps, hk, d)
    v = cache.v_pages.index_select(0, safe)
    return k.flatten(0, 1), v.flatten(0, 1)


def paged_attn(
    q: torch.Tensor,
    cache: PagedKVCache,
    seq_id: int,
    q_start: int,
    max_pages: int,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q`` (``(t, hq, d)`` at positions ``q_start..+t``)
    against a sequence's paged KV.

    The valid-length mask is FFA slice metadata (band with ``ke =
    kv_len``), so the kernel computes only real rows; ``kv_len`` is
    host-static per call (it parameterizes the plan, which is cached by
    geometry).

    Returns (out ``(t, hq, dv)``, lse ``(t, hq)``).
    """
    t = q.shape[0]
    kv_len = int(q_start) + t  # tokens stored so far incl. this chunk
    k, v = gather_kv(cache, seq_id, max_pages)
    # one causal slice: q rows [0,t) at global positions [q_start,
    # q_start+t) attending k rows [0, kv_len); in local coords the causal
    # diagonal sits at offset q_start
    return ffa_attn(
        q, k, v,
        q_ranges=[[0, t]],
        k_ranges=[[0, kv_len]],
        softmax_scale=softmax_scale,
        d_lo=np.array([-BAND_INF], np.int32),
        d_hi=np.array([q_start], np.int32),
    )
