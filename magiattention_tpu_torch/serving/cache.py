"""Host-side KV page pool + cache slot lifecycle (serving layer).

The port's counterpart of ``magiattention_tpu/serving/cache.py``. The device
cache is :class:`~..kernels.paged_kv.PagedKVCache`; this module owns the
HOST bookkeeping around it: which pages are free, how many a request needs,
resetting a slot's table row when a request finishes or is evicted, and
the quantization scales of released int8 pages. Allocation order is
deterministic (FIFO free list), which is what makes slot reuse and eviction
replayable in tests.

The pool may be partitioned into ``num_shards`` contiguous ranges with
independent FIFO free lists, and the scheduler routes each slot to the
shard with the most headroom (host only; ``num_shards=1`` is one list).
"""

from __future__ import annotations

from collections import deque

import torch

from ..kernels.paged_kv import PagedKVCache
from ..resilience.errors import PageExhaustedError


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` rows (at least one: a slot's first token
    always needs a page)."""
    return max(1, -(-tokens // page_size))


def kv_page_bytes(
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    head_dim_v: int | None = None,
    kv_dtype: str = "float32",
) -> int:
    """Device bytes one KV page costs under ``kv_dtype``, including the
    per-(page, head) float32 scales a quantized cache carries: int8 pages
    cost about 1/2 of bf16 and 1/4 of float32."""
    dv = head_dim if head_dim_v is None else head_dim_v
    itemsize = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}[
        str(kv_dtype)
    ]
    nbytes = page_size * n_kv_heads * (head_dim + dv) * itemsize
    if kv_dtype == "int8":
        nbytes += 2 * n_kv_heads * 4  # k_scales + v_scales rows
    return nbytes


def slot_residency(
    hbm_budget_bytes: int, page_bytes: int, pages_per_slot: int
) -> int:
    """How many full slots (``pages_per_slot`` pages each) fit in a device
    memory (HBM) budget of ``hbm_budget_bytes``."""
    return hbm_budget_bytes // (page_bytes * pages_per_slot)


class PagePool:
    """Deterministic FIFO free-list over the cache's page ids, partitioned
    into ``num_shards`` contiguous ranges (``num_shards=1`` = one list)."""

    def __init__(self, num_pages: int, num_shards: int = 1) -> None:
        if num_shards < 1 or num_pages % num_shards:
            raise ValueError(
                f"num_pages={num_pages} must split evenly over "
                f"num_shards={num_shards}"
            )
        self._num_pages = num_pages
        self._num_shards = num_shards
        self._per_shard = num_pages // num_shards
        self._free: list[deque[int]] = [
            deque(range(s * self._per_shard, (s + 1) * self._per_shard))
            for s in range(num_shards)
        ]

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def used_count(self) -> int:
        return self._num_pages - self.free_count

    def shard_of(self, page_id: int) -> int:
        """Which shard range a page id belongs to (release routing)."""
        return page_id // self._per_shard

    def free_count_shard(self, shard: int) -> int:
        return len(self._free[shard])

    def best_shard(self, n: int) -> int | None:
        """Shard with the most free pages that can cover ``n`` (ties go to
        the lowest id); None if no single shard can."""
        best, best_free = None, -1
        for s in range(self._num_shards):
            free = len(self._free[s])
            if free >= n and free > best_free:
                best, best_free = s, free
        return best

    def alloc(self, n: int, shard: int = 0) -> list[int]:
        """Pop ``n`` page ids from one shard's range; raises
        :class:`PageExhaustedError` when that shard cannot cover them
        (callers decide whether to evict first)."""
        free = self._free[shard]
        if n > len(free):
            raise PageExhaustedError(requested=n, free=len(free))
        return [free.popleft() for _ in range(n)]

    def release(self, page_ids: list[int]) -> None:
        for pid in page_ids:
            self._free[self.shard_of(pid)].append(pid)


def reset_page_scales(
    cache: PagedKVCache, page_ids: list[int]
) -> PagedKVCache:
    """Zero the quantization scales of released pages (in place), so a
    reused page quantizes exactly like a fresh one: scales only grow within
    a page's lifetime, and a predecessor's larger scale would otherwise
    leak into the successor's codes. No-op on float caches."""
    if not cache.quantized or not page_ids:
        return cache
    idx = torch.as_tensor(page_ids, dtype=torch.long, device=cache.device)
    cache.k_scales[idx] = 0.0
    cache.v_scales[idx] = 0.0
    return cache


def release_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Reset a slot on the device cache (in place): table row back to -1,
    length to 0 — so a reused slot never reads a predecessor's pages."""
    cache.page_table[slot] = -1
    cache.lengths[slot] = 0
    return cache
