"""Continuous-batching scheduler: admission, growth, eviction.

The port's counterpart of ``magiattention_tpu/serving/scheduler.py``; the
policy is the same, all deterministic so tests can assert exact orderings:

- **Admission** is FIFO with head-of-line blocking: the oldest waiting
  request admits only when a batch slot is free AND the pool covers its
  whole prompt; nothing behind it may jump the queue.
- **Growth** is lazy: a decoding request allocates one page exactly when
  its next token crosses a page boundary.
- **Eviction** is LIFO by admission sequence: when growth finds the pool
  empty, the most-recently-admitted OTHER active request is restarted —
  its pages freed, its slot's table row reset, the request pushed back to
  the FRONT of the waiting queue. Restart (recompute from the prompt) is
  safe because generation is deterministic. If nothing is evictable the
  typed :class:`~..resilience.errors.PageExhaustedError` propagates.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.paged_kv import PagedKVCache, assign_pages
from ..resilience.errors import PageExhaustedError
from .cache import PagePool, pages_needed, release_slot


@dataclass
class ServeRequest:
    """One generation request plus its runtime state in the engine."""

    req_id: int
    prompt: torch.Tensor  # (prompt_len, d_model)
    max_new_tokens: int

    # runtime state (engine/scheduler owned)
    slot: int | None = None
    page_ids: list[int] = field(default_factory=list)
    length: int = 0  # tokens currently stored in the cache
    generated: list[np.ndarray] = field(default_factory=list)
    pending_x: torch.Tensor | None = None  # next decode step's input row
    admit_seq: int = -1
    evictions: int = 0
    shard: int = 0  # page-pool shard all of this request's pages live on

    # latency bookkeeping
    submit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def reset_runtime(self) -> None:
        """Back to the waiting-queue state (eviction restart)."""
        self.slot = None
        self.page_ids = []
        self.length = 0
        self.generated = []
        self.pending_x = None
        self.shard = 0


class Scheduler:
    """Owns the page pool, the slot table and the waiting queue."""

    def __init__(self, pool: PagePool, max_slots: int, page_size: int) -> None:
        self.pool = pool
        self.max_slots = max_slots
        self.page_size = page_size
        self.slots: list[ServeRequest | None] = [None] * max_slots
        self.waiting: deque[ServeRequest] = deque()
        self._admit_counter = 0

    # -- queries ----------------------------------------------------------
    @property
    def active(self) -> list[ServeRequest]:
        return [r for r in self.slots if r is not None]

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def submit_request(self, req: ServeRequest) -> None:
        self.waiting.append(req)

    # -- admission --------------------------------------------------------
    def admit(
        self, cache: PagedKVCache
    ) -> tuple[PagedKVCache, list[ServeRequest]]:
        """Admit FIFO head-of-line requests while a slot and the prompt's
        pages are both available. Installs each request's pages in the
        device cache; prefill itself is the engine's job."""
        admitted: list[ServeRequest] = []
        while self.waiting:
            req = self.waiting[0]
            slot = next(
                (i for i, r in enumerate(self.slots) if r is None), None
            )
            if slot is None:
                break
            need = pages_needed(req.prompt_len, self.page_size)
            if need > cache.page_table.shape[1]:
                raise ValueError(
                    f"request {req.req_id}: prompt needs {need} pages, "
                    f"table width is {cache.page_table.shape[1]}"
                )
            shard = self.pool.best_shard(need)
            if shard is None:
                break
            self.waiting.popleft()
            req.shard = shard
            req.page_ids = self.pool.alloc(need, shard=shard)
            req.slot = slot
            req.length = 0
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.slots[slot] = req
            cache = assign_pages(cache, slot, req.page_ids)
            admitted.append(req)
        return cache, admitted

    # -- growth / eviction ------------------------------------------------
    def ensure_capacity(
        self, cache: PagedKVCache, req: ServeRequest, new_length: int
    ) -> tuple[PagedKVCache, int]:
        """Grow ``req``'s page list to cover ``new_length`` tokens, evicting
        other requests LIFO when the pool is dry. Returns the cache and the
        number of evictions performed."""
        evicted = 0
        need = pages_needed(new_length, self.page_size)
        if need > cache.page_table.shape[1]:
            raise ValueError(
                f"request {req.req_id}: {new_length} tokens need {need} "
                f"pages, table width is {cache.page_table.shape[1]}"
            )
        while len(req.page_ids) < need:
            try:
                new_pages = self.pool.alloc(1, shard=req.shard)
            except PageExhaustedError:
                cache = self.evict_one(cache, exclude=req, shard=req.shard)
                evicted += 1
                continue
            req.page_ids.extend(new_pages)
            cache = assign_pages(cache, req.slot, req.page_ids)
        return cache, evicted

    def evict_one(
        self,
        cache: PagedKVCache,
        exclude: ServeRequest,
        shard: int | None = None,
    ) -> PagedKVCache:
        """Restart the most-recently-admitted active request other than
        ``exclude`` (on ``shard`` when given); raises
        :class:`PageExhaustedError` when none exists."""
        victims = [
            r
            for r in self.slots
            if r is not None
            and r is not exclude
            and (shard is None or r.shard == shard)
        ]
        if not victims:
            free = (
                self.pool.free_count
                if shard is None
                else self.pool.free_count_shard(shard)
            )
            raise PageExhaustedError(requested=1, free=free)
        victim = max(victims, key=lambda r: r.admit_seq)
        self.pool.release(victim.page_ids)
        cache = release_slot(cache, victim.slot)
        self.slots[victim.slot] = None
        victim.reset_runtime()
        victim.evictions += 1
        self.waiting.appendleft(victim)
        return cache

    # -- completion -------------------------------------------------------
    def finish(
        self, cache: PagedKVCache, req: ServeRequest
    ) -> PagedKVCache:
        """Free a completed request's resources (its outputs stay on the
        request object)."""
        self.pool.release(req.page_ids)
        cache = release_slot(cache, req.slot)
        self.slots[req.slot] = None
        req.page_ids = []
        return cache
