"""Chunked prefill over the paged cache (serving layer).

The port's counterpart of ``magiattention_tpu/serving/prefill.py``: each
chunk's k/v are appended to the request's pages, then the chunk's queries
attend causally over everything stored so far through
:func:`~..kernels.paged_kv.paged_attn` (the FFA forward). The chunk schedule
is a pure function of (prompt length, chunk size), shared by the engine and
the sequential replay oracle.
"""

from __future__ import annotations

import torch

from ..kernels.paged_kv import PagedKVCache, append_kv, paged_attn
from .model import ToyModel


def prefill_schedule(total: int, chunk: int) -> list[tuple[int, int]]:
    """(start, size) chunks covering ``[0, total)`` in ``chunk`` steps."""
    if total <= 0:
        return []
    chunk = max(1, chunk)
    return [
        (start, min(chunk, total - start))
        for start in range(0, total, chunk)
    ]


def prefill_request(
    model: ToyModel,
    cache: PagedKVCache,
    slot: int,
    prompt: torch.Tensor,
    chunk: int,
    softmax_scale: float | None = None,
) -> tuple[PagedKVCache, torch.Tensor]:
    """Prefill one request's prompt into its slot, chunk by chunk.

    Pages must be pre-assigned (scheduler admission). Returns the cache and
    the LAST prompt position's hidden row ``(d_model,)`` — the seed of the
    first generated token.
    """
    schedule = prefill_schedule(int(prompt.shape[0]), chunk)
    if not schedule:
        raise ValueError("empty prompt")
    for start, size in schedule:
        x = prompt[start : start + size]
        q, k, v = model.qkv(x)
        cache = append_kv(cache, slot, k, v)
        out, _ = paged_attn(
            q, cache, slot,
            q_start=start,
            max_pages=cache.page_table.shape[1],
            softmax_scale=softmax_scale,
        )
    return cache, model.project(out[-1:])[0]
