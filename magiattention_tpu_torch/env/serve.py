"""Serving-runtime toggles for :meth:`ServeConfig.from_env`.

Same names and defaults as ``magiattention_tpu/env/serve.py``.
"""

from __future__ import annotations

from .general import _get_int, _get_str


def serve_max_slots() -> int:
    """Static batch-slot count (requests beyond it wait for admission)."""
    return _get_int("MAGI_ATTENTION_SERVE_MAX_SLOTS", 4)


def serve_num_pages() -> int:
    """KV page-pool size: the budget admission and eviction work under."""
    return _get_int("MAGI_ATTENTION_SERVE_PAGES", 64)


def serve_page_size() -> int:
    """Tokens per KV page."""
    return _get_int("MAGI_ATTENTION_SERVE_PAGE_SIZE", 16)


def serve_prefill_chunk() -> int:
    """Prompt tokens per FFA prefill call."""
    return _get_int("MAGI_ATTENTION_SERVE_PREFILL_CHUNK", 64)


def serve_kv_dtype() -> str:
    """KV-cache storage dtype: 'float32' or 'int8' (int8 codes with
    per-(page, kv head) float32 scales)."""
    return _get_str("MAGI_ATTENTION_SERVE_KV_DTYPE", "float32").lower()


def serve_spec_tokens() -> int:
    """Draft tokens verified per tick (1 = one token per tick)."""
    return _get_int("MAGI_ATTENTION_SERVE_SPEC_TOKENS", 1)


def serve_shards() -> int:
    """kv-head shard count of the decode kernel (1 = one device)."""
    return _get_int("MAGI_ATTENTION_SERVE_SHARDS", 1)


def serve_pool_shards() -> int:
    """Page-pool partition count (scheduler routing; host only)."""
    return _get_int("MAGI_ATTENTION_SERVE_POOL_SHARDS", 1)
