"""Serving runtime: paged-decode attention + continuous batching.

Layers (as in ``magiattention_tpu/serving``):

- :mod:`.model` — the minimal deterministic model the engine drives (with
  its greedy self-draft for speculative decode);
- :mod:`.cache` — host page pool + slot lifecycle + residency accounting
  over the device-side :class:`~..kernels.paged_kv.PagedKVCache` (float32
  or int8 + scales);
- :mod:`.prefill` — chunked prompt ingestion through the FFA forward;
- :mod:`.decode` — batched decode / verify attention through the
  paged-decode, spec and int8 kernels;
- :mod:`.scheduler` — FIFO admission, lazy page growth, LIFO eviction with
  restart semantics under the page budget, page-level rollback shrink;
- :mod:`.engine` — the continuous-batching tick loop (one token or a
  spec_tokens draft window per tick);
- :mod:`.reference` — sequential replay oracle.
"""

from .cache import (  # noqa: F401
    PagePool,
    kv_page_bytes,
    pages_needed,
    release_slot,
    reset_page_scales,
    slot_residency,
)
from .decode import decode_attn_step, verify_attn_step  # noqa: F401
from .engine import ServeConfig, ServeEngine  # noqa: F401
from .model import ToyModel  # noqa: F401
from .prefill import prefill_request, prefill_schedule  # noqa: F401
from .reference import (  # noqa: F401
    generate_reference,
    oracle_draft_fn,
    run_reference,
)
from .scheduler import Scheduler, ServeRequest  # noqa: F401

__all__ = [
    "PagePool",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "ServeRequest",
    "ToyModel",
    "decode_attn_step",
    "generate_reference",
    "kv_page_bytes",
    "oracle_draft_fn",
    "pages_needed",
    "prefill_request",
    "prefill_schedule",
    "release_slot",
    "reset_page_scales",
    "run_reference",
    "slot_residency",
    "verify_attn_step",
]
