"""Serving runtime: paged-decode attention + continuous batching.

Layers (as in ``magiattention_tpu/serving``):

- :mod:`.model` — the minimal deterministic model the engine drives;
- :mod:`.cache` — host page pool + slot lifecycle over the device-side
  :class:`~..kernels.paged_kv.PagedKVCache`;
- :mod:`.prefill` — chunked prompt ingestion through the FFA forward;
- :mod:`.decode` — batched decode attention through the paged-decode kernel;
- :mod:`.scheduler` — FIFO admission, lazy page growth, LIFO eviction with
  restart semantics under the page budget;
- :mod:`.engine` — the continuous-batching tick loop;
- :mod:`.reference` — sequential replay oracle.
"""

from .cache import PagePool, pages_needed, release_slot  # noqa: F401
from .decode import decode_attn_step  # noqa: F401
from .engine import ServeConfig, ServeEngine  # noqa: F401
from .model import ToyModel  # noqa: F401
from .prefill import prefill_request, prefill_schedule  # noqa: F401
from .reference import generate_reference, run_reference  # noqa: F401
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
    "pages_needed",
    "prefill_request",
    "prefill_schedule",
    "release_slot",
    "run_reference",
]
