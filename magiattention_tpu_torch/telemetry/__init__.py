"""Runtime telemetry: per-plan / per-step metrics registry with JSONL export.

The port's copy of ``magiattention_tpu/telemetry/``, with the same record
kinds, field names and ``SCHEMA_VERSION``. The observability counterpart
of ``utils/profiling.py``: where profiling puts *names* on the profiler
timeline, telemetry records *numbers* — the
dispatch solver's balance ratio, every GroupCast stage's payload/wire/padding
rows and bytes, the FFA planner's padded-vs-true work, per-step host wall
times, and the runtime LRU's hit/miss/evict counts — as schema-versioned
JSONL records a CI job or ``scripts/telemetry_report.py`` can read back.

Gated on ``MAGI_ATTENTION_TELEMETRY`` (env/general.py typed getter, same
pattern as ``MAGI_ATTENTION_PROFILE_MODE``): with the flag off every entry
point here is a cheap early return — no file I/O, no timer reads, no CUDA
event, nothing allocated (pinned by tests/test_torch_telemetry.py).

Stage records carry the SAME scope names (``group_cast_stage0``,
``ffa_fwd_stage0``, ...) that ``utils/profiling.profile_scope`` puts on
the torch profiler's timeline (and NVTX on a card), so a JSONL record
links to its trace span when both flags are on (the field keeps JAX's
name, ``xprof_scope``).

On a card, ``attn_step`` records also carry ``device_ms``: a CUDA event
pair around the step's forward on the current stream, and, where the step
had a backward, ``bwd_device_ms``, a pair around that backward; both are
read once their end events have completed (at a later step or at
:func:`flush`), never by a synchronize inside the step. ``wall_ms`` stays
the host time around the forward call, which on CUDA is mostly launch
time. Call :func:`flush` at the end of a run to write the steps still
waiting for their events.

:func:`counters` reads the counters with telemetry on or off: the
resilience layer's ``resilience.<action>`` counts are kept either way
(``inc(..., always=True)``, plain ints).
"""

from .registry import (  # noqa: F401
    SCHEMA_VERSION,
    BackwardTimer,
    TelemetryCollector,
    backward_timer,
    counters,
    device_timer_start,
    device_timer_stop,
    enabled,
    flat_summary,
    flush,
    get_collector,
    inc,
    record_event,
    record_timed_event,
    reset,
    set_gauge,
    stage_timer,
    summary,
)
from . import health  # noqa: F401
from .stats import band_area  # noqa: F401
from .store import (  # noqa: F401
    TelemetryStore,
    StoreState,
    store_active,
)
from .drift import fit_constants, fit_scale, scan  # noqa: F401
