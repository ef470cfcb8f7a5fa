"""Process-global metrics registry (counters, gauges, timers, events).

One :class:`TelemetryCollector` per process, created lazily on the first
gated call. Every record flows straight through the JSONL sink
(telemetry/export.py) — append-only, flushed per record, so a crashed run
still leaves parseable history — while counters/gauges/last-events stay in
memory for :func:`summary` / :func:`flat_summary`.

The counters live beside the collector, in this module, so that a
counter bumped with ``always=True`` (the resilience layer's actions, plain
ints: no clock, no file) counts whether or not telemetry is on;
:func:`counters` reads them either way, :func:`reset` clears them.

A record timed on the card (:func:`record_timed_event`) waits for its CUDA
event pairs: it is written, stamped ``device_ms`` (the forward, the pair
around the call) and, where a backward ran, ``bwd_device_ms`` (the pair
:func:`backward_timer` puts around it), once those end events have
completed: checked without blocking once a later backward has queued its
kernels (or at a later record with no backward to come), a few records a
time, or at :func:`flush`, which waits for them. Its payload is
serialised then too, while the card works, not between the forward's
launch and the backward's.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any

import torch

from ..env import general as env_general
from .export import JsonlSink, process_unique_path

SCHEMA_VERSION = 1

# the counters (the collector's view of them, and the always-on resilience
# actions): one dict, one lock, kept across collectors
_counters: dict[str, int] = {}
_counters_lock = threading.RLock()


def enabled() -> bool:
    """The ONE gate every telemetry entry point checks first."""
    return env_general.is_telemetry_enable()


class TelemetryCollector:
    """Counters + gauges + per-kind last-event cache over a JSONL sink."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._lock = _counters_lock
        self._seq = 0
        self.counters = _counters
        self.gauges: dict[str, float] = {}
        self.last_event: dict[str, dict[str, Any]] = {}
        # host+pid+token unique name: concurrent hosts of a multi-slice
        # job never share a file (export.py also makes each line atomic)
        self._sink = JsonlSink(process_unique_path(directory, "magiattention"))

    @property
    def path(self) -> str:
        return self._sink.path

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def record_event(self, kind: str, payload: dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            record = {
                "schema_version": SCHEMA_VERSION,
                "ts": time.time(),
                "pid": os.getpid(),
                "seq": self._seq,
                "kind": kind,
                **payload,
            }
            self.counters[f"events.{kind}"] = (
                self.counters.get(f"events.{kind}", 0) + 1
            )
            self.last_event[kind] = record
            self._sink.write(record)
        # feed the persistent cross-run store (outside the collector lock;
        # the store has its own). No-op unless the store is active and the
        # kind is one it aggregates.
        from . import store as _store

        _store.ingest_event(record)

    def close(self) -> None:
        self._sink.close()


_collector: TelemetryCollector | None = None
_collector_lock = threading.Lock()


def get_collector() -> TelemetryCollector:
    """The process-global collector (created on first use; recreated when
    ``MAGI_ATTENTION_TELEMETRY_DIR`` changes, so tests can redirect it)."""
    global _collector
    directory = env_general.telemetry_dir()
    with _collector_lock:
        if _collector is None or _collector.directory != directory:
            if _collector is not None:
                _collector.close()
            _collector = TelemetryCollector(directory)
        return _collector


def reset() -> None:
    """Drop the global collector and the records still waiting for their
    device time (tests; a new collector is created on demand)."""
    global _collector
    with _collector_lock:
        if _collector is not None:
            _collector.close()
        _collector = None
    with _counters_lock:
        _counters.clear()
    with _pending_lock:
        _pending.clear()


# -- device-timed records ----------------------------------------------------


class _BackwardStart(torch.autograd.Function):
    """Identity on a step's output; its backward (the first of the step's)
    records the timer's start event."""

    @staticmethod
    def forward(ctx, timer, x):
        ctx.timer = timer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.timer.record(0)
        return None, g


class _BackwardEnd(torch.autograd.Function):
    """Identity on a step's inputs; its backward runs once the step's own
    has produced every input's gradient (its kernels are queued), records
    the end event, and writes the records that are ready by then: the
    host's serialising runs while the card works through that backward."""

    @staticmethod
    def forward(ctx, timer, *xs):
        ctx.timer = timer
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.timer.record(1)
        _drain(block=False)
        return (None, *gs)


class BackwardTimer:
    """A CUDA event pair around one step's backward: :meth:`mark_end` wraps
    the step's inputs, :meth:`mark_start` its output, and autograd records
    the events as the backward passes them (no wait)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.recorded = [False, False]

    def record(self, i: int) -> None:
        self.events[i].record(torch.cuda.current_stream(self.device))
        self.recorded[i] = True

    def mark_start(self, out: torch.Tensor) -> torch.Tensor:
        return _BackwardStart.apply(self, out)

    def mark_end(self, *xs: torch.Tensor) -> tuple:
        """``xs``, those that require grad passed through the end node
        (the others stay as they are: no gradient is made for them)."""
        idx = [i for i, x in enumerate(xs) if x.requires_grad]
        out = list(xs)
        for i, x in zip(idx, _BackwardEnd.apply(self, *(xs[i] for i in idx))):
            out[i] = x
        return tuple(out)

    def started(self) -> bool:
        return self.recorded[0]

    def done(self) -> bool:
        return self.recorded[0] and self.recorded[1]


def backward_timer(*xs: torch.Tensor) -> BackwardTimer | None:
    """A :class:`BackwardTimer` for a step on ``xs`` when they lie on the
    card and a backward can follow (grad mode on, one of them requires
    grad), else None. Callers gate on :func:`enabled`."""
    if xs[0].device.type != "cuda" or not torch.is_grad_enabled():
        return None
    if not any(x.requires_grad for x in xs):
        return None
    return BackwardTimer(xs[0].device)


# (kind, payload, forward pair, backward timer or None) in the order they
# were recorded; events of one stream complete in that order
_pending: list[tuple[str, dict[str, Any], tuple, BackwardTimer | None]] = []
_pending_lock = threading.Lock()


def device_timer_start(device: torch.device) -> tuple | None:
    """A CUDA event pair with its start recorded on ``device``'s current
    stream, or None off the card. Callers gate on :func:`enabled`."""
    if device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start, end, device


def device_timer_stop(timer: tuple | None) -> None:
    """Record the pair's end event on the same stream (no wait)."""
    if timer is not None:
        timer[1].record(torch.cuda.current_stream(timer[2]))


def _ready(entry) -> bool:
    """The forward's end event has completed, and the backward has not
    begun or its end event has completed too."""
    _, _, fwd, bwd = entry
    if not fwd[1].query():
        return False
    return bwd is None or not bwd.started() or (bwd.done() and bwd.events[1].query())


# records one non-blocking drain writes at most: a backlog (the host ran
# ahead of the card, then waited for it) is written a few a step, under
# the work each step queues, not in one burst the card would wait for
_DRAIN_BATCH = 2


def _drain(block: bool) -> None:
    """Write the waiting records that are ready, in order, at most
    ``_DRAIN_BATCH`` of them (``block``: every one, waiting for each). A
    backward that had not begun by then goes unstamped."""
    ready = []
    with _pending_lock:
        while _pending and (block or (len(ready) < _DRAIN_BATCH and _ready(_pending[0]))):
            ready.append(_pending.pop(0))
    for kind, payload, (start, end, _), bwd in ready:
        if block:
            end.synchronize()
        times = {"device_ms": start.elapsed_time(end)}
        if bwd is not None and bwd.done():
            if block:
                bwd.events[1].synchronize()
            times["bwd_device_ms"] = bwd.events[0].elapsed_time(bwd.events[1])
        record_event(kind, **times, **payload)


# records held waiting before a timed record with a backward drains anyway
# (a backward that never runs must not grow the queue without end)
_MAX_PENDING = 16


def record_timed_event(kind: str, timer: tuple | None, bwd: BackwardTimer | None = None,
                       **payload: Any) -> None:
    """:func:`record_event`, stamped with the device time of ``timer``
    (:func:`device_timer_start`) and of ``bwd``'s backward once they are
    known; at once when ``timer`` is None (the CPU). The payload is kept
    as given and serialised when the record is written: here, for a step
    with no backward to come (its forward is queued), else when the next
    backward has queued its kernels (``_BackwardEnd``), or at
    :func:`flush`."""
    if not enabled():
        return
    if timer is None:
        _drain(block=False)
        record_event(kind, **payload)
        return
    with _pending_lock:
        _pending.append((kind, payload, timer, bwd))
        waiting = len(_pending)
    if bwd is None or waiting > _MAX_PENDING:
        _drain(block=False)


def flush() -> None:
    """Wait for the device-timed records still pending and write them
    (telemetry on; with it off they are dropped)."""
    _drain(block=True)


# -- module-level gated entry points (what call sites use) -----------------


def record_event(kind: str, **payload: Any) -> None:
    if not enabled():
        return
    get_collector().record_event(kind, payload)
    if kind == "attn_step":
        # straggler detection: fold per-rank wall times into the health
        # monitor (no-op unless MAGI_ATTENTION_STRAGGLER_DETECT is on and
        # the record carries rank_wall_ms)
        from . import health as _health

        _health.observe_attn_step(payload)


def inc(name: str, n: int = 1, always: bool = False) -> None:
    """Bump counter ``name`` (telemetry on, or ``always``: a plain int
    with telemetry off too, no collector, no file)."""
    if always:
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + n
        return
    if not enabled():
        return
    get_collector().inc(name, n)


def counters(prefix: str = "") -> dict[str, int]:
    """The counters whose name starts with ``prefix``, whether or not
    telemetry is on (with it off only the ``always`` ones move)."""
    with _counters_lock:
        return {k: n for k, n in _counters.items() if k.startswith(prefix)}


def set_gauge(name: str, value: float) -> None:
    if not enabled():
        return
    get_collector().set_gauge(name, value)


@contextmanager
def stage_timer(name: str, record_kind: str | None = None, **payload: Any):
    """Gated host wall-timer. Off: identity (no ``perf_counter`` read).

    On: times the block, bumps ``time.<name>.calls`` / ``.total_ms``
    counters and the ``time.<name>.last_ms`` gauge; with ``record_kind``
    also emits a JSONL record carrying ``xprof_scope=name`` so the record
    links to the identically-named ``profile_scope`` span in a profiler trace
    when MAGI_ATTENTION_PROFILE_MODE is also on.
    """
    if not enabled():
        yield None
        return
    c = get_collector()
    t0 = time.perf_counter()
    try:
        yield c
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        c.inc(f"time.{name}.calls")
        with c._lock:
            c.counters[f"time.{name}.total_ms"] = int(
                c.counters.get(f"time.{name}.total_ms", 0) + ms
            )
        c.set_gauge(f"time.{name}.last_ms", ms)
        if record_kind is not None:
            c.record_event(
                record_kind, {"xprof_scope": name, "wall_ms": ms, **payload}
            )


def summary() -> dict[str, Any]:
    """Structured in-memory snapshot: counters, gauges, last event per kind."""
    if not enabled():
        return {}
    c = get_collector()
    with c._lock:
        return {
            "counters": dict(c.counters),
            "gauges": dict(c.gauges),
            "last": {k: dict(v) for k, v in c.last_event.items()},
        }


# last-event fields worth carrying onto bench-history rows: comm/balance
# context for a perf number (kind, field, column suffix)
_FLAT_FIELDS = (
    ("dispatch_meta", "balance_ratio", "balance_ratio"),
    ("dispatch_meta", "alg", "dispatch_alg"),
    ("attn_step", "overlap_degree", "overlap_degree"),
    ("attn_step", "wire_bytes_total", "wire_bytes"),
    ("attn_step", "payload_bytes_total", "payload_bytes"),
    ("attn_step", "wall_ms", "step_wall_ms"),
)


def flat_summary(prefix: str = "tel_") -> dict[str, Any]:
    """Flat scalar summary for tabular sinks (bench history CSV rows)."""
    if not enabled():
        return {}
    s = summary()
    out: dict[str, Any] = {}
    for kind, field, col in _FLAT_FIELDS:
        ev = s["last"].get(kind)
        if ev is not None and field in ev:
            out[prefix + col] = ev[field]
    for name in ("runtime_cache.hit", "runtime_cache.miss",
                 "runtime_cache.evict", "events.attn_step",
                 "events.plan_build"):
        if name in s["counters"]:
            out[prefix + name.replace(".", "_")] = s["counters"][name]
    return out
