"""Per-rank health tracking → capacity vector (the port's copy of
``magiattention_tpu/telemetry/health.py``).

Folds per-rank step wall times (the ``rank_wall_ms`` field of ``attn_step``
records, or direct :func:`observe_step` calls) into an EWMA per rank and
derives a per-rank *capacity* in (0, 1] with hysteresis:

- a rank **enters** degraded state only after ``STRAGGLER_MIN_STEPS``
  observations, when its normalized EWMA exceeds ``STRAGGLER_ENTER`` times
  the healthy median, and only once per ``STRAGGLER_COOLDOWN`` steps;
- while degraded its capacity is **frozen** (one noisy step never re-flips
  the plan) until its normalized EWMA drops under ``STRAGGLER_EXIT``;
- slowness is always judged per *unit of work*: a degraded rank runs a
  capacity-proportional share of the weighted plan, so its raw wall time
  converges back to the healthy median even on still-slow hardware —
  dividing the EWMA by the rank's capacity removes that feedback loop.

The derived vector feeds ``DistAttnRuntimeKey.capacities`` (api layer), so
a changed vector is a changed plan key: the runtime re-solves exactly when
the vector changes, and the plan cache holds weighted plans like any
other. An all-ones vector normalizes to ``None`` — plan signatures stay
byte-identical to a build without this module.

In the port every rank runs its own monitor, and ranks whose vectors
differ would plan differently and then hang in their collectives. So the
vector is a pure function of the observations: feed every rank the same
ones (an ``all_gather`` of the step times, then :func:`observe_step` for
each rank, or ``rank_wall_ms`` on the ``attn_step`` record), and
``magi_attn_flex_key`` checks at cp > 1 that the group agrees.

Everything is gated on ``MAGI_ATTENTION_STRAGGLER_DETECT``; the
``rank_health_read`` chaos site covers the read path (fault + fallback →
uniform all-ones vector).
"""

from __future__ import annotations

import statistics
import threading
from dataclasses import dataclass, field as _field

from ..env import health as env_health
from . import registry as _registry

# capacity quantization grid: coarse steps keep float jitter out of the
# plan key (a vector change means a re-solve, so changes must be rare)
_CAP_GRID = 8
_CAP_MIN = 1.0 / _CAP_GRID


def _quantize_capacity(x: float) -> float:
    return max(_CAP_MIN, min(1.0, round(x * _CAP_GRID) / _CAP_GRID))


@dataclass
class _RankState:
    ewma_ms: float | None = None
    count: int = 0
    capacity: float = 1.0
    # large initial value: the first transition is never cooldown-blocked
    since_change: int = 1 << 30


@dataclass
class RankHealthMonitor:
    """EWMA + hysteresis straggler detector. Thread-safe; step-count based
    (no wall clock of its own — the observed wall_ms IS the signal)."""

    _ranks: dict[int, _RankState] = _field(default_factory=dict)
    _lock: threading.Lock = _field(default_factory=threading.Lock)

    def observe_step(self, rank: int, wall_ms: float) -> str | None:
        """Fold one step wall time for ``rank``; returns "degraded" /
        "recovered" on a capacity transition, else None. Emits a
        ``rank_health`` telemetry record (store row) per observation."""
        if not env_health.is_straggler_detect_enable():
            return None
        alpha = env_health.straggler_ewma_alpha()
        with self._lock:
            st = self._ranks.setdefault(int(rank), _RankState())
            st.count += 1
            st.since_change = min(st.since_change + 1, 1 << 30)
            st.ewma_ms = (
                float(wall_ms)
                if st.ewma_ms is None
                else alpha * float(wall_ms) + (1.0 - alpha) * st.ewma_ms
            )
            transition = self._evaluate(st)
            ewma, cap = st.ewma_ms, st.capacity
        _registry.record_event(
            "rank_health",
            rank=int(rank),
            wall_ms=float(wall_ms),
            ewma_ms=ewma,
            capacity=cap,
            degraded=cap < 1.0,
            **({"transition": transition} if transition else {}),
        )
        return transition

    def _evaluate(self, st: _RankState) -> str | None:
        """Hysteresis state machine for one rank (lock held)."""
        if st.count < env_health.straggler_min_steps():
            return None
        # per-unit-work EWMA: a degraded rank only runs a capacity share
        # of the plan, so divide by capacity before comparing
        norm = [
            s.ewma_ms / s.capacity
            for s in self._ranks.values()
            if s.ewma_ms is not None and s.capacity >= 1.0
        ]
        if not norm:
            norm = [
                s.ewma_ms / s.capacity
                for s in self._ranks.values()
                if s.ewma_ms is not None
            ]
        ref = statistics.median(norm) if norm else 0.0
        if ref <= 0.0 or st.ewma_ms is None:
            return None
        slowness = (st.ewma_ms / st.capacity) / ref
        if st.since_change < env_health.straggler_cooldown_steps():
            return None
        if st.capacity >= 1.0:
            if slowness >= env_health.straggler_enter_ratio():
                st.capacity = _quantize_capacity(1.0 / slowness)
                st.since_change = 0
                return "degraded"
        elif slowness <= env_health.straggler_exit_ratio():
            # recovery is the only exit; capacity stays frozen otherwise
            st.capacity = 1.0
            st.since_change = 0
            return "recovered"
        return None

    def capacities(self, cp_size: int) -> tuple[float, ...] | None:
        """Active capacity vector, or None when uniform (all healthy)."""
        with self._lock:
            caps = tuple(
                self._ranks[r].capacity if r in self._ranks else 1.0
                for r in range(cp_size)
            )
        if all(c == caps[0] for c in caps):
            return None
        return caps

    def reset(self) -> None:
        with self._lock:
            self._ranks.clear()


_monitor: RankHealthMonitor | None = None
_monitor_lock = threading.Lock()


def get_monitor() -> RankHealthMonitor:
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = RankHealthMonitor()
        return _monitor


def reset() -> None:
    global _monitor
    with _monitor_lock:
        _monitor = None


def observe_step(rank: int, wall_ms: float) -> str | None:
    return get_monitor().observe_step(rank, wall_ms)


def observe_attn_step(payload: dict) -> None:
    """Collector hook: fold an ``attn_step`` record's per-rank wall times
    (optional ``rank_wall_ms`` list) into the monitor. Cheap no-op unless
    straggler detection is on and the record carries the field."""
    if not env_health.is_straggler_detect_enable():
        return
    rank_wall = payload.get("rank_wall_ms")
    if not rank_wall:
        return
    mon = get_monitor()
    for rank, wall_ms in enumerate(rank_wall):
        if wall_ms is not None:
            mon.observe_step(rank, float(wall_ms))


def active_capacities(cp_size: int) -> tuple[float, ...] | None:
    """The capacity vector plan keys should carry right now — None when
    detection is off or every rank is healthy (uniform ⇒ byte-identical
    plan signatures). The ``rank_health_read`` chaos site covers this
    read: an injected fault degrades to the uniform all-ones vector when
    fallback is enabled, else propagates typed."""
    if not env_health.is_straggler_detect_enable():
        return None
    from ..resilience.inject import maybe_inject

    try:
        maybe_inject("rank_health_read")
    except Exception as e:
        from ..resilience.errors import InjectedFault

        if not isinstance(e, InjectedFault):
            raise
        from ..env import resilience as env_resilience

        if not env_resilience.is_fallback_enable():
            raise
        from ..resilience.fallback import record_resilience_event

        record_resilience_event(
            "fallback", "rank_health_read",
            action_detail="uniform_capacities", error=type(e).__name__,
        )
        return None
    return get_monitor().capacities(cp_size)
