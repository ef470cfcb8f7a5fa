"""Straggler-detection toggles: the port's copy of
``magiattention_tpu/env/health.py``, with the same flag names.

All default OFF / conservative: with MAGI_ATTENTION_STRAGGLER_DETECT unset
the health monitor is never consulted and plan keys carry no capacity
vector, so plan signatures stay byte-identical to a build without this
module. None of these are [key] flags: the *derived capacity vector* rides
the runtime key itself (dist_attn_runtime_mgr._plan_signature), so two
processes with different thresholds but the same derived vector still share
cached plans.
"""

from __future__ import annotations

from .general import _get_bool, _get_float, _get_int


def is_straggler_detect_enable() -> bool:
    """Master gate for straggler detection (telemetry/health.py): fold
    per-rank step wall times into a capacity vector and re-solve dispatch
    plans weighted by it. Off (default): capacities are always None."""
    return _get_bool("MAGI_ATTENTION_STRAGGLER_DETECT")


def straggler_ewma_alpha() -> float:
    """EWMA smoothing factor for per-rank wall-time tracking (0 < a <= 1;
    higher = reacts faster to the latest step)."""
    return min(1.0, max(0.01, _get_float("MAGI_ATTENTION_STRAGGLER_EWMA", 0.3)))


def straggler_enter_ratio() -> float:
    """Slowness ratio (rank EWMA / healthy median) at which a rank enters
    degraded state. Must exceed the exit ratio for hysteresis."""
    return _get_float("MAGI_ATTENTION_STRAGGLER_ENTER", 2.0)


def straggler_exit_ratio() -> float:
    """Slowness ratio below which a degraded rank recovers to full
    capacity. Kept below the enter ratio so a rank hovering at the
    threshold does not flap the plan."""
    return _get_float("MAGI_ATTENTION_STRAGGLER_EXIT", 1.2)


def straggler_cooldown_steps() -> int:
    """Minimum observations between capacity changes for one rank: after a
    transition the rank's capacity is frozen this many steps, so one noisy
    step never flips the plan twice."""
    return max(1, _get_int("MAGI_ATTENTION_STRAGGLER_COOLDOWN", 8))


def straggler_min_steps() -> int:
    """Observations required per rank before it can be judged degraded —
    the EWMA needs history before the ratio means anything."""
    return max(1, _get_int("MAGI_ATTENTION_STRAGGLER_MIN_STEPS", 4))
