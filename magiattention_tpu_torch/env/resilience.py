"""Resilience toggles: the port's copy of
``magiattention_tpu/env/resilience.py``, with the same flag names.

Four flags gate the resilience layer (fault injection, numeric guards,
degradation chains, the step watchdog). All default off: with every flag
unset the guarded call paths are never entered, so ``calc_attn`` reads no
clock and allocates nothing extra (``tests/test_torch_telemetry.py``).
"""

from __future__ import annotations

from .general import _get_bool, _get_int, _get_str


def fault_inject_spec() -> str:
    """Fault-injection spec string (resilience/inject.py grammar:
    ``site[:p=<float>][:seed=<int>][:step=<int>][:count=<int>]``,
    comma-separated). Empty (default) disables the injector entirely."""
    return _get_str("MAGI_ATTENTION_FAULT_INJECT", "")


def numeric_guard_policy() -> str:
    """Numeric sentinel policy for attention outputs/LSE:
    ``""`` (default) — guards off; ``raise`` (or ``1``) — raise a typed
    NumericGuardError naming the stage; ``record`` — telemetry counter
    only. Guards force a host sync per step when on."""
    val = _get_str("MAGI_ATTENTION_NUMERIC_GUARD", "").lower()
    if val in ("", "0"):
        return ""
    return "record" if val == "record" else "raise"


def is_fallback_enable() -> bool:
    """Enable graceful degradation chains (resilience/fallback.py): FFA
    kernel failures retry down the tile ladder then the sdpa_online
    reference path; dynamic-plan solve failures fall back to the static
    solver; runtime plan builds get one bounded retry. Off (default):
    failures propagate unchanged. A kernel build failure is never
    recovered, under any flag."""
    return _get_bool("MAGI_ATTENTION_FALLBACK")


def step_retries() -> int:
    """Step-watchdog retry budget (resilience/watchdog.py): a kernel
    failure or numeric-guard trip inside ``calc_attn`` retries the step
    through the backend registry's next rung, at most this many extra
    attempts. 0 (default) disables the watchdog entirely — failures
    propagate exactly as before. Deliberately NOT a [key] flag: the
    watchdog changes execution, not the plan."""
    return max(0, _get_int("MAGI_ATTENTION_STEP_RETRIES", 0))


def is_resilience_active() -> bool:
    """ONE gate for the guarded call paths: any of the flags set.
    Kept to a few dict lookups so the off path stays free."""
    return bool(
        fault_inject_spec()
        or numeric_guard_policy()
        or is_fallback_enable()
        or step_retries()
    )
