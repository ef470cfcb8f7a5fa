"""Step watchdog: bounded retry through backend rungs + numeric quarantine
(the port's copy of ``magiattention_tpu/resilience/watchdog.py``).

Enabled by ``MAGI_ATTENTION_STEP_RETRIES`` > 0 (env/resilience.py). Where
the FALLBACK=1 kernel ladder (resilience/fallback.py) descends *tile*
rungs within one backend, the watchdog retries a failed ``calc_attn`` step
through the backend registry's ``calc_attn`` ladder itself — and treats a
numeric-guard trip (``MAGI_ATTENTION_NUMERIC_GUARD=raise``) exactly like a
kernel failure, so a transient NaN burns one retry instead of the run.

Quarantine: ``QUARANTINE_TRIPS`` failures of the same backend on the same
decision key (the runtime's ``_policy_key``: mask-class x mesh x env)
quarantine that backend for the key — persisted as a store row
(``rk="quarantine"``, telemetry/store.py) so restarts remember. The last
ladder rung (the reference dense path) is never quarantined: a step can
always run somewhere.

A step that fails every attempted rung re-raises the last typed error
(NumericGuardError / InjectedFault / the kernel's runtime error) — the
watchdog never invents a new failure mode. With STEP_RETRIES unset this
module is never imported on the step path.

The port's departures. On the card the ladder's plain PyTorch rungs
(``sdpa``, ``sdpa_online``; ``fallback.PLAIN_RUNGS``) are left out, so
the kernel rung (``ffa``) is the last and is never quarantined, and each
retry runs it again: a transient fault burns one retry, a lasting one
re-raises. At cp > 1 only an injected fault is retried: its seeded stream
fires on every rank at the same call, so every rank retries together,
while a NaN, a launch error or an out-of-memory may strike one rank alone,
whose retry would re-issue its collectives out of step with its peers.
"""

from __future__ import annotations

import threading
from typing import Any

from .. import telemetry
from ..env import resilience as env_resilience
from .errors import FallbackExhaustedError, InjectedFault, NumericGuardError
from .guards import check_outputs
from .inject import maybe_inject, should_fire

# numeric/kernel trips on one (key, backend) before it is quarantined
QUARANTINE_TRIPS = 2

_lock = threading.Lock()
_trips: dict[tuple[str, str], int] = {}
_quarantined: set[tuple[str, str]] = set()


def reset() -> None:
    """Drop in-process trip/quarantine state (tests)."""
    with _lock:
        _trips.clear()
        _quarantined.clear()


def _decision_key(runtime) -> Any:
    pk = getattr(runtime, "_policy_key", None)
    if callable(pk):
        try:
            return pk()
        except Exception:
            pass
    return type(runtime).__name__


def _canonical(key: Any) -> str:
    from ..telemetry.store import canonical_key

    return canonical_key(key)


def is_quarantined(key: Any, backend: str) -> bool:
    """In-process quarantine plus the store's restart-persistent rows."""
    ck = _canonical(key)
    with _lock:
        if (ck, backend) in _quarantined:
            return True
    from ..telemetry import store as tstore

    return backend in tstore.quarantined_backends("calc_attn", key)


def note_trip(key: Any, backend: str, allow_quarantine: bool) -> bool:
    """Count one trip; returns True when this trip quarantines the
    backend (threshold crossed, persisted via the store when active)."""
    ck = _canonical(key)
    with _lock:
        trips = _trips[(ck, backend)] = _trips.get((ck, backend), 0) + 1
        if (
            not allow_quarantine
            or trips < QUARANTINE_TRIPS
            or (ck, backend) in _quarantined
        ):
            return False
        _quarantined.add((ck, backend))
    from ..telemetry import store as tstore

    tstore.record_quarantine("calc_attn", key, backend, trips)
    from .fallback import record_resilience_event

    record_resilience_event(
        "quarantine", "step_retry", backend=backend, trips=trips,
    )
    return True


def run_with_watchdog(runtime, q, k, v, return_max_logits: bool = False):
    """Bounded-retry execution of one calc_attn step (both CP runtimes).

    Attempt 0 runs the runtime's resolved backend; each further attempt
    moves one rung down ``registry.ladder("calc_attn")``, skipping
    quarantined rungs (the final rung always stays eligible); on the card
    past the plain rungs, re-running the last kernel rung instead. Success
    on a retry pins the surviving backend (sticky, like the FALLBACK
    ladder).
    """
    from .fallback import (
        _corrupt_output,
        card_rungs,
        kernel_failure_types,
        on_card,
        record_resilience_event,
    )
    from ..kernels import registry as kernel_registry

    stage = f"{type(runtime).__name__}.calc_attn"
    if getattr(runtime, "cp_size", 1) > 1:
        failures: tuple[type[BaseException], ...] = (InjectedFault,)
    else:
        failures = kernel_failure_types(1) + (NumericGuardError,)
    retries = env_resilience.step_retries()
    key = _decision_key(runtime)
    start = runtime.backend
    card = on_card(q)
    rungs = list(kernel_registry.ladder("calc_attn", start)) or [start]
    if start not in rungs:
        rungs = [start] + rungs
    # on the card: the kernel rungs only (a pinned plain start stays)
    rungs = [start] + card_rungs("calc_attn", rungs[1:], card)
    usable = [
        b
        for i, b in enumerate(rungs)
        if i == len(rungs) - 1 or not is_quarantined(key, b)
    ]
    attempts = usable[: retries + 1]
    if card:
        # the last kernel rung again for each retry left
        attempts += attempts[-1:] * (retries + 1 - len(attempts))
    prev_override = runtime._backend_override
    last_err: BaseException | None = None
    for idx, backend in enumerate(attempts):
        if idx > 0:
            # chaos site: the retry hop itself can fault
            try:
                maybe_inject("step_retry")
            except InjectedFault as e:
                if not env_resilience.is_fallback_enable():
                    runtime._backend_override = prev_override
                    raise
                record_resilience_event(
                    "fallback", "step_retry",
                    action_detail="retry_continue", error=type(e).__name__,
                )
        if backend != start:
            # also covers attempt 0 when the start rung is quarantined
            runtime._backend_override = backend
            runtime._auto_tile_pending = False
        try:
            result = runtime._calc_attn_impl(q, k, v, return_max_logits)
            if should_fire("nan_output"):
                result = (_corrupt_output(result[0]), *result[1:])
            check_outputs(stage, result[0], result[1])
        except failures as e:
            last_err = e
            nxt = attempts[idx + 1] if idx + 1 < len(attempts) else None
            quarantined_now = note_trip(
                key, backend, allow_quarantine=backend != rungs[-1]
            )
            telemetry.record_event(
                "step_retry",
                stage=stage,
                attempt=idx,
                from_backend=backend,
                to_backend=nxt,
                error=type(e).__name__,
                quarantined=quarantined_now,
            )
            record_resilience_event(
                "retry", "step_retry",
                attempt=idx, backend=backend, error=type(e).__name__,
            )
            continue
        if idx > 0:
            # sticky: later steps keep the surviving rung
            record_resilience_event(
                "recovered", "step_retry",
                action_detail="backend_rung", backend=backend, attempt=idx,
            )
        return result
    runtime._backend_override = prev_override
    if last_err is not None:
        raise last_err
    raise FallbackExhaustedError(
        f"step watchdog found no eligible backend rung for {stage}"
    )
