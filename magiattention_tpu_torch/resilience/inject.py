"""Deterministic, seedable fault injection (the port's copy of
``magiattention_tpu/resilience/inject.py``: the same grammar, sites and
firing streams).

Gated by ``MAGI_ATTENTION_FAULT_INJECT`` (env/resilience.py). The spec is a
comma-separated list of per-site clauses::

    site[:p=<float>][:seed=<int>][:step=<int>][:count=<int>]

    kernel_lowering:p=1.0:seed=7     # fire on every arming call
    comm_plan_build:count=1          # fire once, then go quiet
    nan_output:step=2                # fire on exactly the 2nd arming call

- ``p``     firing probability per arming call (default 1.0), drawn from a
            per-site ``random.Random(seed)`` stream — reruns with the same
            spec fire on the same calls.
- ``seed``  stream seed (default 0).
- ``step``  fire on exactly the Nth arming call (1-based); overrides ``p``.
- ``count`` cap on total firings for the site (default unlimited).

Sites are the registered names in :data:`INJECTION_SITES`; an unknown site
in the spec raises :class:`~.errors.FaultSpecError` at first use. Every
firing emits a ``resilience`` telemetry record (action="inject") and bumps
the ``resilience.injected`` counter, so ``scripts/telemetry_report.py``
can reconstruct what a chaos run actually exercised.

With the flag unset, :func:`maybe_inject` / :func:`should_fire` are one
env lookup + early return — no injector object is ever built (pinned by
tests/test_torch_resilience.py).

At cp > 1 every rank parses the same spec and draws from the same seeded
stream at the same arming calls, so an injected fault fires on every rank
at the same step, and each rank's recovery issues the same collectives.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass

from .. import telemetry
from ..env import resilience as env_resilience
from .errors import FaultSpecError, InjectedFault

# every named failure point of the JAX package (the same tuple, so one
# spec parses alike in both); the plan-tier sites (plan_serialize,
# plan_cache_read, plan_broadcast) are not armed in the port yet
INJECTION_SITES: tuple[str, ...] = (
    "kernel_lowering",    # FFA kernel dispatch (kernels/ffa.py)
    "vmem_check",         # tile-policy shared-memory scoring (kernels/tile_policy.py)
    "dynamic_plan_solve",  # qo-comm planner (meta/_make_attn_meta.py)
    "comm_plan_build",    # static comm-plan build (meta/_make_attn_meta.py)
    "nan_output",         # post-kernel output corruption (resilience/fallback.py)
    "serve_decode",       # paged-decode serving rung (serving/decode.py)
    "plan_serialize",     # plan wire encoding (meta/plan_io.py)
    "plan_cache_read",    # on-disk plan store read (meta/plan_store.py)
    "plan_broadcast",     # cross-host plan broadcast (meta/plan_broadcast.py)
    "rank_health_read",   # capacity-vector read at key planning (telemetry/health.py)
    "weighted_solve",     # capacity-weighted dispatch solve (meta/_make_dispatch_meta.py)
    "step_retry",         # step-watchdog backend retry (resilience/watchdog.py)
)


@dataclass(frozen=True)
class FaultSpec:
    """One parsed clause of the injection spec."""

    site: str
    p: float = 1.0
    seed: int = 0
    step: int | None = None
    count: int | None = None


def parse_fault_spec(spec: str) -> dict[str, FaultSpec]:
    """Parse the full env value into {site: FaultSpec}. Raises
    :class:`FaultSpecError` on grammar errors or unregistered sites."""
    out: dict[str, FaultSpec] = {}
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        site = parts[0].strip()
        if site not in INJECTION_SITES:
            raise FaultSpecError(
                f"unknown injection site '{site}' in "
                f"MAGI_ATTENTION_FAULT_INJECT={spec!r}; registered sites: "
                f"{', '.join(INJECTION_SITES)}"
            )
        kwargs: dict = {}
        for field in parts[1:]:
            if "=" not in field:
                raise FaultSpecError(
                    f"malformed field '{field}' in clause '{clause}' "
                    "(expected key=value)"
                )
            key, _, val = field.partition("=")
            key = key.strip()
            try:
                if key == "p":
                    kwargs["p"] = float(val)
                elif key in ("seed", "step", "count"):
                    kwargs[key] = int(val)
                else:
                    raise FaultSpecError(
                        f"unknown field '{key}' in clause '{clause}' "
                        "(known: p, seed, step, count)"
                    )
            except ValueError as e:
                if isinstance(e, FaultSpecError):
                    raise
                raise FaultSpecError(
                    f"bad value '{val}' for field '{key}' in clause "
                    f"'{clause}'"
                ) from e
        if site in out:
            raise FaultSpecError(
                f"site '{site}' appears twice in "
                f"MAGI_ATTENTION_FAULT_INJECT={spec!r}"
            )
        out[site] = FaultSpec(site=site, **kwargs)
    return out


class FaultInjector:
    """Per-process injector state for one parsed spec: per-site arming-call
    counters, firing counts, and seeded RNG streams."""

    def __init__(self, spec_string: str) -> None:
        self.spec_string = spec_string
        self.specs = parse_fault_spec(spec_string)
        self._lock = threading.Lock()
        self._calls = {s: 0 for s in self.specs}
        self._fired = {s: 0 for s in self.specs}
        self._rng = {
            s: random.Random(spec.seed) for s, spec in self.specs.items()
        }

    def arm(self, site: str) -> bool:
        """One arming call at ``site``; returns True when the fault fires."""
        spec = self.specs.get(site)
        if spec is None:
            return False
        with self._lock:
            self._calls[site] += 1
            call = self._calls[site]
            if spec.count is not None and self._fired[site] >= spec.count:
                return False
            if spec.step is not None:
                fire = call == spec.step
            else:
                # the draw happens on EVERY arming call so firing patterns
                # depend only on (seed, call index), not on prior outcomes
                fire = self._rng[site].random() < spec.p
            if fire:
                self._fired[site] += 1
        if fire:
            telemetry.inc("resilience.injected", always=True)
            telemetry.record_event(
                "resilience", action="inject", site=site, call=call,
                spec=self.spec_string,
            )
        return fire

    def stats(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {
                s: {"calls": self._calls[s], "fired": self._fired[s]}
                for s in self.specs
            }


_injector: FaultInjector | None = None
_injector_lock = threading.Lock()

def get_injector() -> FaultInjector | None:
    """The process-global injector, or None when the flag is unset.
    Rebuilt when the spec string changes (tests monkeypatch the env)."""
    spec = env_resilience.fault_inject_spec()
    if not spec:
        return None
    global _injector
    with _injector_lock:
        if _injector is None or _injector.spec_string != spec:
            _injector = FaultInjector(spec)
        return _injector


def reset() -> None:
    """Drop injector state (tests: fresh counters per test)."""
    global _injector
    with _injector_lock:
        _injector = None


def should_fire(site: str) -> bool:
    """Arm ``site`` and report whether the fault fires (no raise) — used
    where the fault is a corruption, not an exception (nan_output)."""
    if site not in INJECTION_SITES:
        raise FaultSpecError(
            f"maybe_inject/should_fire called with unregistered site "
            f"'{site}'; add it to resilience.inject.INJECTION_SITES"
        )
    inj = get_injector()
    if inj is None:
        return False
    return inj.arm(site)


def maybe_inject(site: str) -> None:
    """Arm ``site``; raise :class:`InjectedFault` when it fires. The one
    call instrumented code adds at each registered failure point."""
    if should_fire(site):
        inj = get_injector()
        call = inj._calls[site] if inj is not None else 0
        raise InjectedFault(site, call)
