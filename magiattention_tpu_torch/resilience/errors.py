"""Typed error hierarchy of the resilience layer (the port's copy of
``magiattention_tpu/resilience/errors.py``).

Every failure the layer can surface is a :class:`ResilienceError` subclass,
so callers can catch the whole family — or one member — without string
matching. The range-shaped validation errors in solver/comm code use
:class:`~..common.range.RangeError` (a ValueError) instead; the two
hierarchies deliberately do not overlap: RangeError means *your inputs are
malformed*, ResilienceError means *the pipeline failed (or was made to
fail) at runtime*.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base of every error raised by the resilience layer."""


class FaultSpecError(ResilienceError, ValueError):
    """MAGI_ATTENTION_FAULT_INJECT does not parse, or names an
    unregistered injection site."""


class InjectedFault(ResilienceError):
    """A registered fault-injection site fired (resilience/inject.py).

    Carries ``site`` so recovery code and tests can assert exactly which
    site tripped.
    """

    def __init__(self, site: str, call: int) -> None:
        self.site = site
        self.call = call
        super().__init__(
            f"injected fault at site '{site}' (arming call #{call}) — "
            "MAGI_ATTENTION_FAULT_INJECT is set"
        )


class NumericGuardError(ResilienceError):
    """A numeric sentinel found NaN/Inf in attention outputs
    (MAGI_ATTENTION_NUMERIC_GUARD=raise). Carries ``stage``."""

    def __init__(self, stage: str, detail: str) -> None:
        self.stage = stage
        self.detail = detail
        super().__init__(
            f"numeric guard tripped at stage '{stage}': {detail}"
        )


class FallbackExhaustedError(ResilienceError):
    """Every rung of a degradation chain failed — including the final
    reference path. Chains from the first failure via __cause__."""


class PageExhaustedError(ResilienceError):
    """The serving page pool cannot satisfy an allocation and no request
    is evictable (serving/cache.py PagePool). Carries ``requested`` and
    ``free`` so admission control and tests can assert the deficit."""

    def __init__(self, requested: int, free: int) -> None:
        self.requested = requested
        self.free = free
        super().__init__(
            f"KV page pool exhausted: requested {requested} page(s) with "
            f"{free} free and nothing evictable"
        )


class UnknownLoweringError(ResilienceError, ValueError):
    """A comm dispatcher received a lowering kind it does not implement —
    silently running the wrong collective would corrupt data, so this
    fails loudly instead. (The port's casts have one lowering, the
    all-to-all; the type is kept with the family.)"""
