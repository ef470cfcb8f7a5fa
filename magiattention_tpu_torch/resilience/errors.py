"""Typed errors of the serving slice.

The port's copy of the one member of ``magiattention_tpu/resilience/errors.py``
that its serving path raises. The base class keeps the reference's name so
callers can catch the family the same way.
"""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base of the typed runtime errors."""


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
