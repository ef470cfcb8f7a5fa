"""Fault-injection sites of the copied planners, inert.

The JAX package's injector (``MAGI_ATTENTION_FAULT_INJECT``) is not ported
yet (ROADMAP queue A10); :func:`maybe_inject` never raises.
"""

from __future__ import annotations


def maybe_inject(site: str) -> None:
    """No-op (see the module docstring)."""
