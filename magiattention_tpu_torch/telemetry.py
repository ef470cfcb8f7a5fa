"""Telemetry hooks of the copied planners, off.

The JAX package records solver and runtime events when
``MAGI_ATTENTION_TELEMETRY=1``; the port has no telemetry layer yet
(ROADMAP queue A10), so :func:`enabled` is False and every guarded record
in the planners is skipped.
"""

from __future__ import annotations


def enabled() -> bool:
    return False


def record_event(kind: str, **payload) -> None:
    """No-op (see the module docstring)."""
