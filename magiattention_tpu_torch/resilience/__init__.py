"""Typed runtime errors."""

from .errors import PageExhaustedError, ResilienceError  # noqa: F401
