"""Typed env-flag getters (never raw ``os.environ`` at call sites)."""

from . import backend, comm, general, health, kernel, resilience, serve  # noqa: F401
