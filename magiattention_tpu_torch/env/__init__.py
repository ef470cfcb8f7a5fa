"""Typed env-flag getters (never raw ``os.environ`` at call sites)."""

from . import backend, comm, general, kernel, serve  # noqa: F401
