"""Profiling hooks of the copied planners, inert.

The JAX package wraps its planners in xprof host spans when
``MAGI_ATTENTION_PROFILE_MODE=1``; the port has no profiling layer yet
(ROADMAP queue A10), so :func:`instrument_host` returns the function as it
is.
"""

from __future__ import annotations


def instrument_host(fn):
    return fn
