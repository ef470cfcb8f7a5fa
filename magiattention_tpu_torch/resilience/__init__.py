"""Resilience layer: fault injection, numeric guards, degradation chains
and the step watchdog (the port's copy of ``magiattention_tpu/resilience/``).

This package must stay import-light: it is pulled in by the kernels and
the functional layer, so importing it must not drag in kernels/comm/
functional modules (fallback.py and watchdog.py lazy-import what they need
inside functions).
"""

from .errors import (
    FallbackExhaustedError,
    FaultSpecError,
    InjectedFault,
    NumericGuardError,
    PageExhaustedError,
    ResilienceError,
    UnknownLoweringError,
)
from .guards import check_outputs
from .inject import (
    INJECTION_SITES,
    FaultSpec,
    maybe_inject,
    parse_fault_spec,
    reset,
    should_fire,
)

__all__ = [
    "ResilienceError",
    "FaultSpecError",
    "InjectedFault",
    "NumericGuardError",
    "FallbackExhaustedError",
    "PageExhaustedError",
    "UnknownLoweringError",
    "check_outputs",
    "INJECTION_SITES",
    "FaultSpec",
    "maybe_inject",
    "parse_fault_spec",
    "reset",
    "should_fire",
]
