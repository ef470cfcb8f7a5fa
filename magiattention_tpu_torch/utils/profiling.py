"""Tracing / profiling helpers (the port's counterpart of
``magiattention_tpu/utils/profiling.py``; ref: magi_attention/utils/nvtx.py).

The JAX package names its regions with ``jax.named_scope`` (HLO metadata,
xprof) and ``jax.profiler.TraceAnnotation`` (host spans). Here every region
is a ``torch.profiler.record_function`` range, so it shows in a torch
profiler trace (``export_chrome_trace``) around the kernels launched in it,
and, when a card is present, an NVTX range too, for Nsight. The scope names
are the JAX package's: ``ffa_fwd_stage{i}``, ``lse_merge``,
``ffa_bwd_delta``, ``ffa_bwd``, ``group_cast_stage{i}``,
``group_reduce_<lowering>``, ``qo_comm_cast``, ``ffa_fwd_dyn``,
``DistAttnRuntime.calc_attn``, ``DynamicDistAttnRuntime.calc_attn`` and the
planners' function names.

Everything is gated on ``MAGI_ATTENTION_PROFILE_MODE``, read per call: with
it unset each helper calls the function or runs the block as it is.
"""

from __future__ import annotations

import functools
import os
import tempfile
from contextlib import contextmanager
from typing import Callable

import torch

from ..env import general as env_general


@contextmanager
def _range(name: str):
    """One profiler range (and an NVTX range on a card)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def instrument_scope(fn: Callable | None = None, *, name: str | None = None):
    """Decorator wrapping a function in a profiler range named ``name``
    (default: its qualified name), the ``instrument_nvtx`` equivalent.
    Gated on MAGI_ATTENTION_PROFILE_MODE."""

    def wrap(f):
        scope = name or f.__qualname__

        @functools.wraps(f)
        def inner(*args, **kwargs):
            if not env_general.is_profile_mode_enable():
                return f(*args, **kwargs)
            with _range(scope):
                return f(*args, **kwargs)

        return inner

    return wrap(fn) if fn is not None else wrap


@contextmanager
def profile_scope(name: str):
    """An inline profiler range gated on MAGI_ATTENTION_PROFILE_MODE, for
    loop bodies (per-stage kernels and casts) a decorator cannot reach."""
    if not env_general.is_profile_mode_enable():
        yield
    else:
        with _range(name):
            yield


# host-side regions (planners, plan builders) take the same ranges: the
# port has no traced program, so host and device regions are alike
instrument_host = instrument_scope
add_profile_event = profile_scope


class switch_profile:
    """Start/stop a ``torch.profiler`` window (ref nvtx.py:110
    switch_profile); on stop the trace is written to
    ``<log_dir>/trace.json`` (Chrome trace format, CPU and, with a card,
    CUDA activity).

    Usable explicitly or as a context manager (exception-safe: the window
    is closed even when the body raises)::

        prof = switch_profile(log_dir="trace_dir")
        prof.start(); ...steps...; prof.stop()

        with switch_profile(log_dir="trace_dir") as prof:
            ...steps...
        prof.profiler.key_averages()
    """

    def __init__(self, log_dir: str | None = None) -> None:
        self.log_dir = log_dir or os.path.join(tempfile.gettempdir(), "magiattention_trace")
        self.profiler: torch.profiler.profile | None = None
        self._running = False

    @property
    def trace_path(self) -> str:
        return os.path.join(self.log_dir, "trace.json")

    def start(self) -> None:
        if self._running:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.profiler.__enter__()
        self._running = True

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self.profiler.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profiler.export_chrome_trace(self.trace_path)

    def __enter__(self) -> "switch_profile":
        self.start()
        return self

    def __exit__(self, *exc_info) -> None:
        self.stop()
