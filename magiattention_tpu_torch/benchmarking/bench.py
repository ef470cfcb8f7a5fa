"""Perf harness (ref: magi_attention/benchmarking/bench.py:47-1378).

Triton-style ``do_bench`` / ``perf_report`` for PyTorch on a CUDA card.
Every entry point takes ``device`` (None: the current CUDA device, and it
raises when no GPU is visible; ``"cpu"``: host clocks over the plain
versions, for tests). On the card, :func:`do_bench` brackets each call
with a CUDA event pair, and the scan timings replay ``length`` chained
calls of a body captured in one CUDA graph, so the host's launch work is
out of the timed replays; no path times eagerly on the card or falls back
to the CPU.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device


def _echo(msg: str) -> None:
    """Benchmark-table output channel. The harness's tables and timing
    lines ARE its product (chip logs consume them), so they must not be
    gated behind MAGI_ATTENTION_LOG_LEVEL like library logging."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def do_bench(
    fn: Callable[[], Any],
    warmup: int = 3,
    rep: int = 20,
    quantiles: Sequence[float] = (0.5, 0.2, 0.8),
    device: torch.device | str | None = None,
) -> list[float]:
    """Time fn() in milliseconds; returns the requested quantiles.

    On CUDA: ``warmup`` calls and a synchronize, then each call between a
    pair of CUDA events on the device's current stream, synchronized after
    the call (the time from the first launch to the last result, the
    host's launch work included where the device waits on it). On the
    CPU: ``time.perf_counter`` around each call."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    times = []
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        for _ in range(rep):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn()
            end.record(stream)
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
    else:
        for _ in range(rep):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return [float(np.quantile(times, q)) for q in quantiles]


def do_bench_flops(
    fn: Callable[[], Any], flops: float, **kwargs
) -> tuple[float, float]:
    """(median ms, TFLOP/s)."""
    ms = do_bench(fn, **kwargs)[0]
    return ms, flops / (ms * 1e-3) / 1e12


def do_bench_mem(
    fn: Callable[[], Any], bytes_moved: float, **kwargs
) -> tuple[float, float]:
    """(median ms, GB/s)."""
    ms = do_bench(fn, **kwargs)[0]
    return ms, bytes_moved / (ms * 1e-3) / 1e9


def _leaves(carry: Any) -> tuple[torch.Tensor, ...]:
    """A scan carry's tensors: a tensor or a tuple of tensors."""
    leaves = carry if isinstance(carry, tuple) else (carry,)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("a scan carry is a tensor or a tuple of tensors")
    return leaves


def _make_scan_runner(
    body: Callable[[Any], Any], carry0: Any, length: int, device: torch.device
) -> Callable[[], float]:
    """Build a ``length``-step chain of ``body`` from ``carry0``; returns
    a closure that runs it once and returns total wall SECONDS, ending in
    a fetch of one value of the first leaf (the chain's data dependence
    keeps every step).

    On CUDA the chain is captured once in a CUDA graph (the counterpart of
    JAX's one jitted ``lax.scan``): ``body`` runs three times on a side
    stream first (kernel builds, shared-memory attributes, the allocator),
    ``carry0`` is copied into static buffers, the graph is replayed once
    (JAX's warm run), and each call replays it, synchronizes and fetches;
    its time includes the graph's one launch. Host work in ``body``
    (planning, argument checks) runs at capture only, as a jitted body's
    tracing does. A body that cannot be captured (a host sync inside it)
    raises. On the CPU each call runs ``length`` chained calls of
    ``body``."""
    is_tuple = isinstance(carry0, tuple)
    leaves = _leaves(carry0)

    def chain(c):
        for _ in range(length):
            c = body(c)
        return c

    if device.type != "cuda":
        def time_once_cpu() -> float:
            t0 = time.perf_counter()
            out = chain(carry0)
            _leaves(out)[0].reshape(-1)[0].item()
            return time.perf_counter() - t0

        return time_once_cpu

    with torch.cuda.device(device):
        static = tuple(t.detach().clone() for t in leaves)
        c0 = static if is_tuple else static[0]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body(c0)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = chain(c0)
        except RuntimeError as e:
            name = getattr(body, "__qualname__", repr(body))
            raise RuntimeError(
                f"scan body {name} cannot be captured in a CUDA graph (a host "
                f"sync inside it?): {e}"
            ) from e
        graph.replay()  # warm
        torch.cuda.synchronize()
    first = _leaves(out)[0]

    def time_once() -> float:
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(device)
        first.reshape(-1)[0].item()
        return time.perf_counter() - t0

    return time_once


def do_bench_scan(
    body: Callable[[Any], Any],
    carry0: Any,
    length: int = 8,
    reps: int = 3,
    device: torch.device | str | None = None,
) -> float:
    """Per-iteration ms of ``body`` chained ``length`` times in one CUDA
    graph (:func:`_make_scan_runner`; on the CPU a plain loop): the one
    launch's cost amortizes over the chain. ``body`` must map carry ->
    carry of identical shapes and dtypes."""
    time_once = _make_scan_runner(body, carry0, length, resolve_device(device))
    return min(time_once() for _ in range(reps)) / length * 1e3


def do_bench_scan_slope(
    body: Callable[[Any], Any],
    carry0: Any,
    lengths: tuple[int, int] = (24, 96),
    reps: int = 3,
    verbose: bool = False,
    min_credible_ms: float | None = None,
    device: torch.device | str | None = None,
    detail: dict | None = None,
) -> float:
    """Overhead-robust per-iteration ms of ``body``.

    Any single-chain timing folds the fixed cost of one launch and the
    final fetch into the per-step number. This helper times the SAME
    chained body at two lengths and returns the slope (T_long - T_short)
    / (L_long - L_short): the fixed cost appears in both totals and
    cancels exactly. Per-step cost must be length-independent (it is: one
    captured body, carried data dependence) for the slope to equal the
    true step time. On a CUDA graph the fixed cost is tens of microseconds,
    below the run-to-run spread of a long chain on a card that holds its
    power limit: the noise guard below then fires on genuine pairs, and
    its fallback, the long chain's per-step time, carries only the fixed
    cost over ``L_long`` steps.

    Off the card (the resolved device is not CUDA) there is no launch
    cost to cancel and the plain versions' steps are slow, so a short
    single chain is the right measurement, and the floor is not applied.

    ``min_credible_ms``: physical floor on the per-step time (the caller
    knows its flop count and the card's ceiling; the slope does not). A
    slope BELOW the floor is an under-cancelled pair and triggers the same
    fallback as the noise guard — the long chain's per-step time, a true
    upper bound.

    ``detail``: a dict, when given, filled with the per-rep ``slopes``,
    ``short_ms`` and ``long_ms`` (each rep's two totals), ``t_long_ms``
    (the long chain's best per-step time), ``guard`` (None, ``"noise"``
    or ``"floor"``) and ``seconds`` (capture included).
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return do_bench_scan(body, carry0, length=2, reps=reps, device=dev)
    short, long_ = lengths
    if long_ <= short:
        raise ValueError(f"lengths {lengths}: the second must be the longer")
    t0 = time.perf_counter()

    run_short = _make_scan_runner(body, carry0, short, dev)
    run_long = _make_scan_runner(body, carry0, long_, dev)
    # PAIRED reps: each rep times short and long back-to-back so both see
    # the same conditions, then contributes its own slope; the median
    # rejects a rep whose overhead drifted mid-pair. (Independent
    # best-of-reps runs would subtract overhead samples from different
    # moments.)
    slopes = []
    totals = []
    t_long_best = float("inf")
    for _ in range(max(reps, 2)):
        ts = run_short() * 1e3
        tl = run_long() * 1e3
        t_long_best = min(t_long_best, tl / long_)
        slopes.append((tl - ts) / (long_ - short))
        totals.append((ts, tl))
    slope = float(np.median(slopes))
    ok = 0.0 < slope <= t_long_best
    floor_hit = (
        ok and min_credible_ms is not None and slope < min_credible_ms
    )
    if floor_hit:
        ok = False
    if detail is not None:
        detail.update(
            slopes=slopes, short_ms=[t[0] for t in totals],
            long_ms=[t[1] for t in totals], t_long_ms=t_long_best,
            guard=None if ok else ("floor" if floor_hit else "noise"),
            seconds=time.perf_counter() - t0,
        )
    if verbose:
        if floor_hit:
            from .perf_report import MEASURED_CEILING_TFLOPS

            # the floor is anchored at the measured card ceiling, so the
            # implied rate scales as floor/slope
            implied_tf = MEASURED_CEILING_TFLOPS * min_credible_ms / slope
        guard = "" if ok else (
            f" -> CREDIBILITY FLOOR ({min_credible_ms:.3f} ms): slope "
            f"implies a rate above the chip ceiling "
            f"({implied_tf:.0f} TF/s > {MEASURED_CEILING_TFLOPS:.0f}) — "
            f"under-cancelled pair, fallback to "
            f"len{long_} upper bound {t_long_best:.3f}"
            if floor_hit else
            f" -> NOISE GUARD: fallback to len{long_} upper bound "
            f"{t_long_best:.3f}"
        )
        _echo(
            f"  [slope timing incl compile {time.perf_counter()-t0:.0f}s: "
            f"per-rep slopes {[round(s, 3) for s in slopes]} ms/step"
            + guard
        )
    # noise guard: non-positive slope (long ran FASTER than short) or slope
    # above the long chain's per-step time (negative implied overhead)
    # means the pair is still contaminated; the long chain's per-step time
    # is a true upper bound on the step time.
    if not ok:
        return t_long_best
    return slope


def do_bench_scan_verbose(body, carry0, length=8, reps=3, device=None):
    """:func:`do_bench_scan` + a one-line wall-clock print (chip logs want
    the capture time visible)."""
    t0 = time.perf_counter()
    ms = do_bench_scan(body, carry0, length=length, reps=reps, device=device)
    _echo(f"  [total incl compile {time.perf_counter()-t0:.0f}s]")
    return ms


def make_consume_all_grads_body(grad_fn, dtype):
    """Timing body ``q -> q`` that consumes ALL of (dq, dk, dv).

    ``grad_fn(q) -> (dq, dk, dv)``; dq enters the carry scaled by 1e-3,
    dk/dv as a 1e-30-scaled scalar in dk's dtype — numerically invisible,
    but a real data dependence. In JAX it keeps XLA from dead-code
    eliminating the dk/dv kernel; eager PyTorch and a captured graph drop
    no launch, but the contract stays so that each step's q waits on the
    previous step's dk and dv, and a body ported from a JAX harness times
    the same work. Use :func:`make_consume_all_grads_kv_body` when k/v
    should ride in the carry.
    """

    def body(q):
        dq, dk, dv = grad_fn(q)
        touch = (dk.sum() + dv.sum()) * 1e-30
        return (q + 1e-3 * dq.to(dtype) + touch.to(dtype)).to(dtype)

    return body


def make_consume_all_grads_kv_body(grad_fn, dtype):
    """`make_consume_all_grads_body` variant whose carry is ``(q, k, v)``.

    Same anti-DCE contract: ``grad_fn(q, k, v, *aux) -> (dq, dk, dv)``, all
    three consumed; any further carry leaves (e.g. a large cotangent seed
    w) ride through unchanged, as the same objects. In JAX the carry keeps
    GB-scale operands out of the compiled program's constants; here it
    keeps them among the captured graph's static inputs.
    """

    def body(carry):
        q, k, v, *aux = carry
        dq, dk, dv = grad_fn(q, k, v, *aux)
        touch = (dk.sum() + dv.sum()) * 1e-30
        qn = (q + 1e-3 * dq.to(dtype) + touch.to(dtype)).to(dtype)
        return (qn, k, v, *aux)

    return body


def make_fwd_kv_body(fwd_fn, dtype):
    """Forward-only timing body with a ``(q, k, v, *aux)`` carry:
    ``fwd_fn(q, k, v, *aux) -> out`` (out must be q-shaped) is called with
    every operand as a carry leaf, and the out->q chain provides the data
    dependence between steps."""

    def body(carry):
        q, k, v, *aux = carry
        return (fwd_fn(q, k, v, *aux).to(dtype), k, v, *aux)

    return body


@dataclass
class Benchmark:
    """Declarative sweep spec (ref Benchmark/Mark :372)."""

    x_names: list[str]
    x_vals: list[Any]
    line_arg: str
    line_vals: list[Any]
    line_names: list[str]
    ylabel: str = "TFLOP/s"
    plot_name: str = "bench"
    args: dict[str, Any] = field(default_factory=dict)


def perf_report(benchmark: Benchmark):
    """Decorator: fn(**point) -> float; run() sweeps and returns rows. A
    point that raises gives ``nan`` and ``<line>_error`` = the exception's
    type name."""

    def wrap(fn):
        def run(print_data: bool = True, save_path: str | None = None):
            rows = []
            for xv in benchmark.x_vals:
                row = {benchmark.x_names[0]: xv}
                for lv, ln in zip(benchmark.line_vals, benchmark.line_names):
                    kwargs = dict(benchmark.args)
                    kwargs[benchmark.x_names[0]] = xv
                    kwargs[benchmark.line_arg] = lv
                    try:
                        row[ln] = fn(**kwargs)
                    except Exception as e:  # noqa: BLE001
                        row[ln] = float("nan")
                        row[f"{ln}_error"] = type(e).__name__
                rows.append(row)
            if print_data:
                _print_table(rows)
            if save_path:
                _save_csv(rows, save_path)
            return rows

        fn.run = run
        return fn

    return wrap


def _print_table(rows: list[dict]) -> None:
    if not rows:
        return
    keys = list(rows[0].keys())
    widths = [max(len(str(k)), 12) for k in keys]
    _echo("  ".join(str(k).ljust(w) for k, w in zip(keys, widths)))
    for row in rows:
        _echo(
            "  ".join(
                (f"{row.get(k, ''):.2f}" if isinstance(row.get(k), float)
                 else str(row.get(k, ""))).ljust(w)
                for k, w in zip(keys, widths)
            )
        )


def _save_csv(rows: list[dict], path: str) -> None:
    import csv

    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
