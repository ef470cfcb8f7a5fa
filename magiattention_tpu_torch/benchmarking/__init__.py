"""Benchmark harness (ref: magi_attention/benchmarking/bench.py)."""

from .bench import Benchmark, do_bench, do_bench_flops, perf_report  # noqa: F401
