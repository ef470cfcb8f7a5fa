"""The port's benchmark harness (``benchmarking/``) against the JAX package's.

- ``do_bench``: one fake ``time.perf_counter`` sequence gives both packages
  identical quantiles on the CPU; with no GPU and no device named the port
  raises.
- ``do_bench_scan_slope``: JAX's slope-timing pins (paired slopes, median,
  noise guard, credibility floor) under one fake scan runner, JAX on its
  TPU branch and the port on its CUDA branch: equal to each other and to
  the expected value, exactly; off the card the port takes the short
  chain and ignores the floor. The CPU scan runner calls the body
  ``length`` times a run.
- The anti-DCE bodies against JAX's on seeded inputs (1e-6, float32);
  their extra carry leaves come back as the same objects.
- ``Benchmark`` / ``perf_report`` rows, ``_print_table`` text and
  ``_save_csv`` files equal JAX's; the perf-history CSVs and
  ``history_report`` text equal JAX's with the commit and clock frozen.
- The executed-flops floor and the card constants.
"""

import csv
import datetime
import importlib
import math
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magiattention_tpu.benchmarking.bench as jbench
import magiattention_tpu.benchmarking.perf_report as jpr
from magiattention_tpu_torch.benchmarking import bench as pbench
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

# the module: the package exports the decorator ``perf_report`` too
ppr = importlib.import_module("magiattention_tpu_torch.benchmarking.perf_report")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# do_bench
# ---------------------------------------------------------------------------


def _fake_clock(monkeypatch, seq):
    """Install a ``time.perf_counter`` that returns ``seq`` in turn;
    returns a function that restarts the sequence."""
    state = {}

    def restart():
        state["it"] = iter(seq)

    restart()
    monkeypatch.setattr(time, "perf_counter", lambda: next(state["it"]))
    return restart


@pytest.mark.parametrize("rep,quantiles", [(5, (0.5, 0.2, 0.8)), (8, (0.1, 0.5, 0.9, 1.0))])
def test_do_bench_quantiles_equal_jax(monkeypatch, rep, quantiles):
    rng = np.random.default_rng(rep)
    stamps = np.cumsum(rng.uniform(1e-4, 5e-3, 2 * rep)).tolist()
    restart = _fake_clock(monkeypatch, stamps)
    calls = []
    want = jbench.do_bench(lambda: calls.append(1), warmup=2, rep=rep, quantiles=quantiles)
    n_jax = len(calls)
    restart()
    got = pbench.do_bench(lambda: calls.append(1), warmup=2, rep=rep, quantiles=quantiles,
                          device="cpu")
    assert got == want
    assert len(calls) == 2 * n_jax == 2 * (2 + rep)


def test_do_bench_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pbench.do_bench(lambda: None)


# ---------------------------------------------------------------------------
# do_bench_scan_slope: JAX's pins (tests/test_support/test_slope_timing.py)
# ---------------------------------------------------------------------------


def _fake_runners(monkeypatch, module, per_step_ms, launch_ms_seq):
    """Each runner call consumes the next fixed launch cost: total seconds
    = (launch + per_step * length) / 1e3 (the JAX test's fake)."""
    calls = iter(launch_ms_seq)

    def make(body, carry0, length, device=None):
        def run():
            return (next(calls) + per_step_ms * length) / 1e3

        return run

    monkeypatch.setattr(module, "_make_scan_runner", make)


# (per-step ms, launch costs of the six runs, min_credible_ms or a
# (flops, ceiling TFLOP/s) pair for credible_floor_ms, expected ms)
SLOPE_CASES = {
    # constant 170 ms launch cost, true per-step 2.0 ms
    "slope_cancels_fixed_launch_cost": (2.0, [170.0] * 6, None, 2.0),
    # rep 2's long run sees +60 ms drift: the median of three slopes holds
    "median_rejects_one_drifted_pair": (
        2.0, [170.0, 170.0, 170.0, 230.0, 170.0, 170.0], None, 2.0),
    # long consistently FASTER than short: fall back to t_long / length
    "noise_guard_falls_back_to_long_upper_bound": (
        0.0, [200.0, 64.0, 200.0, 64.0, 200.0, 64.0], None, 64.0 / 32),
    # slope 0.5 ms/step under a 2.0 ms floor: the long upper bound
    "credibility_floor_rejects_unphysical_slope": (
        0.5, [170.0] * 6, 2.0, (170.0 + 0.5 * 32) / 32),
    "floor_does_not_touch_physical_slopes": (3.0, [170.0] * 6, 2.0, 3.0),
    # the floor from each package's credible_floor_ms at one ceiling:
    # 1e12 flops at 500 TFLOP/s is 2.0 ms
    "credible_floor_flags_a_rate_above_the_ceiling": (
        0.5, [170.0] * 6, (1e12, 500.0), (170.0 + 0.5 * 32) / 32),
    "credible_floor_passes_a_rate_below_the_ceiling": (
        3.0, [170.0] * 6, (1e12, 500.0), 3.0),
}


@pytest.mark.parametrize("case", list(SLOPE_CASES))
def test_slope_case_equals_jax(monkeypatch, case):
    per_step, launches, floor, want = SLOPE_CASES[case]
    monkeypatch.setattr(jbench.jax, "default_backend", lambda: "tpu")
    got = {}
    for name, module, pr, kw in (("jax", jbench, jpr, {}), ("port", pbench, ppr, {"device": "cuda"})):
        _fake_runners(monkeypatch, module, per_step, launches)
        min_ms = pr.credible_floor_ms(*floor) if isinstance(floor, tuple) else floor
        got[name] = module.do_bench_scan_slope(
            lambda c: c, 0, lengths=(8, 32), reps=3, min_credible_ms=min_ms, **kw
        )
    assert got["port"] == got["jax"] == want


def test_slope_detail_reports_reps_and_guard(monkeypatch):
    _fake_runners(monkeypatch, pbench, 0.5, [170.0] * 6)
    detail = {}
    ms = pbench.do_bench_scan_slope(lambda c: c, 0, lengths=(8, 32), reps=3,
                                    min_credible_ms=2.0, device="cuda", detail=detail)
    assert ms == detail["t_long_ms"] == (170.0 + 0.5 * 32) / 32
    assert detail["guard"] == "floor" and len(detail["slopes"]) == 3
    with pytest.raises(ValueError, match="longer"):
        pbench.do_bench_scan_slope(lambda c: c, 0, lengths=(32, 8), device="cuda")


@pytest.mark.parametrize("min_credible_ms", [None, 50.0])
def test_off_card_branch_ignores_floor(monkeypatch, min_credible_ms):
    monkeypatch.setattr(jbench.jax, "default_backend", lambda: "cpu")
    called = []

    def fake_scan(body, carry0, length, reps, device=None):
        called.append((length, reps))
        return 1.0

    for module, kw in ((jbench, {}), (pbench, {"device": "cpu"})):
        monkeypatch.setattr(module, "do_bench_scan", fake_scan)
        ms = module.do_bench_scan_slope(lambda c: c, 0, min_credible_ms=min_credible_ms, **kw)
        assert ms == 1.0
    assert called == [(2, 3), (2, 3)]


@pytest.mark.parametrize("length", [1, 3, 8])
def test_cpu_scan_runner_calls_body_length_times(length):
    calls = []

    def body(carry):
        calls.append(1)
        q, k = carry
        return (q + 1.0, k)

    carry0 = (torch.zeros(4), torch.ones(2))
    time_once = pbench._make_scan_runner(body, carry0, length, torch.device("cpu"))
    assert calls == []
    for n in (1, 2):
        assert time_once() >= 0.0
        assert len(calls) == n * length
    assert pbench.do_bench_scan(body, carry0, length=length, reps=2, device="cpu") >= 0.0
    assert len(calls) == 4 * length


def test_scan_runner_takes_tensor_carries_only():
    with pytest.raises(TypeError, match="tuple of tensors"):
        pbench._make_scan_runner(lambda c: c, (torch.zeros(2), 0), 2, torch.device("cpu"))


def test_floor_matches_measured_ceiling():
    flops = 1e12
    ms = ppr.credible_floor_ms(flops)
    assert flops / (ms * 1e-3) / 1e12 == pytest.approx(ppr.MEASURED_CEILING_TFLOPS)


# ---------------------------------------------------------------------------
# anti-DCE bodies
# ---------------------------------------------------------------------------


def _qkvw(seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(4)]


def _jgrad(q, k, v):
    return jax.grad(lambda q, k, v: jnp.sum(q @ k.T @ v), argnums=(0, 1, 2))(q, k, v)


def _tgrad(q, k, v):
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    q_, k_, v_ = leaves
    return torch.autograd.grad((q_ @ k_.T @ v_).sum(), leaves)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_fwd_kv_body_equals_jax():
    arrs = _qkvw(1)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    jo = jbench.make_fwd_kv_body(lambda q, k, v, w: (q @ k.T @ v) * w, jnp.float32)(tuple(j))
    to = pbench.make_fwd_kv_body(lambda q, k, v, w: (q @ k.T @ v) * w, torch.float32)(tuple(t))
    _close(to[0], jo[0])
    assert all(a is b for a, b in zip(to[1:], t[1:]))


def test_consume_all_grads_kv_body_equals_jax():
    arrs = _qkvw(2)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    jo = jbench.make_consume_all_grads_kv_body(lambda q, k, v, w: _jgrad(q, k, v), jnp.float32)(tuple(j))
    to = pbench.make_consume_all_grads_kv_body(lambda q, k, v, w: _tgrad(q, k, v), torch.float32)(tuple(t))
    _close(to[0], jo[0])
    assert all(a is b for a, b in zip(to[1:], t[1:]))
    # dq enters scaled 1e-3; dk/dv only through the 1e-30 touch term
    assert float((to[0] - t[0]).abs().max()) > 1e-6


def test_consume_all_grads_body_equals_jax():
    q, k, v, _ = _qkvw(3)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jo = jbench.make_consume_all_grads_body(lambda q: _jgrad(q, jk, jv), jnp.float32)(jnp.asarray(q))
    to = pbench.make_consume_all_grads_body(lambda q: _tgrad(q, tk, tv), torch.float32)(torch.from_numpy(q))
    _close(to, jo)
    assert to.dtype == torch.float32


# ---------------------------------------------------------------------------
# Benchmark / perf_report, the table and the CSV
# ---------------------------------------------------------------------------


def _sweep(module):
    spec = module.Benchmark(
        x_names=["seqlen"], x_vals=[1024, 4096], line_arg="mask",
        line_vals=["causal", "full", "broken"], line_names=["causal", "full", "broken"],
        args={"scale": 0.5},
    )

    @module.perf_report(spec)
    def point(seqlen, mask, scale):
        if mask == "broken":
            raise ValueError("no such mask")
        return seqlen * scale / (3.0 if mask == "causal" else 7.0)

    return point


def _same_rows(got: list[dict], want: list[dict]) -> None:
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for key in w:
            if isinstance(w[key], float) and math.isnan(w[key]):
                assert math.isnan(g[key]), key
            else:
                assert g[key] == w[key], key


def test_perf_report_rows_equal_jax():
    want = _sweep(jbench).run(print_data=False)
    got = _sweep(pbench).run(print_data=False)
    _same_rows(got, want)
    assert got[0]["broken_error"] == "ValueError"


def test_print_table_bytes_equal_jax(capsys):
    _sweep(jbench).run(print_data=True)
    want = capsys.readouterr().out
    _sweep(pbench).run(print_data=True)
    got = capsys.readouterr().out
    assert got == want and "broken_error" in got


def test_save_csv_bytes_equal_jax(tmp_path):
    _sweep(jbench).run(print_data=False, save_path=str(tmp_path / "jax.csv"))
    _sweep(pbench).run(print_data=False, save_path=str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


# ---------------------------------------------------------------------------
# the perf history (tests/test_support/test_perf_report.py's sequences)
# ---------------------------------------------------------------------------


class _FrozenDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=tz)


HISTORY_CASES = {
    "append_and_report": (
        [{"mask": "causal", "seqlen": 4096, "tflops": 10.0},
         {"mask": "causal", "seqlen": 4096, "tflops": 25.0},
         {"mask": "video", "seqlen": 4096, "tflops": 40.0}],
        [(["mask", "seqlen"], "tflops")],
    ),
    "suspect_rows_never_set_a_baseline": (
        [{"mask": "full", "seqlen": 8192, "tflops": 80.0},
         {"mask": "full", "seqlen": 8192, "tflops": 250.5, "suspect": 1}],
        [(["mask", "seqlen"], "tflops")],
    ),
    "phase_suspect_taints_only_that_phase": (
        [{"mask": "full", "seqlen": 8192, "fwd_tflops": 70.0, "fwdbwd_tflops": 60.0},
         {"mask": "full", "seqlen": 8192, "fwd_tflops": 250.5, "fwdbwd_tflops": 81.5,
          "suspect_fwd": 1}],
        [(["mask", "seqlen"], "fwd_tflops"), (["mask", "seqlen"], "fwdbwd_tflops")],
    ),
    "schema_evolution_rewrites_header": (
        [{"a": 1}, {"a": 2, "b": 3}, {"a": 4}],
        [(["b"], "a")],
    ),
    "report_without_history_is_empty": ([], [(["x"], "y")]),
}


@pytest.mark.parametrize("case", list(HISTORY_CASES))
def test_history_equals_jax(monkeypatch, tmp_path, case):
    rows, reports = HISTORY_CASES[case]
    frozen = types.SimpleNamespace(datetime=_FrozenDatetime, timezone=datetime.timezone)
    out = {}
    for name, pr in (("jax", jpr), ("port", ppr)):
        monkeypatch.setattr(pr, "HISTORY_DIR", str(tmp_path / name))
        monkeypatch.setattr(pr, "_git_rev", lambda: "abc1234")
        monkeypatch.setattr(pr, "datetime", frozen)
        paths = [pr.append_row("k", dict(r)) for r in rows]
        assert all(paths) and len(set(paths)) <= 1
        out[name] = [pr.history_report("k", keys, col) for keys, col in reports]
        path = tmp_path / name / "k.csv"
        out[name + "_csv"] = path.read_bytes() if path.exists() else None
    assert out["port"] == out["jax"]
    assert out["port_csv"] == out["jax_csv"]
    if rows:
        assert len(list(csv.DictReader(open(tmp_path / "port" / "k.csv")))) == len(rows)
    else:
        assert out["port"] == [""]


def test_append_never_raises(monkeypatch):
    monkeypatch.setattr(ppr, "HISTORY_DIR", "/proc/definitely/not/writable")
    assert ppr.append_row("k", {"a": 1}) == ""


def test_history_dir_is_the_port_build_tree():
    assert ppr.HISTORY_DIR == os.path.join(REPO, "build", "perf_history")
    assert ppr._git_rev()  # the repo root's commit, or "unknown"


# ---------------------------------------------------------------------------
# the executed-flops floor and the card constants
# ---------------------------------------------------------------------------


def test_fwdbwd_floor_uses_executed_flops():
    """The split backward's fwd+bwd floor must come from EXECUTED flops
    (4.5x fwd): a reference-convention (3.5x) floor sits ~29% below the
    physical bound and waves through unphysical slopes. A slope whose
    model-convention rate is 2% above the executed-flops ceiling passes
    the 3.5x floor and is flagged by the executed one; a slope at 80% of
    it clears the executed floor."""
    fwd_flops = 4 * (8192 * 8193 // 2) * 128 * 16  # the headline GQA shape
    flops_ref = fwd_flops * 3.5
    flops_hw = flops_ref * ppr.HW_FWD_BWD_RATIO
    model_tflops = (ppr.MEASURED_CEILING_TFLOPS / ppr.HW_FWD_BWD_RATIO) * 1.02
    slope_ms = flops_ref / (model_tflops * 1e9)

    old_floor = ppr.credible_floor_ms(flops_ref)
    new_floor = ppr.credible_floor_ms(flops_hw)
    assert slope_ms > old_floor, "old floor should have passed this slope"
    assert slope_ms < new_floor, "executed-flops floor must flag it"
    implied_hw = flops_hw / (slope_ms * 1e-3) / 1e12
    assert implied_hw > ppr.MEASURED_CEILING_TFLOPS
    ok_ms = flops_ref / (0.8 * ppr.MEASURED_CEILING_TFLOPS / ppr.HW_FWD_BWD_RATIO * 1e9)
    assert ok_ms > new_floor


def test_peak_is_the_h100_data_sheet_bf16_rate():
    assert ppr.PEAK_TFLOPS == ppr.card_peaks("NVIDIA H100 80GB HBM3")["bfloat16"] / 1e12
    assert ppr.HW_FWD_BWD_RATIO == 4.5 / 3.5


def test_measured_ceiling_within_the_peak():
    assert 0 < ppr.MEASURED_CEILING_TFLOPS <= ppr.PEAK_TFLOPS * 1.05


@pytest.mark.parametrize("name,form", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 NVL", "H100 NVL"), ("NVIDIA A100-SXM4-80GB", None),
])
def test_card_peaks_by_name(name, form):
    if form is None:
        with pytest.raises(RuntimeError, match="no peak figures"):
            ppr.card_peaks(name)
    else:
        assert ppr.card_peaks(name)["form"] == form
