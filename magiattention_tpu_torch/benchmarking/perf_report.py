"""Append-only perf history + round-over-round deltas, and the card's
peak figures.

Every measurement appends one row to a CSV under ``build/perf_history/``
(ignored by git), so each run on the card extends a comparable record
instead of overwriting a JSON blob. ``history_report`` renders the latest
row per config with a delta against the previous measurement of the same
config.

Dual MFU convention: rows carry the reference's FLOP counting (fwd =
4*area*d*hq, bwd = 2.5x) for comparability, plus the executed matmul
work of the backward mode that ran (:data:`HW_FWD_BWD_RATIO` for the
split pair; the fused kernel runs the reference's 3.5x).
"""

from __future__ import annotations

import csv
import datetime
import os
import subprocess

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
HISTORY_DIR = os.path.join(_REPO, "build", "perf_history")

# actual matmul work per reported (reference-convention) FLOP for fwd+bwd
# under the split backward (B3 dq + B5/B6 dk/dv, the deterministic mode):
# reported = fwd * 3.5 (fwd + 2.5x bwd), executed = fwd * 4.5 (fwd + 3.5x
# bwd: the dq pass's 3 products + the dk/dv pass's 4 against the fwd's 2).
# The fused backward (B8/B9, the unpinned pick at the headline shape) runs
# 5 products, 2.5x the forward: its executed work is the reported 3.5x
# (ratio 1.0). A caller passes credible_floor_ms the executed flops of the
# mode that ran (kernels/ffa.py:ffa_bwd_mode).
HW_FWD_BWD_RATIO = 4.5 / 3.5

# (name substring, bf16 dense FLOP/s, fp32 CUDA-core FLOP/s, TF32 dense
# FLOP/s, HBM bytes/s): NVIDIA's data sheets, dense tensor-core rates
PEAKS = (
    ("H100 NVL", 835e12, 60e12, 417.5e12, 3.9e12),
    ("H100 PCIe", 756e12, 51e12, 378e12, 2.0e12),
    ("H100", 989e12, 67e12, 494.7e12, 3.35e12),  # SXM5 (HBM3)
)


def card_peaks(name: str) -> dict:
    """The peak figures of the card named ``name``
    (``torch.cuda.get_device_name``)."""
    for key, bf16, f32, tf32, bw in PEAKS:
        if key in name:
            return {"form": key, "bfloat16": bf16, "float32": f32, "tfloat32": tf32,
                    "bytes_s": bw}
    raise RuntimeError(f"no peak figures for card {name!r}")


# nominal dense bf16 peak of the NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
# limit, TFLOP/s: a data-sheet figure (PEAKS' "H100" row), the ONE
# definition every harness's MFU figures use
PEAK_TFLOPS = 989.0

# MEASURED bf16 matmul ceiling of that card, TFLOP/s: the highest of 14
# runs (710.8-737.1) of chip_smoke.py's benchmarking phase, the slope of a
# chained 8192^3 torch.matmul through do_bench_scan_slope at lengths
# (24, 96), on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (74.5%
# of PEAK_TFLOPS: the card holds its power limit under a dense bf16
# product) — the ONE anchor for credibility floors. Anchoring to the
# measured ceiling (not PEAK * slack) means a genuine measurement at the
# card's real matmul rate is never classified unphysical.
MEASURED_CEILING_TFLOPS = 737.1


def credible_floor_ms(
    flops: float, ceiling_tflops: float = MEASURED_CEILING_TFLOPS
) -> float:
    """Physical lower bound on a measurement of ``flops`` of matmul work:
    time implying a rate above the measured card ceiling is unphysical
    (pass as ``do_bench_scan_slope(min_credible_ms=...)``). ``flops``
    must be EXECUTED flops — for fwd+bwd under the split backward that is
    4.5x fwd (HW_FWD_BWD_RATIO x the reference-convention 3.5x), under the
    fused one 3.5x — or the floor sits below the physical bound it
    claims."""
    return flops / (ceiling_tflops * 1e9)


def _git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10, cwd=_REPO,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def append_row(name: str, row: dict) -> str:
    """Append one measurement to ``build/perf_history/<name>.csv``.

    Adds ``utc`` and ``commit`` columns automatically. The header is the
    union of all keys ever seen for this file (the file is rewritten with
    an extended header when a new key appears — files are small).
    Never raises: history is best-effort and must not cost a measurement.
    """
    try:
        os.makedirs(HISTORY_DIR, exist_ok=True)
        path = os.path.join(HISTORY_DIR, f"{name}.csv")
        full = {
            "utc": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y-%m-%d %H:%M:%S"
            ),
            "commit": _git_rev(),
            **row,
        }
        # MAGI_ATTENTION_TELEMETRY=1: stamp the row with the run's comm /
        # balance context (tel_* columns) so a perf number carries the plan
        # that produced it. Empty dict (no extra columns) when off.
        from .. import telemetry

        full.update(
            {k: v for k, v in telemetry.flat_summary().items()
             if k not in full}
        )
        rows: list[dict] = []
        header: list[str] = []
        if os.path.exists(path):
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                header = list(reader.fieldnames or [])
                rows = list(reader)
        new_keys = [k for k in full if k not in header]
        if new_keys:
            header = header + new_keys
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=header, restval="")
                w.writeheader()
                for r in rows:
                    w.writerow(r)
                w.writerow(full)
        else:
            with open(path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=header, restval="").writerow(
                    full
                )
        return path
    except Exception:
        return ""


def history_report(name: str, key_cols: list[str], value_col: str) -> str:
    """Latest row per config key with a delta vs the previous measurement.

    Returns a plain-text table (empty string when no history exists).
    """
    path = os.path.join(HISTORY_DIR, f"{name}.csv")
    if not os.path.exists(path):
        return ""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    phase = value_col.split("_")[0]  # fwd_tflops -> fwd, fwdbwd_ms -> fwdbwd
    by_key: dict[tuple, list[dict]] = {}
    for r in rows:
        if r.get("suspect") or r.get(f"suspect_{phase}"):
            # harness marked the measurement unphysical (rate above the
            # card ceiling even at the long chain's upper bound) — keep the
            # raw row in the CSV but never let it set a baseline. Plain
            # "suspect" taints the whole row; "suspect_<phase>" taints
            # only that phase's columns, so a bad fwd slope doesn't
            # suppress the same row's valid fwdbwd measurement.
            continue
        by_key.setdefault(tuple(r.get(k, "") for k in key_cols), []).append(r)
    lines = [
        f"# {name}: latest {value_col} per ({', '.join(key_cols)}) "
        f"with delta vs previous"
    ]
    for key, rs in sorted(by_key.items()):
        cur = rs[-1]
        try:
            val = float(cur.get(value_col) or "nan")
        except ValueError:
            continue
        delta = ""
        for prev in reversed(rs[:-1]):
            try:
                pv = float(prev.get(value_col) or "nan")
            except ValueError:
                continue
            if pv == pv and pv != 0:
                delta = f" ({(val - pv) / pv * 100:+.1f}% vs {prev['utc']})"
                break
        lines.append(
            f"{'/'.join(key)}: {value_col}={val:g} [{cur['utc']} "
            f"{cur.get('commit', '')}]{delta}"
        )
    return "\n".join(lines)
