"""Measured-vs-modeled drift: close the loop on the open-loop cost models
(the port's copy of ``magiattention_tpu/telemetry/drift.py``).

Three cost models steer planning with hard-coded constants and no feedback:

- ``tile_policy``'s block score ``w * (bq*bk + OVERHEAD_ELEMS)`` (fwd tile
  choice and the mixed-dispatch split decision; in the port one constant
  per dtype, ``OVERHEAD_ELEMS[itemsize]``, fitted on the card),
- ``choose_bwd_mode``'s arithmetic-intensity model (split vs fused bwd),
- the overlap solver's ``two_level_makespan`` (ICI x DCN stage packing,
  ``dcn_per_row = 8.0``).

The store (telemetry/store.py) accumulates ``obs`` rows pairing each
model's *predicted* cost (model units) with the *measured* wall ms.
:func:`scan` fits a single global scale per model (least squares through
the origin — model units to ms), flags observations whose relative error
after scaling exceeds ``MAGI_ATTENTION_DRIFT_THRESHOLD``, and emits them
as ``model_drift`` telemetry records (which the collector ingests back
into the store, so drift findings persist across runs and show up in
``scripts/telemetry_report.py``).

:func:`fit_constants` goes one step further: it refits the models' free
constants from history — ``overhead_elems.<itemsize>`` (one per dtype, the
port's ``OVERHEAD_ELEMS`` keys) from the (tile area, work count)
components of the tile score, ``dcn_per_row`` from (ici rows, dcn rows)
makespan observations — and writes them as ``calib`` rows that
``tile_policy`` / ``overlap_solver`` consume via ``store.calibrated()``
when ``MAGI_ATTENTION_CALIBRATION`` is on.
"""

from __future__ import annotations

from typing import Any, Iterable

from ..env import backend as env_backend
from . import registry as telemetry
from . import store as tstore
from .store import StoreState

# a model needs at least this many observations before scale fitting /
# drift flagging is meaningful
MIN_SAMPLES = 3


def fit_scale(pairs: Iterable[tuple[float, float]]) -> float:
    """Least-squares scale a (through the origin) for measured ≈ a*predicted."""
    num = 0.0
    den = 0.0
    for pred, meas in pairs:
        num += pred * meas
        den += pred * pred
    return num / den if den > 0 else 0.0


def _fit2(
    xs: list[float], ys: list[float], ms: list[float]
) -> tuple[float, float] | None:
    """Least squares for ms ≈ a*x + b*y (2x2 normal equations)."""
    sxx = sum(x * x for x in xs)
    syy = sum(y * y for y in ys)
    sxy = sum(x * y for x, y in zip(xs, ys))
    sxm = sum(x * m for x, m in zip(xs, ms))
    sym = sum(y * m for y, m in zip(ys, ms))
    det = sxx * syy - sxy * sxy
    if abs(det) < 1e-12 * max(sxx, syy, 1.0):
        return None  # degenerate: the two regressors are collinear
    a = (sxm * syy - sym * sxy) / det
    b = (sym * sxx - sxm * sxy) / det
    return a, b


def scan(
    state: StoreState | None = None,
    threshold: float | None = None,
    emit: bool = True,
) -> list[dict[str, Any]]:
    """Flag observations whose scaled prediction misses the measurement.

    Returns the findings; with ``emit`` also records each as a
    ``model_drift`` telemetry event (no-op when telemetry is off), which
    the collector's store ingest persists as a ``drift`` row."""
    if state is None:
        st = tstore.get_store()
        if st is None:
            return []
        state = st.load()
    thr = env_backend.drift_threshold() if threshold is None else threshold
    findings: list[dict[str, Any]] = []
    for model, obs in sorted(state.observations.items()):
        if len(obs) < MIN_SAMPLES:
            continue
        alpha = fit_scale(
            (o["predicted"], o["measured_ms"]) for o in obs
        )
        if alpha <= 0:
            continue
        for o in obs:
            pred_ms = alpha * o["predicted"]
            rel = abs(pred_ms - o["measured_ms"]) / max(o["measured_ms"], 1e-9)
            if rel <= thr:
                continue
            finding = {
                "model": model,
                "alpha": alpha,
                "rel_err": rel,
                "predicted": o["predicted"],
                "predicted_ms": pred_ms,
                "measured_ms": o["measured_ms"],
                "extras": o.get("extras") or {},
            }
            findings.append(finding)
            if emit:
                telemetry.record_event("model_drift", **finding)
    return findings


def fit_constants(
    state: StoreState | None = None, persist: bool = True
) -> dict[str, float]:
    """Refit model constants from observation history.

    - ``overhead_elems.<itemsize>``: tile score is ``area +
      works*OVERHEAD``; fitting ms ≈ a*area + b*works over one dtype's
      observations gives its OVERHEAD = b/a in element units.
    - ``dcn_per_row``: makespan costs ICI rows at 1.0 and DCN rows at
      ``dcn_per_row``; fitting ms ≈ a*ici_rows + b*dcn_rows gives b/a.

    Returns the fitted values (only keys with a sane positive fit) and,
    with ``persist`` and an active store, writes ``calib`` rows."""
    if state is None:
        st = tstore.get_store()
        if st is None:
            return {}
        state = st.load()
    fitted: dict[str, tuple[float, int]] = {}

    def fit_ratio(obs: list, xf: str, yf: str) -> tuple[float, int] | None:
        obs = [
            o
            for o in obs
            if o.get("extras", {}).get(xf) is not None
            and o.get("extras", {}).get(yf) is not None
        ]
        if len(obs) < MIN_SAMPLES:
            return None
        ab = _fit2(
            [float(o["extras"][xf]) for o in obs],
            [float(o["extras"][yf]) for o in obs],
            [o["measured_ms"] for o in obs],
        )
        if ab is None or ab[0] <= 0 or ab[1] <= 0:
            return None
        return ab[1] / ab[0], len(obs)

    tile_obs = state.observations.get("tile_score", [])
    for itemsize in sorted({
        o.get("extras", {}).get("itemsize") for o in tile_obs
    } - {None}):
        r = fit_ratio(
            [o for o in tile_obs if o["extras"].get("itemsize") == itemsize],
            "area", "works",
        )
        if r is not None:
            fitted[f"overhead_elems.{itemsize}"] = r
    r2 = fit_ratio(
        state.observations.get("two_level_makespan", []), "ici_rows", "dcn_rows"
    )
    if r2 is not None:
        fitted["dcn_per_row"] = r2
    if persist and fitted:
        st = tstore.get_store()
        if st is not None:
            for name, (value, n) in fitted.items():
                st.record_calibration(name, value, n)
    return {name: value for name, (value, _) in fitted.items()}
