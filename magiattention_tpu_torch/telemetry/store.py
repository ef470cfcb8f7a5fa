"""Persistent cross-run telemetry store — the observatory's memory (the
port's copy of ``magiattention_tpu/telemetry/store.py``: the same row
kinds and snapshot).

Where telemetry/registry.py streams write-only per-process JSONL, this
module keeps a small *readable* history that survives restarts and is
shared by every process pointing at the same directory:

- ``history-<host>-<pid>-<token>.jsonl`` — append-only rows, one writer
  per file, each line written atomically (O_APPEND, single write; see
  telemetry/export.py). Safe for any number of concurrent writers.
- ``store.json`` — compacted snapshot, replaced atomically via a temp
  file + ``os.replace``. :meth:`TelemetryStore.compact` folds all history
  files into it; run compaction when no writers are active (end of run,
  CI, or the report tool) — a writer whose open file is deleted under it
  loses subsequent rows.

Row kinds (``rk`` field):

- ``measure`` — one timed execution of a backend for a registry decision
  key; aggregated into per-(decision, key, backend) count/sum/min so the
  policy layer can pick the fastest *measured* backend.
- ``policy``  — a resolved registry decision, persisted so a warm restart
  re-uses it with zero re-tuning (kernels/registry.py reads these back).
- ``hist``    — aggregated ``attn_step`` / ``serve_step`` / ``plan_solve``
  run history keyed by (mask-class signature, shape, dtype, mesh, env
  snapshot signature), fed by :func:`ingest_event` from the collector.
- ``obs``     — a (predicted cost, measured ms) pair for one of the
  open-loop cost models; consumed by telemetry/drift.py.
- ``calib``   — a fitted model constant (e.g. ``overhead_elems``,
  ``dcn_per_row``) solvers may consume via :func:`calibration_value`.
- ``drift``   — a measured-vs-modeled drift finding past threshold.

The port's departures: a step's ``calc_attn`` measurement and its
``tile_score`` observation use the step's ``device_ms`` (CUDA events
around the forward, on a card) wherever the record carries one, since its
host ``wall_ms`` is mostly launch time there; the ``bwd_cost`` observation
takes the backward's own ``bwd_device_ms`` and is made only where the
record has one (never from a forward time); and the tile score is re-evaluated with the port's
per-dtype ``OVERHEAD_ELEMS``, its observations carrying the ``itemsize``
that :func:`~.drift.fit_constants` refits per dtype.

Everything here is gated on :func:`store_active` — with
``MAGI_ATTENTION_TELEMETRY`` off (or ``MAGI_ATTENTION_BACKEND_STORE=0``)
every entry point is a cheap early return: no file I/O, no state, and the
backend registry falls back to its legacy heuristics bit-identically.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ..env import backend as env_backend
from ..env import general as env_general
from .export import JsonlSink, _jsonable, process_unique_path

STORE_SCHEMA_VERSION = 1
SNAPSHOT_NAME = "store.json"
HISTORY_PREFIX = "history"

# measurements needed before a backend is considered "verified fastest"
MIN_MEASUREMENTS = 2
# bounded in-memory/snapshot tails (aggregates are unbounded-safe; raw
# observation/drift rows are not)
OBS_CAP = 512
DRIFT_CAP = 256

# collector kinds ingest_event aggregates into run history
_HISTORY_KINDS = ("attn_step", "serve_step", "plan_solve", "step_retry")
# collector kinds with dedicated fold logic besides run history
_SPECIAL_KINDS = ("model_drift", "rank_health")
# attn_step fields forming the run-history key (mask-class
# signature, shape, dtype, mesh, env snapshot)
_ATTN_KEY_FIELDS = (
    "mask_sig", "q_shape", "kv_shape", "dtype", "mesh_sig", "env_sig",
    "cp_size",
)


def store_active() -> bool:
    """The ONE gate every store entry point checks first."""
    return (
        env_general.is_telemetry_enable()
        and env_backend.backend_store_mode() != "0"
    )


def canonical_key(key: Any) -> str:
    """Stable string form of a decision/history key (dict keys sorted,
    tuples as lists) — the join key across processes and restarts."""
    return json.dumps(_jsonable(key), sort_keys=True, separators=(",", ":"))


@dataclass
class StoreState:
    """In-memory aggregate view of the store (snapshot + replayed rows)."""

    entries: dict[str, dict[str, Any]] = field(default_factory=dict)
    history: dict[str, dict[str, Any]] = field(default_factory=dict)
    policy: dict[str, dict[str, Any]] = field(default_factory=dict)
    calibration: dict[str, dict[str, Any]] = field(default_factory=dict)
    observations: dict[str, list[dict[str, Any]]] = field(default_factory=dict)
    drift: list[dict[str, Any]] = field(default_factory=list)
    rank_health: dict[str, dict[str, Any]] = field(default_factory=dict)
    quarantine: dict[str, dict[str, Any]] = field(default_factory=dict)


def _apply(state: StoreState, row: dict[str, Any]) -> None:
    """Fold one history row into the aggregate state."""
    rk = row.get("rk")
    if rk == "measure":
        ekey = f"{row['decision']}|{row['key']}"
        entry = state.entries.setdefault(ekey, {"count": 0, "by_backend": {}})
        entry["count"] += 1
        b = entry["by_backend"].setdefault(
            row["backend"],
            {"count": 0, "ok": 0, "wall_ms_sum": 0.0, "wall_ms_min": None},
        )
        b["count"] += 1
        if row.get("ok", True):
            b["ok"] += 1
            ms = float(row["wall_ms"])
            b["wall_ms_sum"] += ms
            if b["wall_ms_min"] is None or ms < b["wall_ms_min"]:
                b["wall_ms_min"] = ms
    elif rk == "policy":
        state.policy[f"{row['decision']}|{row['key']}"] = {
            "choice": row["choice"],
            "source": row.get("source", "heuristic"),
            "ts": row.get("ts"),
        }
    elif rk == "hist":
        hkey = f"{row['kind']}|{row['key']}"
        h = state.history.setdefault(
            hkey,
            {
                "kind": row["kind"],
                "count": 0,
                "wall_ms_sum": 0.0,
                "wall_ms_min": None,
                "wall_ms_max": None,
            },
        )
        h["count"] += 1
        ms = row.get("wall_ms")
        if ms is not None:
            ms = float(ms)
            h["wall_ms_sum"] += ms
            if h["wall_ms_min"] is None or ms < h["wall_ms_min"]:
                h["wall_ms_min"] = ms
            if h["wall_ms_max"] is None or ms > h["wall_ms_max"]:
                h["wall_ms_max"] = ms
        h["last_ts"] = row.get("ts")
    elif rk == "obs":
        obs = state.observations.setdefault(row["model"], [])
        obs.append(
            {
                "predicted": float(row["predicted"]),
                "measured_ms": float(row["measured_ms"]),
                "extras": row.get("extras") or {},
            }
        )
        if len(obs) > OBS_CAP:
            del obs[: len(obs) - OBS_CAP]
    elif rk == "calib":
        state.calibration[row["name"]] = {
            "value": float(row["value"]),
            "n": int(row.get("n", 0)),
            "ts": row.get("ts"),
        }
    elif rk == "drift":
        state.drift.append(
            {k: v for k, v in row.items() if k not in ("rk", "v")}
        )
        if len(state.drift) > DRIFT_CAP:
            del state.drift[: len(state.drift) - DRIFT_CAP]
    elif rk == "rank_health":
        r = str(row.get("rank"))
        h = state.rank_health.setdefault(
            r,
            {
                "count": 0,
                "transitions": 0,
                "ewma_ms": None,
                "capacity": 1.0,
                "degraded": False,
            },
        )
        h["count"] += 1
        if row.get("ewma_ms") is not None:
            h["ewma_ms"] = float(row["ewma_ms"])
        if row.get("capacity") is not None:
            cap = float(row["capacity"])
            if cap != h["capacity"]:
                h["transitions"] += 1
            h["capacity"] = cap
        h["degraded"] = bool(row.get("degraded", False))
        h["last_ts"] = row.get("ts")
    elif rk == "quarantine":
        qkey = f"{row.get('decision')}|{row.get('key')}|{row.get('backend')}"
        if row.get("action") == "clear":
            state.quarantine.pop(qkey, None)
        else:
            q = state.quarantine.setdefault(
                qkey,
                {
                    "decision": row.get("decision"),
                    "key": row.get("key"),
                    "backend": row.get("backend"),
                    "trips": 0,
                },
            )
            q["trips"] = max(q["trips"], int(row.get("trips", 1)))
            q["last_ts"] = row.get("ts")
    # unknown rk: forward-compat skip


def _load_from_disk(directory: str) -> StoreState:
    state = StoreState()
    snap_path = os.path.join(directory, SNAPSHOT_NAME)
    try:
        with open(snap_path) as f:
            snap = json.load(f)
        if isinstance(snap, dict) and snap.get("v", 0) <= STORE_SCHEMA_VERSION:
            state.entries = snap.get("entries", {})
            state.history = snap.get("history", {})
            state.policy = snap.get("policy", {})
            state.calibration = snap.get("calibration", {})
            state.observations = snap.get("observations", {})
            state.drift = snap.get("drift", [])
            state.rank_health = snap.get("rank_health", {})
            state.quarantine = snap.get("quarantine", {})
    except (OSError, ValueError):
        pass  # no/garbled snapshot: rebuild from history alone
    for path in sorted(glob.glob(os.path.join(directory, f"{HISTORY_PREFIX}-*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except ValueError:
                        continue  # torn/foreign line: skip, keep reading
                    if row.get("v", 0) > STORE_SCHEMA_VERSION:
                        continue
                    _apply(state, row)
        except OSError:
            continue
    return state


class TelemetryStore:
    """One process's handle on a store directory: appends rows to its own
    history file (line-atomic) and keeps the aggregate state in memory."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._lock = threading.Lock()
        self._sink = JsonlSink(process_unique_path(directory, HISTORY_PREFIX))
        self._state: StoreState | None = None

    # -- persistence ------------------------------------------------------

    def _append(self, row: dict[str, Any]) -> None:
        """Write one row (caller holds the lock) and fold it into the
        in-memory state so this process sees its own writes immediately."""
        row.setdefault("v", STORE_SCHEMA_VERSION)
        row.setdefault("ts", time.time())
        self._sink.write(row)
        _apply(self._ensure_loaded(), row)

    def _ensure_loaded(self) -> StoreState:
        if self._state is None:
            self._state = _load_from_disk(self.directory)
        return self._state

    def load(self) -> StoreState:
        """(Re)load the aggregate state from disk: snapshot + every
        history file, including other writers'."""
        with self._lock:
            self._state = _load_from_disk(self.directory)
            return self._state

    def compact(self) -> str:
        """Fold all history files into ``store.json`` (atomic replace) and
        delete them. Call with no concurrent writers; this process's own
        file is rotated so it keeps appending safely afterwards."""
        with self._lock:
            self._sink.close()
            files = sorted(
                glob.glob(
                    os.path.join(self.directory, f"{HISTORY_PREFIX}-*.jsonl")
                )
            )
            state = _load_from_disk(self.directory)
            snap_path = os.path.join(self.directory, SNAPSHOT_NAME)
            tmp_path = snap_path + f".tmp-{os.getpid()}"
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp_path, "w") as f:
                json.dump(
                    {
                        "v": STORE_SCHEMA_VERSION,
                        "entries": state.entries,
                        "history": state.history,
                        "policy": state.policy,
                        "calibration": state.calibration,
                        "observations": state.observations,
                        "drift": state.drift,
                        "rank_health": state.rank_health,
                        "quarantine": state.quarantine,
                    },
                    f,
                )
            os.replace(tmp_path, snap_path)
            for path in files:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._sink = JsonlSink(
                process_unique_path(self.directory, HISTORY_PREFIX)
            )
            self._state = state
            return snap_path

    def close(self) -> None:
        with self._lock:
            self._sink.close()

    # -- writers ----------------------------------------------------------

    def record_measurement(
        self,
        decision: str,
        key: Any,
        backend: str,
        wall_ms: float,
        ok: bool = True,
        **extra: Any,
    ) -> None:
        with self._lock:
            self._append(
                {
                    "rk": "measure",
                    "decision": decision,
                    "key": canonical_key(key),
                    "backend": backend,
                    "wall_ms": float(wall_ms),
                    "ok": bool(ok),
                    **({"ctx": _jsonable(extra)} if extra else {}),
                }
            )

    def record_policy(
        self, decision: str, key: Any, choice: str, source: str
    ) -> None:
        with self._lock:
            self._append(
                {
                    "rk": "policy",
                    "decision": decision,
                    "key": canonical_key(key),
                    "choice": choice,
                    "source": source,
                }
            )

    def record_history(
        self, kind: str, key: Any, wall_ms: float | None, **extra: Any
    ) -> None:
        with self._lock:
            row: dict[str, Any] = {
                "rk": "hist",
                "kind": kind,
                "key": canonical_key(key),
            }
            if wall_ms is not None:
                row["wall_ms"] = float(wall_ms)
            if extra:
                row["ctx"] = _jsonable(extra)
            self._append(row)

    def record_observation(
        self,
        model: str,
        predicted: float,
        measured_ms: float,
        **extras: Any,
    ) -> None:
        with self._lock:
            self._append(
                {
                    "rk": "obs",
                    "model": model,
                    "predicted": float(predicted),
                    "measured_ms": float(measured_ms),
                    **({"extras": _jsonable(extras)} if extras else {}),
                }
            )

    def record_calibration(self, name: str, value: float, n: int) -> None:
        with self._lock:
            self._append(
                {"rk": "calib", "name": name, "value": float(value), "n": n}
            )

    def record_drift(self, row: dict[str, Any]) -> None:
        with self._lock:
            self._append({"rk": "drift", **_jsonable(row)})

    def record_rank_health(
        self,
        rank: int,
        wall_ms: float | None,
        ewma_ms: float | None,
        capacity: float,
        degraded: bool,
        **extra: Any,
    ) -> None:
        with self._lock:
            row: dict[str, Any] = {
                "rk": "rank_health",
                "rank": int(rank),
                "capacity": float(capacity),
                "degraded": bool(degraded),
            }
            if wall_ms is not None:
                row["wall_ms"] = float(wall_ms)
            if ewma_ms is not None:
                row["ewma_ms"] = float(ewma_ms)
            if extra:
                row["ctx"] = _jsonable(extra)
            self._append(row)

    def record_quarantine(
        self,
        decision: str,
        key: Any,
        backend: str,
        trips: int,
        action: str = "add",
    ) -> None:
        with self._lock:
            self._append(
                {
                    "rk": "quarantine",
                    "decision": decision,
                    "key": canonical_key(key),
                    "backend": backend,
                    "trips": int(trips),
                    "action": action,
                }
            )

    # -- readers ----------------------------------------------------------

    def policy_for(self, decision: str, key: Any) -> dict[str, Any] | None:
        with self._lock:
            return self._ensure_loaded().policy.get(
                f"{decision}|{canonical_key(key)}"
            )

    def best_backend(
        self, decision: str, key: Any, min_count: int = MIN_MEASUREMENTS
    ) -> tuple[str, float] | None:
        """Fastest *verified* backend for a decision key: lowest mean
        wall_ms among backends with >= min_count ok measurements."""
        with self._lock:
            entry = self._ensure_loaded().entries.get(
                f"{decision}|{canonical_key(key)}"
            )
        if not entry:
            return None
        best: tuple[str, float] | None = None
        for name, b in entry["by_backend"].items():
            if b["ok"] < min_count:
                continue
            mean = b["wall_ms_sum"] / b["ok"]
            if best is None or mean < best[1]:
                best = (name, mean)
        return best

    def calibration_for(self, name: str) -> float | None:
        with self._lock:
            c = self._ensure_loaded().calibration.get(name)
        return None if c is None else float(c["value"])

    def rank_health_view(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {
                r: dict(h)
                for r, h in self._ensure_loaded().rank_health.items()
            }

    def quarantined(self, decision: str, key: Any) -> set[str]:
        """Backends quarantined for a decision key (restart-persistent)."""
        prefix = f"{decision}|{canonical_key(key)}|"
        with self._lock:
            return {
                q["backend"]
                for qkey, q in self._ensure_loaded().quarantine.items()
                if qkey.startswith(prefix)
            }


# -- module-level gated access (what the registry / solvers use) ------------

_store: TelemetryStore | None = None
_store_lock = threading.Lock()


def resolve_store_dir() -> str:
    d = env_backend.store_dir()
    return d or os.path.join(env_general.telemetry_dir(), "store")


def get_store() -> TelemetryStore | None:
    """The process-global store, or None when inactive. Recreated when the
    resolved directory changes (tests redirect via env)."""
    if not store_active():
        return None
    global _store
    directory = resolve_store_dir()
    with _store_lock:
        if _store is None or _store.directory != directory:
            if _store is not None:
                _store.close()
            _store = TelemetryStore(directory)
        return _store


def reset() -> None:
    """Drop the global store (tests; recreated on demand)."""
    global _store
    with _store_lock:
        if _store is not None:
            _store.close()
        _store = None


def policy_lookup(decision: str, key: Any) -> dict[str, Any] | None:
    st = get_store()
    return None if st is None else st.policy_for(decision, key)


def policy_record(decision: str, key: Any, choice: str, source: str) -> None:
    st = get_store()
    if st is not None:
        st.record_policy(decision, key, choice, source)


def measured_best(decision: str, key: Any) -> str | None:
    st = get_store()
    if st is None:
        return None
    best = st.best_backend(decision, key)
    return None if best is None else best[0]


def calibration_value(name: str) -> float | None:
    st = get_store()
    return None if st is None else st.calibration_for(name)


def calibrated(name: str, default: float) -> float:
    """A store-fitted model constant, or ``default`` when the store or
    MAGI_ATTENTION_CALIBRATION is off (or no sane fit exists). This is the
    one entry point solvers/cost models use — off-path it is two env dict
    reads and the built-in constant, bit-identical to pre-store behavior."""
    if not store_active() or not env_backend.calibration_enabled():
        return default
    v = calibration_value(name)
    if v is None or not (v > 0):
        return default
    return v


def record_measurement(
    decision: str, key: Any, backend: str, wall_ms: float, ok: bool = True
) -> None:
    st = get_store()
    if st is not None:
        st.record_measurement(decision, key, backend, wall_ms, ok=ok)


def record_observation(
    model: str, predicted: float, measured_ms: float, **extras: Any
) -> None:
    st = get_store()
    if st is not None:
        st.record_observation(model, predicted, measured_ms, **extras)


def quarantined_backends(decision: str, key: Any) -> set[str]:
    """Restart-persistent quarantine set for a decision key; empty when
    the store is inactive (quarantine still works in-process then)."""
    st = get_store()
    return set() if st is None else st.quarantined(decision, key)


def record_quarantine(
    decision: str, key: Any, backend: str, trips: int, action: str = "add"
) -> None:
    st = get_store()
    if st is not None:
        st.record_quarantine(decision, key, backend, trips, action=action)


# -- collector ingest -------------------------------------------------------


# the dtype names the records carry -> itemsize (OVERHEAD_ELEMS's keys)
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _tile_score_prediction(
    record: dict[str, Any],
) -> tuple[float, float, float, int] | None:
    """Re-evaluate the tile-policy cost model on a recorded plan: the same
    ``w * (bq*bk + OVERHEAD_ELEMS)`` score the choosers minimize, summed
    over the plan's groups, with the built-in constant of the record's
    dtype (not a calibrated one) — drift is measured against the
    open-loop model. Returns (score, tile_area_term, work_count_term,
    itemsize) so drift.fit_constants can refit that dtype's
    OVERHEAD_ELEMS from the two components."""
    groups = record.get("plan_groups")
    itemsize = _ITEMSIZE.get(str(record.get("dtype")))
    if not groups or itemsize is None:
        return None
    from ..kernels.tile_policy import OVERHEAD_ELEMS

    area = 0.0
    works = 0.0
    for g in groups:
        try:
            area += g["num_work"] * g["block_q"] * g["block_k"]
            works += g["num_work"]
        except (KeyError, TypeError):
            return None
    if works <= 0:
        return None
    return (area + works * OVERHEAD_ELEMS[itemsize], area, works, itemsize)


def ingest_event(record: dict[str, Any]) -> None:
    """Collector hook: fold a telemetry record into the persistent store.
    Called for every record the collector writes; cheap kind/gate check
    first so non-store kinds cost one tuple membership test."""
    kind = record.get("kind")
    if kind not in _HISTORY_KINDS and kind not in _SPECIAL_KINDS:
        return
    if not store_active():
        return
    st = get_store()
    if st is None:
        return
    if kind == "model_drift":
        st.record_drift(
            {
                k: record[k]
                for k in ("model", "alpha", "rel_err", "predicted",
                          "measured_ms", "extras")
                if k in record
            }
        )
        return
    wall_ms = record.get("wall_ms")
    if kind == "attn_step":
        key = {f: record.get(f) for f in _ATTN_KEY_FIELDS}
        st.record_history("attn_step", key, wall_ms)
        # the step's forward device time where the record has one (on a
        # card the host wall is mostly launch time)
        step_ms = record.get("device_ms", wall_ms)
        if step_ms is not None and record.get("backend"):
            # the step wall time is a calc_attn measurement; finer
            # decisions (ffa_bwd, serve_decode) are measured by their own
            # harnesses/tests and land as explicit measure rows
            bwd_key = record.get("bwd_key")
            # keyed exactly like DistAttnRuntime._policy_key so the
            # registry's measured lookup joins against these rows
            mkey = {
                "mask_sig": record.get("mask_sig"),
                "mesh_sig": record.get("mesh_sig"),
                "env_sig": record.get("env_sig"),
            }
            st.record_measurement(
                "calc_attn",
                mkey,
                str(record["backend"]),
                float(step_ms),
                bwd_mode=record.get("bwd_mode"),
            )
            pred = _tile_score_prediction(record)
            if pred is not None:
                area, works, itemsize = pred[1], pred[2], pred[3]
                st.record_observation(
                    "tile_score", pred[0], float(step_ms),
                    mask_sig=record.get("mask_sig"),
                    area=area, works=works, itemsize=itemsize,
                )
            # the modeled backward against the step's own backward time
            # (its event pair on the card); a record without one (the
            # CPU, a forward-only step) makes no bwd_cost observation
            bwd_ms = record.get("bwd_device_ms")
            if bwd_key is not None and record.get("bwd_cost") is not None and bwd_ms is not None:
                st.record_observation(
                    "bwd_cost", float(record["bwd_cost"]), float(bwd_ms),
                    bwd_mode=record.get("bwd_mode"), bwd_key=bwd_key,
                )
    elif kind == "serve_step":
        key = {
            "occupancy": record.get("occupancy"),
            "pages_in_use": record.get("pages_in_use"),
        }
        st.record_history("serve_step", key, wall_ms)
        backend = record.get("decode_backend")
        if backend is None:
            from ..kernels import registry as _kreg

            backend = _kreg.last_choice("serve_decode")
        if wall_ms is not None and backend:
            st.record_measurement(
                "serve_decode",
                _kreg_last_key_or(key),
                str(backend),
                float(wall_ms),
            )
    elif kind == "plan_solve":
        key = {
            k: record.get(k)
            for k in ("signature", "cp_size", "num_slices", "planner")
            if k in record
        }
        st.record_history("plan_solve", key, wall_ms)
    elif kind == "rank_health":
        st.record_rank_health(
            rank=int(record.get("rank", -1)),
            wall_ms=record.get("wall_ms"),
            ewma_ms=record.get("ewma_ms"),
            capacity=float(record.get("capacity", 1.0)),
            degraded=bool(record.get("degraded", False)),
        )
    elif kind == "step_retry":
        key = {
            k: record.get(k)
            for k in ("stage", "from_backend", "to_backend", "error")
            if k in record
        }
        st.record_history("step_retry", key, wall_ms)


def _kreg_last_key_or(default: Any) -> Any:
    from ..kernels import registry as _kreg

    last = _kreg.last_key("serve_decode")
    return default if last is None else last
