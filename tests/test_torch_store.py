"""The port's persistent telemetry store, drift layer, rank-health monitor
and weighted dispatch against the JAX package's.

The same rows go into the JAX package's and the port's ``TelemetryStore``
(one directory each): the compacted snapshots are equal (timestamps
aside), and so are ``policy_lookup``, ``measured_best``,
``quarantined_backends``, ``drift.scan`` and ``drift.fit_constants``
(within 1e-12; the port refits its tile overhead per dtype, so JAX's
``overhead_elems`` is compared with the port's ``overhead_elems.2`` for
bf16 observations). The monitors' capacity sequences under the same step
times are equal, and the capacity-weighted dispatch plan is field-equal to
JAX's. Then the port alone: a persisted registry decision comes back from
source ``policy`` after a reset with no heuristic run, a store-fitted
overhead reaches the tile policy, and a step's ``device_ms`` is what the
store measures.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from magiattention_tpu import telemetry as jtel
from magiattention_tpu.common.enum import AttnMaskType as JMask
from magiattention_tpu.common.ranges import AttnRanges as JRanges
from magiattention_tpu.config import DispatchConfig as JDispatchConfig
from magiattention_tpu.kernels import registry as jreg
from magiattention_tpu.meta import make_dispatch_meta_from_qk_ranges as jmake
from magiattention_tpu.telemetry import drift as jdrift
from magiattention_tpu.telemetry import health as jhealth
from magiattention_tpu.telemetry import store as jstore
from magiattention_tpu_torch import telemetry
from magiattention_tpu_torch.common.enum import AttnMaskType
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.config import DispatchConfig
from magiattention_tpu_torch.kernels import registry as preg
from magiattention_tpu_torch.kernels import tile_policy
from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges as pmake
from magiattention_tpu_torch.telemetry import drift as pdrift
from magiattention_tpu_torch.telemetry import health as phealth
from magiattention_tpu_torch.telemetry import store as pstore
from tests import torch_port_cases
from tests.torch_port_cases import assert_same_fields

STRAGGLER = {
    "MAGI_ATTENTION_STRAGGLER_DETECT": "1",
    "MAGI_ATTENTION_STRAGGLER_MIN_STEPS": "4",
    "MAGI_ATTENTION_STRAGGLER_COOLDOWN": "3",
}


@pytest.fixture(autouse=True)
def _fresh():
    def reset():
        for mod in (jtel, telemetry, jstore, pstore, jhealth, phealth):
            mod.reset()
        jreg.reset_registry()
        preg.reset_registry()

    reset()
    yield
    reset()


@pytest.fixture
def stores(tmp_path, monkeypatch):
    """(JAX's store, the port's store), each in its own directory, with
    telemetry (and so the store) on."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    return jstore.TelemetryStore(str(tmp_path / "jax")), pstore.TelemetryStore(str(tmp_path / "port"))


def _rows(rng):
    """A mixed row set: measurements (ok and not), policies, history,
    observations of three models, calibrations, drift, rank health and
    quarantine (added and cleared)."""
    rows = []
    for i in range(12):
        rows.append(("record_measurement", ("calc_attn", {"mask_sig": f"m{i % 3}"},
                                            ("ffa", "sdpa")[i % 2], float(rng.uniform(1, 9))),
                     {"ok": i % 5 != 0}))
    rows.append(("record_policy", ("ffa_bwd", (1, 2), "split", "heuristic"), {}))
    rows.append(("record_policy", ("serve_decode", (4, False), "paged_decode", "measured"), {}))
    for i in range(6):
        rows.append(("record_history", ("attn_step", {"k": i % 2}, float(rng.uniform(1, 5))), {}))
    for i in range(8):
        area, works = float(rng.integers(1e5, 1e6)), float(rng.integers(10, 200))
        ms = 2e-6 * area + 3e-4 * works + float(rng.normal(0, 1e-4))
        rows.append(("record_observation", ("tile_score", area + works * 0, ms),
                     {"area": area, "works": works, "itemsize": 2}))
        rows.append(("record_observation", ("bwd_cost", float(rng.uniform(1, 3)), ms),
                     {"bwd_mode": "fused"}))
        ici, dcn = float(rng.integers(100, 900)), float(rng.integers(10, 90))
        rows.append(("record_observation", ("two_level_makespan", ici + 8 * dcn,
                                            1e-3 * ici + 5e-3 * dcn), {"ici_rows": ici, "dcn_rows": dcn}))
    rows.append(("record_calibration", ("dcn_per_row", 7.5, 9), {}))
    rows.append(("record_drift", ({"model": "tile_score", "alpha": 1.5, "rel_err": 0.7},), {}))
    for r in range(4):
        rows.append(("record_rank_health", (r, 10.0 + r, 10.0 + r, 1.0 if r < 3 else 0.5, r == 3), {}))
    rows.append(("record_quarantine", ("calc_attn", {"mask_sig": "m0"}, "ffa", 2), {}))
    rows.append(("record_quarantine", ("calc_attn", {"mask_sig": "m1"}, "sdpa", 2), {}))
    rows.append(("record_quarantine", ("calc_attn", {"mask_sig": "m1"}, "sdpa", 2), {"action": "clear"}))
    return rows


def _drop_ts(x):
    if isinstance(x, dict):
        return {k: _drop_ts(v) for k, v in x.items() if k not in ("ts", "last_ts")}
    if isinstance(x, list):
        return [_drop_ts(v) for v in x]
    return x


def _snapshot(path: str) -> dict:
    with open(path) as f:
        return _drop_ts(json.load(f))


def test_same_rows_same_compacted_state(stores):
    js, ps = stores
    for method, args, kw in _rows(np.random.default_rng(0)):
        getattr(js, method)(*args, **kw)
        getattr(ps, method)(*args, **kw)
    assert _snapshot(ps.compact()) == _snapshot(js.compact())
    jstate, pstate = js.load(), ps.load()
    assert _drop_ts(dataclasses.asdict(pstate)) == _drop_ts(dataclasses.asdict(jstate))
    for key in ({"mask_sig": "m0"}, {"mask_sig": "m1"}, {"mask_sig": "m2"}):
        assert ps.best_backend("calc_attn", key) == js.best_backend("calc_attn", key)
        assert ps.quarantined("calc_attn", key) == js.quarantined("calc_attn", key)
    assert _drop_ts(ps.policy_for("ffa_bwd", (1, 2))) == _drop_ts(js.policy_for("ffa_bwd", (1, 2)))
    assert ps.calibration_for("dcn_per_row") == js.calibration_for("dcn_per_row") == 7.5
    assert _drop_ts(ps.rank_health_view()) == _drop_ts(js.rank_health_view())
    # drift: the same findings, the same refits
    assert pdrift.scan(pstate, threshold=0.05, emit=False) == jdrift.scan(jstate, threshold=0.05, emit=False)
    pfit = pdrift.fit_constants(pstate, persist=False)
    jfit = jdrift.fit_constants(jstate, persist=False)
    assert set(jfit) == {"overhead_elems", "dcn_per_row"}
    assert set(pfit) == {"overhead_elems.2", "dcn_per_row"}
    assert abs(pfit["overhead_elems.2"] - jfit["overhead_elems"]) <= 1e-12 * abs(jfit["overhead_elems"])
    assert abs(pfit["dcn_per_row"] - jfit["dcn_per_row"]) <= 1e-12 * abs(jfit["dcn_per_row"])


def test_module_level_lookups_match(tmp_path, monkeypatch):
    """The gated module entry points (what the registry and the watchdog
    use) over one directory each."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    got = {}
    for name, mod in (("jax", jstore), ("port", pstore)):
        monkeypatch.setenv("MAGI_ATTENTION_STORE_DIR", str(tmp_path / name))
        mod.reset()
        for backend, ms in (("ffa", 2.0), ("ffa", 2.2), ("sdpa", 1.5), ("sdpa", 1.7), ("sdpa_online", 0.1)):
            mod.record_measurement("calc_attn", {"mask_sig": "a"}, backend, ms)
        mod.policy_record("ffa_bwd", (3,), "fused", "heuristic")
        mod.record_quarantine("calc_attn", {"mask_sig": "a"}, "ffa", 2)
        got[name] = (
            mod.measured_best("calc_attn", {"mask_sig": "a"}),  # sdpa_online: one sample only
            mod.policy_lookup("ffa_bwd", (3,))["choice"],
            mod.quarantined_backends("calc_attn", {"mask_sig": "a"}),
            mod.calibrated("dcn_per_row", 8.0),
        )
        mod.reset()
    assert got["port"] == got["jax"] == ("sdpa", "fused", {"ffa"}, 8.0)


def test_rank_health_capacity_sequences_match(monkeypatch):
    """Both monitors fed the same step times in lockstep: rank 3 runs 4x
    slow for 15 steps (its time a capacity share of the work once it is
    degraded), then healthy; every transition and vector is equal."""
    for k, v in STRAGGLER.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(3)
    seq_p, seq_j = [], []
    caps = None
    for step in range(30):
        cap3 = 1.0 if caps is None else caps[3]
        slow = 4.0 if 5 <= step < 20 else 1.0
        times = [10 + rng.normal(0, 0.3) for _ in range(3)] + [10 * slow * cap3 + rng.normal(0, 0.3)]
        for r, ms in enumerate(times):
            seq_p.append(phealth.observe_step(r, ms))
            seq_j.append(jhealth.observe_step(r, ms))
        caps = phealth.active_capacities(4)
        seq_p.append(caps)
        seq_j.append(jhealth.active_capacities(4))
    assert seq_p == seq_j
    assert seq_p.count("degraded") == 1 and seq_p.count("recovered") == 1


def test_capacities_off_without_the_flag(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_STRAGGLER_DETECT", raising=False)
    phealth.observe_step(0, 1.0)
    assert phealth.active_capacities(4) is None


@pytest.mark.parametrize("caps", [(1.0, 1.0, 1.0, 0.25), (1.0, 0.5, 1.0, 0.75)])
def test_weighted_dispatch_plan_matches_jax(caps):
    torch_port_cases.warm_jax_native()
    cfg = dict(chunk_size=16, cp_size=4)
    port = pmake(
        AttnRanges.from_ranges([[0, 256]]), AttnRanges.from_ranges([[0, 256]]),
        [AttnMaskType.CAUSAL], 256, 256, cfg["chunk_size"], cfg["cp_size"],
        dispatch_config=DispatchConfig(), capacities=list(caps),
    )
    ref = jmake(
        JRanges.from_ranges([[0, 256]]), JRanges.from_ranges([[0, 256]]),
        [JMask.CAUSAL], 256, 256, cfg["chunk_size"], cfg["cp_size"],
        dispatch_config=JDispatchConfig(), capacities=list(caps),
    )
    for got, want in zip(port, ref):
        assert_same_fields(got, want)
    # the weighted plan gives the slow rank fewer chunks
    sizes = [len(p) for p in port[0].partitions]
    assert sizes[int(np.argmin(caps))] < max(sizes)


def test_persisted_policy_comes_back_without_heuristic(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_STORE_DIR", str(tmp_path / "store"))
    calls = []

    def heuristic():
        calls.append(1)
        return "split"

    first = preg.resolve("ffa_bwd", ("geom", 7), heuristic)
    assert (first.name, first.source, len(calls)) == ("split", "heuristic", 1)
    pstore.get_store().compact()
    preg.reset_registry()
    pstore.reset()
    again = preg.resolve("ffa_bwd", ("geom", 7), heuristic)
    assert (again.name, again.source, len(calls)) == ("split", "policy", 1)
    assert preg.stats()["store_hits"] == 1 and preg.stats()["heuristic_calls"] == 0
    # with the observatory off the store is not consulted
    monkeypatch.delenv("MAGI_ATTENTION_TELEMETRY")
    preg.reset_registry()
    off = preg.resolve("ffa_bwd", ("geom", 7), heuristic)
    assert (off.source, len(calls)) == ("heuristic", 2)


def test_measured_history_picks_the_fastest(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_STORE_DIR", str(tmp_path / "store"))
    for ms in (3.0, 3.1):
        pstore.record_measurement("serve_decode", (8, False), "paged_decode", ms)
        pstore.record_measurement("serve_decode", (8, False), "gather_ffa", ms / 3)
    choice = preg.resolve("serve_decode", (8, False), lambda: "paged_decode")
    assert (choice.name, choice.source) == ("gather_ffa", "measured")


def test_calibrated_overhead_reaches_the_tile_policy(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_STORE_DIR", str(tmp_path / "store"))
    assert tile_policy.overhead_elems() == tile_policy.OVERHEAD_ELEMS
    pstore.get_store().record_calibration("overhead_elems.2", 512.0, 5)
    assert tile_policy.overhead_elems() == {**tile_policy.OVERHEAD_ELEMS, 2: 512.0}
    assert tile_policy.hopper_space().overhead_for(2) == 512.0
    monkeypatch.setenv("MAGI_ATTENTION_CALIBRATION", "0")
    assert tile_policy.overhead_elems() == tile_policy.OVERHEAD_ELEMS


def test_step_measurement_uses_device_ms(tmp_path, monkeypatch):
    """An attn_step record with ``device_ms`` is measured by it; without,
    by its host wall (the JAX package's rows)."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_STORE_DIR", str(tmp_path / "store"))
    base = dict(
        kind="attn_step", backend="ffa", mask_sig="m", mesh_sig="x", env_sig="e", dtype="bfloat16",
        plan_groups=[{"num_work": 10, "block_q": 64, "block_k": 64}],
    )
    pstore.ingest_event({**base, "wall_ms": 9.0, "device_ms": 2.0})
    pstore.ingest_event({**base, "mask_sig": "n", "wall_ms": 9.0})
    state = pstore.get_store().load()
    by_mask = {
        json.loads(k.split("|", 1)[1])["mask_sig"]: e["by_backend"]["ffa"]["wall_ms_min"]
        for k, e in state.entries.items()
    }
    assert by_mask == {"m": 2.0, "n": 9.0}
    obs = state.observations["tile_score"]
    assert [o["measured_ms"] for o in obs] == [2.0, 9.0]
    assert obs[0]["extras"]["itemsize"] == 2
    assert obs[0]["predicted"] == 10 * 64 * 64 + 10 * tile_policy.OVERHEAD_ELEMS[2]
    assert os.path.isdir(tmp_path / "store")


def test_bwd_cost_observed_from_the_backward_time(tmp_path, monkeypatch):
    """The ``bwd_cost`` observation pairs the modeled backward with the
    step's own backward time (``bwd_device_ms``), never with its forward
    time: a record without one makes none."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_STORE_DIR", str(tmp_path / "store"))
    base = dict(
        kind="attn_step", backend="ffa", mask_sig="m", mesh_sig="x", env_sig="e", dtype="bfloat16",
        plan_groups=[{"num_work": 10, "block_q": 64, "block_k": 64}],
        bwd_mode="fused", bwd_key=[1, 2], bwd_cost=4.0,
    )
    pstore.ingest_event({**base, "wall_ms": 9.0, "device_ms": 2.0, "bwd_device_ms": 5.5})
    pstore.ingest_event({**base, "wall_ms": 9.0, "device_ms": 2.0})  # a forward-only step
    pstore.ingest_event({**base, "wall_ms": 9.0})  # the CPU
    obs = pstore.get_store().load().observations
    assert [(o["predicted"], o["measured_ms"]) for o in obs["bwd_cost"]] == [(4.0, 5.5)]
    assert [o["measured_ms"] for o in obs["tile_score"]] == [2.0, 2.0, 9.0]
