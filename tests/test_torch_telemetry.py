"""The port's telemetry plane against the JAX package's, on the same inputs.

- Record streams: the same mask and numpy inputs through the JAX package's
  and the port's ``magi_attn_flex_key -> dispatch -> calc_attn`` at cp 1,
  blocks pinned 128 x 128 and the backward pinned split in both, with
  MAGI_ATTENTION_TELEMETRY=1 into one directory each. The planners' and
  runtimes' records are equal field by field, in order, apart from: the
  timing fields; ``backend_select`` records (each package announces its
  own decisions: the port's pack and backward decisions, JAX's
  ``ffa_lowering``); ``env_sig`` (a digest of each package's own
  runtime-key flag list); ``bwd_key`` and ``bwd_cost`` (the port's
  backward cost model is Hopper's); and the ``ffa_plan`` record's
  ``executed_elems`` / ``executed_ratio`` / ``extent_clamp`` (the port's
  kernels compute each listed tile whole, with no extent clamp).
- ``scripts/telemetry_report.py --json`` (the JAX package's script, run as
  a subprocess) prints the same summary for both directories, the same
  fields aside.
- The off path: with every flag unset, a step reads no clock in the
  registry, creates no file and no ``torch.cuda.Event``, never enters the
  resilience layer, and gives ``_calc_attn_impl``'s result bitwise.
- Device-timed records wait for their events and carry ``device_ms``, and
  ``bwd_device_ms`` where the step's backward ran; the step payload is
  built once per plan build.
"""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from magiattention_tpu import api as japi
from magiattention_tpu import telemetry as jtel
from magiattention_tpu_torch import api, telemetry
from magiattention_tpu_torch.api.magi_attn_interface import _mgr
from magiattention_tpu_torch.telemetry import registry
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256
DOCS = [[0, 128], [128, 256]]
ENV = {
    "MAGI_ATTENTION_TELEMETRY": "1",
    "MAGI_ATTENTION_FFA_BLOCK_Q": "128",
    "MAGI_ATTENTION_FFA_BLOCK_K": "128",
    "MAGI_ATTENTION_BACKEND_FFA_BWD": "split",
}
TIMING = {"ts", "pid", "seq", "wall_ms"}
DIVERGENT = {
    "attn_step": {"env_sig", "bwd_key", "bwd_cost"},
    "ffa_plan": {"executed_elems", "executed_ratio", "extent_clamp"},
}


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32) for s in ((S, 2, 32), (S, 1, 32), (S, 1, 32))]


def _load(d: str) -> list[dict]:
    rows = []
    for path in glob.glob(os.path.join(d, "*.jsonl")):
        with open(path) as f:
            rows += [json.loads(line) for line in f]
    return sorted(rows, key=lambda r: r["seq"])


def _fresh_planning():
    """Fresh runtime dicts (their counts are in the records) and empty plan
    caches in both packages, so both plan the step cold."""
    import magiattention_tpu.api.magi_attn_interface as japi_mod
    import magiattention_tpu.dist_attn_runtime_mgr as jmgr
    import magiattention_tpu.kernels.ffa_plan as jplan
    import magiattention_tpu_torch.api.magi_attn_interface as papi_mod
    import magiattention_tpu_torch.dist_attn_runtime_mgr as pmgr
    import magiattention_tpu_torch.kernels.ffa_plan as pplan

    saved = (japi_mod._runtime_dict, papi_mod._runtime_dict)
    japi_mod._runtime_dict = jmgr.DistAttnRuntimeDict()
    papi_mod._runtime_dict = pmgr.DistAttnRuntimeDict()
    for mod in (jmgr, pmgr):
        mod._PLAN_CACHE.clear()
    for mod in (jplan, pplan):
        mod._cached_plan.cache_clear()

    def restore():
        japi_mod._runtime_dict, papi_mod._runtime_dict = saved

    return restore


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """(JAX's directory, the port's directory): one keyed forward each."""
    dj, dp = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    q, k, v = _inputs()
    saved = {name: os.environ.get(name) for name in (*ENV, "MAGI_ATTENTION_TELEMETRY_DIR")}
    restore = _fresh_planning()
    try:
        os.environ.update(ENV, MAGI_ATTENTION_TELEMETRY_DIR=str(dj))
        jtel.reset()
        mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("cp",))
        key = japi.magi_attn_flex_key(DOCS, DOCS, ["causal"] * 2, S, S, mesh=mesh, chunk_size=32)
        out_j, _ = japi.calc_attn(
            japi.dispatch(jnp.asarray(q), key), japi.dispatch(jnp.asarray(k), key),
            japi.dispatch(jnp.asarray(v), key), key,
        )
        jtel.reset()
        os.environ["MAGI_ATTENTION_TELEMETRY_DIR"] = str(dp)
        telemetry.reset()
        key = api.magi_attn_flex_key(DOCS, DOCS, ["causal"] * 2, S, S, device="cpu", chunk_size=32)
        t = torch.from_numpy
        out_p, _ = api.calc_attn(
            api.dispatch(t(q), key), api.dispatch(t(k), key, role="kv"),
            api.dispatch(t(v), key, role="kv"), key,
        )
        telemetry.flush()
        telemetry.reset()
        np.testing.assert_allclose(
            api.undispatch(out_p, key).numpy(),
            np.asarray(japi.undispatch(out_j, japi.get_most_recent_key())), atol=1e-5, rtol=1e-5,
        )
    finally:
        restore()
        for name, val in saved.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val
    return str(dj), str(dp)


def test_record_streams_match_jax(streams):
    dj, dp = streams
    want = [r for r in _load(dj) if r["kind"] != "backend_select"]
    got = [r for r in _load(dp) if r["kind"] != "backend_select"]
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert {"dispatch_meta", "plan_solve", "ffa_plan", "plan_build", "attn_step"} <= {
        r["kind"] for r in got
    }
    for a, b in zip(want, got):
        skip = TIMING | DIVERGENT.get(a["kind"], set())
        fields = (set(a) | set(b)) - skip
        assert {f: b.get(f) for f in fields} == {f: a.get(f) for f in fields}, a["kind"]
        assert a["schema_version"] == b["schema_version"] == telemetry.SCHEMA_VERSION == 1


def test_ffa_plan_executed_is_padded(streams):
    """The port's kernels compute every listed tile whole."""
    for r in _load(streams[1]):
        if r["kind"] == "ffa_plan":
            assert r["executed_elems"] == r["padded_elems"] and r["extent_clamp"] is False


def _report(d: str) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "telemetry_report.py"), "--json", d],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def _strip(agg: dict) -> dict:
    agg = json.loads(json.dumps(agg))
    agg.pop("backend_select", None)
    agg["record_counts"].pop("backend_select", None)
    for section, field in (("ffa_plans", "executed_elems"), ("ffa_plans", "executed_ratio"),
                           ("ffa_plans", "extent_clamp"), ("attn_step", "wall_ms_min"),
                           ("attn_step", "wall_ms_last"), ("plan_solve", "wall_ms_total"),
                           ("plan_solve", "wall_ms_mean")):
        agg.get(section, {}).pop(field, None)
    return agg


def test_report_script_summaries_match(streams):
    dj, dp = streams
    assert _strip(_report(dp)) == _strip(_report(dj))


class _NoClock:
    """time stand-in that fails the test on any clock read."""

    @staticmethod
    def perf_counter():
        raise AssertionError("timer read on the hot path with telemetry off")

    @staticmethod
    def time():
        raise AssertionError("clock read on the hot path with telemetry off")


def _no_event(*args, **kwargs):
    raise AssertionError("torch.cuda.Event created with telemetry off")


def _no_guard(*args, **kwargs):
    raise AssertionError("the guarded path was entered with every resilience flag off")


def test_off_path_is_noop(tmp_path, monkeypatch):
    from magiattention_tpu_torch.resilience import fallback

    for name in ("MAGI_ATTENTION_TELEMETRY", "MAGI_ATTENTION_PROFILE_MODE",
                 "MAGI_ATTENTION_FAULT_INJECT", "MAGI_ATTENTION_NUMERIC_GUARD",
                 "MAGI_ATTENTION_FALLBACK", "MAGI_ATTENTION_STEP_RETRIES",
                 "MAGI_ATTENTION_STRAGGLER_DETECT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    telemetry.reset()
    monkeypatch.setattr(registry, "time", _NoClock)
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    monkeypatch.setattr(fallback, "run_calc_attn", _no_guard)
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    # an unusual chunking: a runtime-dict miss, so the whole plan build runs
    key = api.magi_attn_flex_key(DOCS, DOCS, ["causal"] * 2, S, S, device="cpu", chunk_size=64)
    args = (api.dispatch(q, key), api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv"))
    out, meta = api.calc_attn(*args, key)
    want = _mgr(key).runtime._calc_attn_impl(*args)
    assert torch.equal(out, want[0]) and torch.equal(meta.lse, want[1])
    with telemetry.stage_timer("x"):
        pass
    telemetry.inc("noop")
    telemetry.record_event("noop")
    telemetry.record_timed_event("noop", None)
    assert registry._collector is None, "collector created with the flag off"
    assert list(tmp_path.rglob("*")) == []
    assert telemetry.summary() == {} and telemetry.flat_summary() == {}


class _FakeEvent:
    """A CUDA event stand-in: ``done`` decides ``query()``."""

    def __init__(self, t: float, done: bool) -> None:
        self.t, self.done, self.synced = t, done, False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.synced = True

    def elapsed_time(self, end) -> float:
        return end.t - self.t


def test_timed_records_wait_for_their_events(tmp_path, monkeypatch):
    """A device-timed record is written once its end event completed (at a
    later record) or at flush, in order, stamped ``device_ms``."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    telemetry.reset()
    cpu = torch.device("cpu")
    first = (_FakeEvent(0.0, True), _FakeEvent(2.5, False), cpu)
    telemetry.record_timed_event("attn_step", first, step=0)
    assert _load(str(tmp_path)) == []  # the end event has not completed
    first[1].done = True
    second = (_FakeEvent(5.0, True), _FakeEvent(6.0, False), cpu)
    telemetry.record_timed_event("attn_step", second, step=1)
    rows = _load(str(tmp_path))
    assert [(r["step"], r["device_ms"]) for r in rows] == [(0, 2.5)]
    telemetry.flush()
    rows = _load(str(tmp_path))
    assert [(r["step"], r["device_ms"]) for r in rows] == [(0, 2.5), (1, 1.0)]
    assert second[1].synced
    assert telemetry.device_timer_start(cpu) is None  # no events off the card
    telemetry.reset()


def test_runtime_dict_stats(monkeypatch):
    import magiattention_tpu_torch.dist_attn_runtime_mgr as mgr_mod

    monkeypatch.setattr(mgr_mod, "DistAttnRuntimeMgr", lambda key: object())
    d = mgr_mod.DistAttnRuntimeDict(maxsize=2)
    for name in ("a", "b", "c"):  # 3 misses, 1 eviction (maxsize 2)
        d.get_or_create(name)
    d.get_or_create("c")  # hit
    d.get_or_create("a")  # evicted above -> miss again, evicts "b"
    assert d.get_stats() == {"hits": 1, "misses": 4, "evictions": 2, "size": 2, "maxsize": 2}
    assert d.get("b") is None and d.get("c") is not None


class _FakeBackward(registry.BackwardTimer):
    """A :class:`~magiattention_tpu_torch.telemetry.registry.BackwardTimer`
    on fake events, logging the order autograd records them in."""

    def __init__(self, start: float = 10.0, end: float = 13.5, done: bool = True) -> None:
        self.events = (_FakeEvent(start, True), _FakeEvent(end, done))
        self.recorded = [False, False]
        self.order: list[int] = []

    def record(self, i: int) -> None:
        self.recorded[i] = True
        self.order.append(i)


def test_timed_records_wait_for_their_backward(tmp_path, monkeypatch):
    """A record whose backward began waits for its end event and is
    stamped ``bwd_device_ms``; one whose backward never began is written
    without it."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    telemetry.reset()
    cpu = torch.device("cpu")
    bwd = _FakeBackward(done=False)
    bwd.record(0), bwd.record(1)
    telemetry.record_timed_event("attn_step", (_FakeEvent(0.0, True), _FakeEvent(2.0, True), cpu),
                                 bwd, step=0)
    telemetry.record_timed_event("attn_step", (_FakeEvent(3.0, True), _FakeEvent(4.0, True), cpu),
                                 _FakeBackward(), step=1)
    assert _load(str(tmp_path)) == []  # step 0's backward has not completed
    bwd.events[1].done = True
    telemetry.record_timed_event("attn_step", (_FakeEvent(5.0, True), _FakeEvent(6.0, False), cpu),
                                 None, step=2)
    rows = _load(str(tmp_path))
    assert [(r["step"], r["device_ms"], r.get("bwd_device_ms")) for r in rows] == [
        (0, 2.0, 3.5), (1, 1.0, None)]
    telemetry.flush()
    assert [r["step"] for r in _load(str(tmp_path))] == [0, 1, 2]
    telemetry.reset()


def _timed_step(monkeypatch, grads: bool):
    """One cp 1 API step with the device timers faked on the CPU: the
    forward pair is 2 ms, the backward's 3.5 ms. Returns (out, grads,
    the backward timers made)."""
    made = []

    def bwd_timer(*xs):
        if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
            return None
        made.append(_FakeBackward())
        return made[-1]

    monkeypatch.setattr(telemetry, "device_timer_start",
                        lambda device: (_FakeEvent(0.0, True), _FakeEvent(2.0, True), device))
    monkeypatch.setattr(telemetry, "device_timer_stop", lambda timer: None)
    monkeypatch.setattr(telemetry, "backward_timer", bwd_timer)
    return (*_api_step(grads), made)


def _api_step(grads: bool):
    q, k, v = (torch.from_numpy(a).requires_grad_(grads) for a in _inputs())
    key = api.magi_attn_flex_key(DOCS, DOCS, ["causal"] * 2, S, S, device="cpu")
    with torch.set_grad_enabled(grads):
        out_d, _ = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key, role="kv"),
                                 api.dispatch(v, key, role="kv"), key)
        out = api.undispatch(out_d, key)
    if not grads:
        return out, ()
    return out.detach(), torch.autograd.grad(out, (q, k, v), torch.ones_like(out))


def test_backward_time_stamps_the_step(tmp_path, monkeypatch):
    """With telemetry on, the step's backward is bracketed by the timer's
    two marks (start before end, both in the backward), its gradients
    bitwise those of the unmarked step, and the record carries
    ``bwd_device_ms``; a forward-only step makes no backward timer."""
    for name in ("MAGI_ATTENTION_TELEMETRY", "MAGI_ATTENTION_FAULT_INJECT", "MAGI_ATTENTION_FALLBACK"):
        monkeypatch.delenv(name, raising=False)
    telemetry.reset()
    want_out, want_grads = _api_step(True)
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    out, grads, made = _timed_step(monkeypatch, True)
    assert len(made) == 1 and made[0].order == [0, 1]
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    _, _, made = _timed_step(monkeypatch, False)
    assert made == []
    telemetry.flush()
    steps = [r for r in _load(str(tmp_path)) if r["kind"] == "attn_step"]
    assert [(r["device_ms"], r.get("bwd_device_ms")) for r in steps] == [(2.0, 3.5), (2.0, None)]
    telemetry.reset()


def test_step_payload_built_once_per_plan_build(tmp_path, monkeypatch):
    """The plan-stable part of ``attn_step`` is built at a runtime's first
    recorded step and again only after a plan build; the records of the
    steps between are equal, timings aside."""
    from magiattention_tpu_torch.functional.dist_attn import DistAttnRuntime

    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    telemetry.reset()
    built = []
    real = DistAttnRuntime._attn_step_payload

    def counted(self, q, k, v):
        built.append(1)
        return real(self, q, k, v)

    monkeypatch.setattr(DistAttnRuntime, "_attn_step_payload", counted)
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    key = api.magi_attn_flex_key(DOCS, DOCS, ["causal"] * 2, S, S, device="cpu", chunk_size=32)
    args = (api.dispatch(q, key), api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv"))
    for _ in range(3):
        api.calc_attn(*args, key)
    assert len(built) == 1
    _mgr(key).runtime._build_plans(128, 64)
    api.calc_attn(*args, key)
    assert len(built) == 2
    steps = [{f: x for f, x in r.items() if f not in TIMING}
             for r in _load(str(tmp_path)) if r["kind"] == "attn_step"]
    assert len(steps) == 4 and steps[0] == steps[1] == steps[2] != steps[3]
    assert steps[3]["block_k"] == 64
    telemetry.reset()


def test_resilience_counts_kept_with_telemetry_off(monkeypatch):
    """The resilience layer's action counts are plain ints in the one
    counter dict, with telemetry off too (no collector, no file)."""
    from magiattention_tpu_torch.resilience.fallback import record_resilience_event

    monkeypatch.delenv("MAGI_ATTENTION_TELEMETRY", raising=False)
    telemetry.reset()
    record_resilience_event("fallback", "kernel_lowering")
    record_resilience_event("fallback", "kernel_lowering")
    assert telemetry.counters("resilience.") == {"resilience.fallback": 2}
    assert registry._collector is None
    telemetry.reset()
    assert telemetry.counters() == {}


def test_backward_end_marks_only_inputs_that_require_grad():
    timer = _FakeBackward()
    q, k = torch.ones(2, requires_grad=True), torch.ones(2)
    mq, mk = timer.mark_end(q, k)
    assert mk is k and mq is not q
    (mq * 2).sum().backward()
    assert timer.order == [1] and torch.equal(q.grad, torch.full((2,), 2.0))


def test_a_backlog_is_written_a_few_records_a_step(tmp_path, monkeypatch):
    """Ready records pile up while the host runs ahead; a non-blocking
    drain writes at most ``_DRAIN_BATCH`` of them, flush the rest."""
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    telemetry.reset()
    cpu = torch.device("cpu")
    for step in range(5):  # each waits for a backward that has not begun
        telemetry.record_timed_event("attn_step", (_FakeEvent(0.0, True), _FakeEvent(1.0, True), cpu),
                                     _FakeBackward(), step=step)
    assert _load(str(tmp_path)) == []
    registry._drain(block=False)
    assert [r["step"] for r in _load(str(tmp_path))] == list(range(registry._DRAIN_BATCH))
    telemetry.flush()
    assert [r["step"] for r in _load(str(tmp_path))] == list(range(5))
    telemetry.reset()
