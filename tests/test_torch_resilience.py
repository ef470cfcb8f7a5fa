"""The port's resilience plane against the JAX package's.

- The fault-spec grammar (parsed specs and the typed errors of bad ones)
  and the firing streams of the same specs (per-site ``random.Random(seed)``
  draws, ``step``, ``count``) equal JAX's.
- The numeric guard's verdicts (out must be finite; lse may be -inf but not
  NaN or +inf; ``raise`` against ``record``) equal JAX's.
- JAX's chaos matrix (``tests/test_resilience/test_chaos_matrix.py``) at
  cp 1: each site recovers under MAGI_ATTENTION_FALLBACK=1 with an output
  within float32 1e-5 of JAX's for the same scenario, or raises JAX's typed
  error without it; the tile ladder over the port's Hopper pairs; the
  chain-2 static plan (a failed dynamic solve) field-equal to JAX's.
- The step watchdog (MAGI_ATTENTION_STEP_RETRIES) and its quarantine.
- The serve ladder: a ``serve_decode`` fault descends to the next rung
  (rows within 1e-5 of the replay oracle), or raises without the flag.
- What a kernel failure is: ``KernelBuildError`` propagates under
  MAGI_ATTENTION_FALLBACK=1; a ``KernelLaunchError`` is recovered; the
  typed errors themselves.
- (slow) a gloo cp 2 world in which both ranks take the same hop, and in
  which a NaN on one rank alone under the step watchdog makes both ranks
  hop once (the agreed retry), each bitwise its run pinned at that rung.
- On the card (``fallback.on_card`` faked on the CPU) a failing kernel
  never hands its step to a plain rung.
- The ``step_retry`` site: the retry hop's own fault, recovered under
  MAGI_ATTENTION_FALLBACK=1 like JAX's, typed without it; so the
  ``rank_health_read`` and ``weighted_solve`` sites (every site of
  ``INJECTION_SITES`` has a recover-or-raise test here or in
  ``test_torch_plan_store.py``: the linter's L005 corpus).
- C9's forward half: a gloo cp 2 world in which rank 1 alone fails before
  its last forward collective (three points, two errors), recovered by the
  agreed retry on both ranks, bitwise the unfaulted step
  (``torch_port_cases.c9_worker``).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu import telemetry as jtel
from magiattention_tpu.api import init_dist_attn_runtime_key as j_init_key
from magiattention_tpu.dist_attn_runtime_mgr import DistAttnRuntimeMgr as JMgr
from magiattention_tpu.resilience import errors as jerr
from magiattention_tpu.resilience import guards as jguards
from magiattention_tpu.resilience import inject as jinject
from magiattention_tpu_torch import telemetry
from magiattention_tpu_torch.api import init_dist_attn_runtime_key as p_init_key
from magiattention_tpu_torch.dist_attn_runtime_mgr import DistAttnRuntimeDict
from magiattention_tpu_torch.dist_attn_runtime_mgr import DistAttnRuntimeMgr as PMgr
from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.resilience import errors as perr
from magiattention_tpu_torch.resilience import guards as pguards
from magiattention_tpu_torch.resilience import inject as pinject
from magiattention_tpu_torch.resilience import watchdog
from magiattention_tpu_torch.resilience.fallback import run_calc_attn, tile_ladder
from tests import torch_port_cases
from tests.torch_port_cases import assert_same_fields

S, H, HK, D, CHUNK = 256, 2, 1, 32, 16
TOL = dict(atol=1e-5, rtol=1e-5)
RESILIENCE_ENV = (
    "MAGI_ATTENTION_FAULT_INJECT", "MAGI_ATTENTION_NUMERIC_GUARD", "MAGI_ATTENTION_FALLBACK",
    "MAGI_ATTENTION_STEP_RETRIES", "MAGI_ATTENTION_QO_COMM", "MAGI_ATTENTION_FFA_AUTO_TILE",
    "MAGI_ATTENTION_FFA_BLOCK_Q", "MAGI_ATTENTION_FFA_BLOCK_K", "MAGI_ATTENTION_TELEMETRY",
)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in RESILIENCE_ENV:
        monkeypatch.delenv(var, raising=False)
    for mod in (jinject, pinject, jtel, telemetry, watchdog):
        mod.reset()
    yield
    for mod in (jinject, pinject, jtel, telemetry, watchdog):
        mod.reset()


# ---------------------------------------------------------------------------
# grammar, firing streams, guards
# ---------------------------------------------------------------------------

SPECS = [
    "kernel_lowering", "kernel_lowering:p=0.3:seed=7", "nan_output:step=2",
    "comm_plan_build:count=1", "serve_decode:p=0.5:seed=3:count=4, vmem_check:p=0.25",
    "weighted_solve:step=3:count=1,rank_health_read:p=1.0",
]
BAD_SPECS = [
    "no_such_site", "kernel_lowering:p", "kernel_lowering:q=1", "kernel_lowering:p=x",
    "kernel_lowering,kernel_lowering", "kernel_lowering:seed=1.5",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_and_firing_streams_match(spec):
    got, want = pinject.parse_fault_spec(spec), jinject.parse_fault_spec(spec)
    assert {s: vars(f) for s, f in got.items()} == {s: vars(f) for s, f in want.items()}
    pin, jin = pinject.FaultInjector(spec), jinject.FaultInjector(spec)
    for site in pinject.INJECTION_SITES:
        assert [pin.arm(site) for _ in range(40)] == [jin.arm(site) for _ in range(40)], site
    assert pin.stats() == jin.stats()
    assert pinject.INJECTION_SITES == jinject.INJECTION_SITES


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_the_same_typed_error(spec):
    with pytest.raises(jerr.FaultSpecError) as want:
        jinject.parse_fault_spec(spec)
    with pytest.raises(perr.FaultSpecError) as got:
        pinject.parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


def test_off_builds_no_injector(monkeypatch):
    assert not pinject.should_fire("kernel_lowering")
    pinject.maybe_inject("kernel_lowering")
    assert pinject._injector is None
    with pytest.raises(perr.FaultSpecError):
        pinject.should_fire("not_a_site")


_INF, _NAN = float("inf"), float("nan")
GUARD_CASES = {
    "clean": ([1.0, 2.0], [0.5, -_INF]),
    "nan_out": ([1.0, _NAN], [0.5, 0.5]),
    "inf_out": ([-_INF, 1.0], [0.5, 0.5]),
    "nan_lse": ([1.0, 2.0], [_NAN, 0.5]),
    "pos_inf_lse": ([1.0, 2.0], [_INF, 0.5]),
    "both": ([_NAN, 2.0], [_INF, 0.5]),
}


@pytest.mark.parametrize("policy", ["raise", "record", "1", "0"])
@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_verdicts_match(monkeypatch, policy, case):
    monkeypatch.setenv("MAGI_ATTENTION_NUMERIC_GUARD", policy)
    out, lse = (np.asarray(a, np.float32) for a in GUARD_CASES[case])

    def verdict(check, err, to):
        try:
            check("stage_x", to(out), to(lse))
        except err as e:
            return ("raised", e.stage, e.detail)
        return ("passed",)

    want = verdict(jguards.check_outputs, jerr.NumericGuardError, jnp.asarray)
    assert verdict(pguards.check_outputs, perr.NumericGuardError, torch.from_numpy) == want


# ---------------------------------------------------------------------------
# the chaos matrix at cp 1, against the JAX package's scenarios
# ---------------------------------------------------------------------------


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((S, H, D), (S, HK, D), (S, HK, D))]


def _jax_mgr():
    torch_port_cases.warm_jax_native()
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("cp",))
    return JMgr(j_init_key([[0, S]], [[0, S]], ["causal"], S, S, CHUNK, mesh=mesh), mesh)


def _port_mgr():
    return PMgr(p_init_key([[0, S]], [[0, S]], ["causal"], S, S, CHUNK, device="cpu"))


def _jax_step(mgr, seed=0):
    q, k, v = (jnp.asarray(a) for a in _qkv(seed))
    out, _ = mgr.calc_attn(mgr.dispatch_qo(q), mgr.dispatch_kv(k), mgr.dispatch_kv(v))
    return np.asarray(mgr.undispatch_qo(out))


def _port_step(mgr, seed=0):
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed))
    out, _ = mgr.calc_attn(mgr.dispatch(q), mgr.dispatch(k, "kv"), mgr.dispatch(v, "kv"))
    return mgr.undispatch(out).numpy()


def _both(monkeypatch, env: dict):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jinject.reset()
    pinject.reset()


def test_kernel_lowering_recovers_like_jax(monkeypatch):
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:count=1",
                        "MAGI_ATTENTION_FALLBACK": "1"})
    want = _jax_step(_jax_mgr())
    mgr = _port_mgr()
    np.testing.assert_allclose(_port_step(mgr), want, **TOL)
    # the port's default tiles (64 x 64) are the ladder's bottom, so the
    # chain goes straight to the reference rung; sticky: the next step
    # stays there without re-failing
    assert mgr.runtime.backend == "sdpa_online"
    assert np.isfinite(_port_step(mgr, seed=1)).all()


def test_kernel_lowering_every_call_ends_on_the_reference(monkeypatch):
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:p=1.0",
                        "MAGI_ATTENTION_FALLBACK": "1"})
    jm, pm = _jax_mgr(), _port_mgr()
    np.testing.assert_allclose(_port_step(pm), _jax_step(jm), **TOL)
    assert pm.runtime.backend == jm.runtime.backend == "sdpa_online"
    np.testing.assert_allclose(_port_step(pm, 1), _jax_step(jm, 1), **TOL)  # stays there


def test_kernel_lowering_raises_typed_without_fallback(monkeypatch):
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering"})
    with pytest.raises(perr.InjectedFault, match="kernel_lowering"):
        _port_step(_port_mgr())


class _FakeRuntime:
    def __init__(self, fail_first_n: int):
        self._bq, self._bk = 128, 128
        self._auto_tile_pending = True
        self._backend_override = None
        self.builds = []
        self.calls = 0
        self._fail_first = fail_first_n

    def _build_plans(self, bq, bk):
        self.builds.append((bq, bk))

    def _calc_attn_impl(self, q, k, v, return_max_logits):
        self.calls += 1
        if self.calls <= self._fail_first:
            raise perr.InjectedFault("kernel_lowering", self.calls)
        return ("out", "lse")


# a CPU step's q (the ladder asks only where it lies)
_Q = torch.zeros(1)


def test_ladder_descends_the_hopper_pairs():
    rungs = tile_ladder(128, 128)
    assert rungs == [(128, 64), (64, 128), (64, 64)]
    assert tile_ladder(64, 64) == []  # already at the bottom


def test_ladder_semantics(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    rt = _FakeRuntime(fail_first_n=2)
    assert run_calc_attn(rt, _Q, None, None) == ("out", "lse")
    assert rt.builds == tile_ladder(128, 128)[:2]
    assert rt._auto_tile_pending is False and rt._backend_override is None
    rt = _FakeRuntime(fail_first_n=1 + len(tile_ladder(128, 128)))
    assert run_calc_attn(rt, _Q, None, None) == ("out", "lse")
    assert rt._backend_override == "sdpa_online"
    rt = _FakeRuntime(fail_first_n=10_000)
    with pytest.raises(perr.FallbackExhaustedError) as ei:
        run_calc_attn(rt, _Q, None, None)
    assert isinstance(ei.value.__cause__, perr.InjectedFault)
    assert rt._backend_override is None
    monkeypatch.delenv("MAGI_ATTENTION_FALLBACK")
    rt = _FakeRuntime(fail_first_n=1)
    with pytest.raises(perr.InjectedFault):
        run_calc_attn(rt, _Q, None, None)
    assert rt.builds == []


def test_pinned_128_hops_once_to_128x64(monkeypatch, tmp_path):
    """Tiles pinned 128 x 128: one hop, recorded, the result bitwise the
    run pinned at the rung."""
    _both(monkeypatch, {"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "64"})
    pinned = _port_step(_port_mgr())
    _both(monkeypatch, {"MAGI_ATTENTION_FFA_BLOCK_K": "128", "MAGI_ATTENTION_TELEMETRY": "1",
                        "MAGI_ATTENTION_TELEMETRY_DIR": str(tmp_path),
                        "MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:count=1",
                        "MAGI_ATTENTION_FALLBACK": "1"})
    mgr = _port_mgr()
    assert (mgr.runtime._bq, mgr.runtime._bk) == (128, 128)
    got = _port_step(mgr)
    assert np.array_equal(got, pinned)
    last = telemetry.summary()["last"]["resilience"]
    assert (last["action"], last["action_detail"], last["blocks"]) == ("recovered", "ladder_hop", [128, 64])
    assert telemetry.summary()["counters"]["resilience.fallback"] == 1


def test_vmem_check_recovers_with_default_blocks(monkeypatch):
    base = _port_step(_port_mgr())
    _both(monkeypatch, {"MAGI_ATTENTION_FFA_AUTO_TILE": "1",
                        "MAGI_ATTENTION_FAULT_INJECT": "vmem_check",
                        "MAGI_ATTENTION_FALLBACK": "1"})
    np.testing.assert_allclose(_port_step(_port_mgr()), base, **TOL)
    monkeypatch.delenv("MAGI_ATTENTION_FALLBACK")
    with pytest.raises(perr.InjectedFault, match="vmem_check"):
        _port_step(_port_mgr())


def test_dynamic_solve_falls_back_to_jaxs_static_plan(monkeypatch):
    base = _jax_step(_jax_mgr())
    _both(monkeypatch, {"MAGI_ATTENTION_QO_COMM": "1",
                        "MAGI_ATTENTION_FAULT_INJECT": "dynamic_plan_solve",
                        "MAGI_ATTENTION_FALLBACK": "1"})
    jm, pm = _jax_mgr(), _port_mgr()
    assert pm.dynamic_plan is None and jm.dynamic_plan is None
    assert_same_fields(pm.comm_meta, jm.comm_meta, "comm ")
    assert_same_fields(pm.calc_meta, jm.calc_meta, "calc ")
    np.testing.assert_allclose(_port_step(pm), base, **TOL)
    monkeypatch.delenv("MAGI_ATTENTION_FALLBACK")
    with pytest.raises(perr.InjectedFault, match="dynamic_plan_solve"):
        _port_mgr()


def test_comm_plan_build_bounded_retry(monkeypatch, tmp_path):
    key = p_init_key([[0, S]], [[0, S]], ["causal"], S, S, 32, device="cpu")
    # every build solves (no plan-cache hit)
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "comm_plan_build:count=1",
                        "MAGI_ATTENTION_FALLBACK": "1", "MAGI_ATTENTION_PLAN_CACHE": "0",
                        "MAGI_ATTENTION_TELEMETRY": "1", "MAGI_ATTENTION_TELEMETRY_DIR": str(tmp_path)})
    d = DistAttnRuntimeDict(maxsize=4)
    assert d.get_or_create(key).calc_meta is not None  # attempt 1 failed, the retry built
    assert len(d) == 1
    assert telemetry.summary()["counters"]["resilience.retry"] == 1
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "comm_plan_build:count=2"})
    d = DistAttnRuntimeDict(maxsize=4)
    with pytest.raises(perr.InjectedFault):
        d.get_or_create(key)  # both attempts fail: typed, never cached
    assert len(d) == 0
    monkeypatch.delenv("MAGI_ATTENTION_FALLBACK")
    pinject.reset()
    with pytest.raises(perr.InjectedFault, match="comm_plan_build"):
        d.get_or_create(key)


def test_nan_output_guard(monkeypatch):
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "nan_output",
                        "MAGI_ATTENTION_NUMERIC_GUARD": "raise"})
    with pytest.raises(perr.NumericGuardError, match="calc_attn") as ei:
        _port_step(_port_mgr())
    assert "out" in ei.value.detail and ei.value.stage == "DistAttnRuntime.calc_attn"
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "nan_output:step=1",
                        "MAGI_ATTENTION_NUMERIC_GUARD": "record"})
    assert np.isnan(_port_step(_port_mgr())).any()
    monkeypatch.delenv("MAGI_ATTENTION_FAULT_INJECT")
    monkeypatch.setenv("MAGI_ATTENTION_NUMERIC_GUARD", "raise")
    assert np.isfinite(_port_step(_port_mgr())).all()


STEP_RETRY_ENV = {"MAGI_ATTENTION_STEP_RETRIES": "1", "MAGI_ATTENTION_NUMERIC_GUARD": "raise",
                  "MAGI_ATTENTION_FAULT_INJECT": "nan_output:count=1,step_retry:p=1.0"}


def test_step_retry_hop_fault_recovers(monkeypatch):
    """The ``step_retry`` site (JAX's ``test_straggler_chaos.py``
    ``TestStepRetry``): the watchdog's retry hop itself faults, and under
    MAGI_ATTENTION_FALLBACK=1 the hop goes on; the step's output is within
    float32 1e-5 of JAX's for the same scenario and of the unfaulted step."""
    base = _port_step(_port_mgr())
    _both(monkeypatch, {**STEP_RETRY_ENV, "MAGI_ATTENTION_FALLBACK": "1"})
    got, want = _port_step(_port_mgr()), _jax_step(_jax_mgr())
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, base, **TOL)
    assert telemetry.counters("resilience.").get("resilience.fallback", 0) == 1


def test_step_retry_raises_typed_without_fallback(monkeypatch):
    """Without MAGI_ATTENTION_FALLBACK the retry hop's fault raises JAX's
    typed ``InjectedFault`` naming the site, in both packages."""
    _both(monkeypatch, STEP_RETRY_ENV)
    with pytest.raises(jerr.InjectedFault, match="step_retry"):
        _jax_step(_jax_mgr())
    with pytest.raises(perr.InjectedFault, match="step_retry"):
        _port_step(_port_mgr())


def test_watchdog_retries_the_next_rung_and_quarantines(monkeypatch):
    base = _port_step(_port_mgr())
    _both(monkeypatch, {"MAGI_ATTENTION_STEP_RETRIES": "1",
                        "MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:count=1"})
    mgr = _port_mgr()
    np.testing.assert_allclose(_port_step(mgr), base, **TOL)
    assert mgr.runtime.backend == "sdpa"  # the registry's next calc_attn rung, sticky
    # a second trip of the same backend on the same key quarantines it
    key = watchdog._decision_key(mgr.runtime)
    assert watchdog.note_trip(key, "ffa", allow_quarantine=True)
    assert watchdog.is_quarantined(key, "ffa")
    monkeypatch.setenv("MAGI_ATTENTION_STEP_RETRIES", "0")
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", "kernel_lowering")
    pinject.reset()
    with pytest.raises(perr.InjectedFault):
        _port_step(_port_mgr())


# ---------------------------------------------------------------------------
# the serve ladder
# ---------------------------------------------------------------------------


def _serve(monkeypatch, env: dict):
    from magiattention_tpu_torch.serving import ServeConfig, ServeEngine, ServeRequest, ToyModel
    from magiattention_tpu_torch.serving import run_reference

    model = ToyModel.create(device="cpu")
    reqs = [ServeRequest(i, model.prompt(n, seed=10 + i), new)
            for i, (n, new) in enumerate([(5, 4), (17, 4)])]
    replay = run_reference(model, reqs, ServeConfig())
    _both(monkeypatch, env)
    ServeEngine(model, ServeConfig()).run(reqs)
    return reqs, replay


def test_serve_decode_fault_descends(monkeypatch, tmp_path):
    reqs, replay = _serve(monkeypatch, {
        "MAGI_ATTENTION_FAULT_INJECT": "serve_decode:count=2", "MAGI_ATTENTION_FALLBACK": "1",
        "MAGI_ATTENTION_TELEMETRY": "1", "MAGI_ATTENTION_TELEMETRY_DIR": str(tmp_path),
    })
    for r in reqs:
        np.testing.assert_allclose(np.stack(r.generated), np.stack(replay[r.req_id]), atol=1e-5)
    s = telemetry.summary()
    assert s["counters"]["resilience.fallback"] == 2
    assert s["last"]["resilience"]["action_detail"] == "paged_decode_to_gather_ffa"
    assert s["counters"]["serve.steps"] > 0


def test_serve_decode_fault_raises_without_fallback(monkeypatch):
    with pytest.raises(perr.InjectedFault, match="serve_decode"):
        _serve(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "serve_decode"})


# ---------------------------------------------------------------------------
# what a kernel failure is
# ---------------------------------------------------------------------------


def _failing_fwd(err):
    def fwd(*args, **kwargs):
        raise err

    return fwd


def test_kernel_build_error_is_never_recovered(monkeypatch):
    from magiattention_tpu_torch.functional import dist_attn

    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    monkeypatch.setattr(dist_attn, "ffa_fwd_dispatch", _failing_fwd(_build.KernelBuildError("no nvcc")))
    with pytest.raises(_build.KernelBuildError):
        _port_step(_port_mgr())


def test_kernel_launch_error_is_recovered(monkeypatch):
    from magiattention_tpu_torch.functional import dist_attn

    base = _port_step(_port_mgr())
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    monkeypatch.setattr(dist_attn, "ffa_fwd_dispatch", _failing_fwd(_build.KernelLaunchError("x", 9)))
    mgr = _port_mgr()
    np.testing.assert_allclose(_port_step(mgr), base, **TOL)  # every tile failed: the reference
    assert mgr.runtime.backend == "sdpa_online"


def test_typed_build_error(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found") as ei:
        _build._nvcc()
    assert isinstance(ei.value, RuntimeError)


def test_typed_launch_error():
    class _Lib:
        @staticmethod
        def magi_error_string(code):
            return b"invalid configuration argument"

    _build.check(_Lib, 0, "ok_kernel")
    with pytest.raises(_build.KernelLaunchError, match="CUDA error 9") as ei:
        _build.check(_Lib, 9, "ffa_fwd_kernel")
    assert ei.value.code == 9 and isinstance(ei.value, RuntimeError)


# ---------------------------------------------------------------------------
# on the card: kernel-to-kernel rungs only
# ---------------------------------------------------------------------------


def _never(name):
    def plain(*args, **kwargs):
        raise AssertionError(f"{name}: a plain rung ran in a kernel's place on the card")

    return plain


@pytest.fixture
def card(monkeypatch):
    """Steps as if their tensors lay on the card (``fallback.on_card``),
    every plain rung a failure of the test."""
    from magiattention_tpu_torch.functional import dist_attn
    from magiattention_tpu_torch.resilience import fallback
    from magiattention_tpu_torch.serving import decode

    monkeypatch.setattr(fallback, "on_card", lambda t: True)
    for mod, name in ((dist_attn, "sdpa_attn"), (dist_attn, "sdpa_online_attn"),
                      (decode, "_dense_decode"), (decode, "_dense_verify")):
        monkeypatch.setattr(mod, name, _never(name))


@pytest.mark.parametrize("tiles", [{}, {"MAGI_ATTENTION_FFA_BLOCK_Q": "128",
                                        "MAGI_ATTENTION_FFA_BLOCK_K": "128"}])
def test_card_launch_error_never_reaches_a_plain_rung(monkeypatch, card, tiles):
    """A KernelLaunchError under MAGI_ATTENTION_FALLBACK=1 descends the tile
    ladder and then raises FallbackExhaustedError: nothing is pinned, the
    next step fails the same way."""
    from magiattention_tpu_torch.functional import dist_attn

    _both(monkeypatch, {**tiles, "MAGI_ATTENTION_FALLBACK": "1"})
    monkeypatch.setattr(dist_attn, "ffa_fwd_dispatch", _failing_fwd(_build.KernelLaunchError("x", 9)))
    mgr = _port_mgr()
    for _ in range(2):
        with pytest.raises(perr.FallbackExhaustedError) as ei:
            _port_step(mgr)
        assert isinstance(ei.value.__cause__, _build.KernelLaunchError)
        assert mgr.runtime.backend == "ffa"


def test_card_injected_faults_end_in_an_exhausted_chain(monkeypatch, card):
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:p=1.0",
                        "MAGI_ATTENTION_FALLBACK": "1", "MAGI_ATTENTION_FFA_BLOCK_Q": "128",
                        "MAGI_ATTENTION_FFA_BLOCK_K": "128"})
    mgr = _port_mgr()
    with pytest.raises(perr.FallbackExhaustedError) as ei:
        _port_step(mgr)
    assert isinstance(ei.value.__cause__, perr.InjectedFault)
    assert mgr.runtime.backend == "ffa"
    assert telemetry.counters("resilience.")["resilience.injected"] == 1 + len(tile_ladder(128, 128))


def test_card_watchdog_retries_the_kernel_rung(monkeypatch, card):
    """MAGI_ATTENTION_STEP_RETRIES on the card re-runs ``ffa`` (the last
    kernel rung, never quarantined); a lasting fault re-raises."""
    base = _port_step(_port_mgr())
    _both(monkeypatch, {"MAGI_ATTENTION_STEP_RETRIES": "2",
                        "MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:count=2"})
    mgr = _port_mgr()
    np.testing.assert_allclose(_port_step(mgr), base, **TOL)
    assert mgr.runtime.backend == "ffa"
    assert not watchdog.is_quarantined(watchdog._decision_key(mgr.runtime), "ffa")
    assert telemetry.counters("resilience.") == {
        "resilience.injected": 2, "resilience.retry": 2, "resilience.recovered": 1}
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:p=1.0"})
    with pytest.raises(perr.InjectedFault):
        _port_step(_port_mgr())


def test_card_serve_fault_descends_to_gather_ffa(monkeypatch, card):
    reqs, replay = _serve(monkeypatch, {
        "MAGI_ATTENTION_FAULT_INJECT": "serve_decode:count=2", "MAGI_ATTENTION_FALLBACK": "1"})
    for r in reqs:
        np.testing.assert_allclose(np.stack(r.generated), np.stack(replay[r.req_id]), atol=1e-5)
    assert telemetry.counters("resilience.")["resilience.fallback"] == 2


def test_card_serve_ladder_stops_before_dense(monkeypatch, card):
    from magiattention_tpu_torch.serving import decode

    monkeypatch.setattr(decode, "_gather_ffa_decode", _failing_fwd(_build.KernelLaunchError("x", 9)))
    with pytest.raises(perr.FallbackExhaustedError) as ei:
        _serve(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "serve_decode",
                             "MAGI_ATTENTION_FALLBACK": "1"})
    assert isinstance(ei.value.__cause__, _build.KernelLaunchError)


# ---------------------------------------------------------------------------
# the watchdog at cp > 1, and its runtime key
# ---------------------------------------------------------------------------


class _WatchedRuntime:
    """A runtime whose first step fails with ``fail`` (an error, or "nan":
    a NaN output), logging the backend of every attempt. At cp > 1 its
    agreement hook logs the flag this rank sends and answers with the
    group's MAX, the peer's outcomes taken from ``peer`` (one a call,
    False when it runs out); ``comm_done`` False: the failure comes before
    the step's last forward collective, and ``complete_fwd_comm`` (logged
    in ``completed``) issues the rest, or fails where ``complete_fails``."""

    def __init__(self, cp_size: int, fail, peer=(), comm_done: bool = True,
                 complete_fails: bool = False) -> None:
        self.cp_size, self._fail = cp_size, [fail]
        self._backend, self._backend_override = "ffa", None
        self._auto_tile_pending = False
        self._peer, self._comm_done = list(peer), comm_done
        self._complete_fails = complete_fails
        self.backends: list[str] = []
        self.sent: list[bool] = []
        self.completed: list[str] = []

    def complete_fwd_comm(self, q, k, v) -> None:
        self.completed.append(self.backend)
        if self._complete_fails:
            raise RuntimeError("the completion's own exchange failed")
        self._fwd_comm_done = True

    @property
    def backend(self) -> str:
        return self._backend_override or self._backend

    def _calc_attn_impl(self, q, k, v, return_max_logits):
        self.backends.append(self.backend)
        self._fwd_comm_done = True
        fail = self._fail.pop() if self._fail else None
        if fail == "nan":
            return torch.full((2,), float("nan")), torch.zeros(2)
        if fail is not None:
            self._fwd_comm_done = self._comm_done
            raise fail
        return torch.zeros(2), torch.zeros(2)

    def agree_step_failure(self, failed: bool, device) -> bool:
        self.sent.append(failed)
        return failed or (self._peer.pop(0) if self._peer else False)


@pytest.mark.parametrize("fail", ["nan", "launch", "injected"])
@pytest.mark.parametrize("cp_size", [1, 2])
def test_watchdog_at_cp2_retries_only_injected_faults(monkeypatch, cp_size, fail):
    """A NaN, a launch error and an injected fault raised after the step's
    last forward collective are retried at cp 1 and at cp 2 alike; at cp 2
    the outcome is agreed first (one flag a step through the runtime's
    hook: this rank's failure, then its success on the next rung)."""
    monkeypatch.setenv("MAGI_ATTENTION_STEP_RETRIES", "1")
    monkeypatch.setenv("MAGI_ATTENTION_NUMERIC_GUARD", "raise")
    err = {"nan": "nan", "launch": _build.KernelLaunchError("x", 9),
           "injected": perr.InjectedFault("kernel_lowering", 1)}[fail]
    rt = _WatchedRuntime(cp_size, err)
    run_calc_attn(rt, _Q, None, None)
    assert rt.backends == ["ffa", "sdpa"]
    assert rt.sent == ([] if cp_size == 1 else [True, False])


@pytest.mark.parametrize("peer", [[True], [True, True]])
def test_watchdog_at_cp2_follows_a_peer(monkeypatch, peer):
    """A rank whose step succeeded moves to the next rung with its peer
    when the peer failed, and counts the trip as the peer does; when the
    peer fails every rung, the rank raises with it."""
    monkeypatch.setenv("MAGI_ATTENTION_STEP_RETRIES", "1")
    rt = _WatchedRuntime(2, None, peer=peer)
    if len(peer) == 1:
        run_calc_attn(rt, _Q, None, None)
        assert rt._backend_override == "sdpa"
    else:
        with pytest.raises(perr.FallbackExhaustedError, match="peer"):
            run_calc_attn(rt, _Q, None, None)
        assert rt._backend_override is None
    assert rt.backends == ["ffa", "sdpa"] and rt.sent == [False, False]
    assert watchdog._trips[(watchdog._canonical(watchdog._decision_key(rt)), "ffa")] == 1


@pytest.mark.parametrize("complete_fails", [False, True])
@pytest.mark.parametrize("err", [_build.KernelLaunchError("x", 9), torch.cuda.OutOfMemoryError("oom")])
def test_watchdog_at_cp2_raises_before_the_last_collective(monkeypatch, err, complete_fails):
    """A launch error or an out-of-memory raised before the step's last
    forward collective: the rank first issues the collectives it did not
    reach (``complete_fwd_comm``, once), then agrees on the failure and
    moves to the next rung with its peers. Where the completion itself
    fails, no agreement can reach a waiting peer: it raises the attempt's
    error, typed, with no flag sent."""
    monkeypatch.setenv("MAGI_ATTENTION_STEP_RETRIES", "1")
    rt = _WatchedRuntime(2, err, comm_done=False, complete_fails=complete_fails)
    before = telemetry.counters("resilience.").get("resilience.fwd_comm_completed", 0)
    if complete_fails:
        with pytest.raises(type(err)):
            run_calc_attn(rt, _Q, None, None)
        assert rt.backends == ["ffa"] and rt.sent == [] and rt._backend_override is None
    else:
        run_calc_attn(rt, _Q, None, None)
        assert rt.backends == ["ffa", "sdpa"] and rt.sent == [True, False]
    assert rt.completed == ["ffa"]
    after = telemetry.counters("resilience.").get("resilience.fwd_comm_completed", 0)
    assert after - before == int(not complete_fails)


def test_watchdog_off_adds_no_collective(monkeypatch):
    """With MAGI_ATTENTION_STEP_RETRIES unset no failure flag is reduced:
    the guarded step at cp 2 never calls the agreement hook."""
    monkeypatch.setenv("MAGI_ATTENTION_NUMERIC_GUARD", "raise")
    rt = _WatchedRuntime(2, None)
    run_calc_attn(rt, _Q, None, None)
    assert rt.backends == ["ffa"] and rt.sent == []


@pytest.mark.parametrize("retries", ["0", "1"])
def test_clean_step_completes_nothing(monkeypatch, retries):
    """A step that does not fail completes no collective and issues no
    exchange, with the watchdog on or off."""
    from magiattention_tpu_torch.comm import primitives

    monkeypatch.setenv("MAGI_ATTENTION_STEP_RETRIES", retries)
    rt = _WatchedRuntime(2, None)
    mark = primitives.exchanges_issued()
    run_calc_attn(rt, _Q, None, None)
    assert rt.completed == [] and primitives.exchanges_issued() == mark
    assert rt.sent == ([False] if retries == "1" else [])


def test_step_retries_keys_the_runtime(monkeypatch):
    """A runtime the watchdog pinned is never handed to a run without the
    flag: MAGI_ATTENTION_STEP_RETRIES is in the runtime key."""
    from magiattention_tpu_torch.env import general

    assert "MAGI_ATTENTION_STEP_RETRIES" in general.ENV_KEYS_AFFECTING_RUNTIME
    off = p_init_key([[0, S]], [[0, S]], ["causal"], S, S, CHUNK, device="cpu")
    monkeypatch.setenv("MAGI_ATTENTION_STEP_RETRIES", "1")
    assert p_init_key([[0, S]], [[0, S]], ["causal"], S, S, CHUNK, device="cpu") != off


# ---------------------------------------------------------------------------
# cp 2 over gloo: both ranks take the same hop
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_cp2_symmetric_hop():
    from tests.torch_port_cases import resilience_worker

    with tempfile.TemporaryDirectory() as d:
        init = os.path.join(d, "init")
        mp.start_processes(resilience_worker, args=(2, init, d), nprocs=2, start_method="spawn", join=True)
        outs = [np.load(os.path.join(d, f"rank{r}.npz")) for r in range(2)]
    for o in outs:
        assert np.array_equal(o["faulted"], o["pinned"])
        assert int(o["hops"]) == 1
    assert np.array_equal(outs[0]["faulted"], outs[1]["faulted"])
    # a NaN on rank 0 alone under the watchdog: the ranks agree on the
    # failure, both hop once to the next rung (sdpa), and each rank's
    # output equals its run pinned there to the bit
    assert [str(o["nan_step"]) for o in outs] == ["ok", "ok"]
    for o in outs:
        assert int(o["nan_hops"]) == 1
        assert np.array_equal(o["nan_out"], o["nan_pinned"])


def test_chip_smoke_refuses_a_resilience_flag():
    """chip_smoke.py sets the resilience flags only inside its own phases:
    started with one set, it refuses before touching the card."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for flag in ("MAGI_ATTENTION_FALLBACK", "MAGI_ATTENTION_STRAGGLER_DETECT"):
        env = dict(os.environ, **{flag: "1"}, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1 and flag in proc.stderr, proc.stderr
        assert proc.stdout == ""


# ---------------------------------------------------------------------------
# C9's forward half at cp 2 over gloo: rank 1 alone fails before its last
# forward collective
# ---------------------------------------------------------------------------


def test_cp2_failure_before_the_last_forward_collective_is_recovered():
    """Rank 1 alone raises a launch error or an out-of-memory before the
    static runtime's casts, between its casts and the max-logits
    all-reduce, and in the qo-comm runtime before its return cast. It
    issues the collectives it did not reach, both ranks agree and retry
    once (the card's rungs: ``ffa`` again), and every rank's out, lse,
    gradients and max-logits are bitwise its unfaulted step. The group's
    timeout and the join's bound a regression to a failure, not a hang."""
    import time

    from tests.torch_port_cases import C9_ERRORS, C9_POINTS, c9_worker

    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(c9_worker, args=(2, os.path.join(d, "init"), d), nprocs=2,
                                 start_method="spawn", join=False)
        deadline = time.monotonic() + 240
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the cp 2 world hung")
        rows = [np.load(os.path.join(d, f"rank{r}.npz"))["rows"] for r in range(2)]
    n = len(C9_POINTS) * len(C9_ERRORS)
    for r in range(2):
        assert rows[r].shape == (n, 5)
        # bitwise, the fault fired (disarmed), completions, retries, recoveries
        want = [1, 0, int(r == 1), 1, 1]
        assert all(list(row) == want for row in rows[r]), (r, rows[r])


# ---------------------------------------------------------------------------
# the straggler sites: rank_health_read and weighted_solve, recover-or-raise
# as in JAX's tests/test_resilience/test_straggler_chaos.py
# ---------------------------------------------------------------------------


def _degraded_health(mod, cp=4):
    """A persistent straggler on the last rank of ``cp`` (fake clock)."""
    mod.reset()
    for _ in range(8):
        for r in range(cp - 1):
            mod.observe_step(r, 10.0)
        mod.observe_step(cp - 1, 40.0)


@pytest.mark.parametrize("fallback", [True, False])
def test_rank_health_read_recovers_or_raises_like_jax(monkeypatch, fallback):
    """A faulted capacity read degrades to the uniform vector (None) under
    MAGI_ATTENTION_FALLBACK=1, else raises the typed ``InjectedFault``, as
    in the JAX package; unfaulted, both read the same degraded vector."""
    from magiattention_tpu.telemetry import health as jhealth
    from magiattention_tpu_torch.telemetry import health as phealth

    monkeypatch.setenv("MAGI_ATTENTION_STRAGGLER_DETECT", "1")
    try:
        for mod in (jhealth, phealth):
            _degraded_health(mod)
        assert phealth.active_capacities(4) == jhealth.active_capacities(4) is not None
        _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "rank_health_read:p=1.0",
                            **({"MAGI_ATTENTION_FALLBACK": "1"} if fallback else {})})
        if fallback:
            assert phealth.active_capacities(4) is None and jhealth.active_capacities(4) is None
        else:
            with pytest.raises(jerr.InjectedFault, match="rank_health_read"):
                jhealth.active_capacities(4)
            with pytest.raises(perr.InjectedFault, match="rank_health_read"):
                phealth.active_capacities(4)
    finally:
        jhealth.reset()
        phealth.reset()


@pytest.mark.parametrize("fallback", [True, False])
def test_weighted_solve_recovers_or_raises_like_jax(monkeypatch, fallback):
    """A faulted weighted solve degrades to the uniform partitions under
    MAGI_ATTENTION_FALLBACK=1 (the port's equal the JAX package's and the
    unweighted solve's), else raises the typed ``InjectedFault``."""
    from magiattention_tpu.common.enum import AttnMaskType as JType
    from magiattention_tpu.common.enum import DispatchAlgType as JAlg
    from magiattention_tpu.common.ranges import AttnRanges as JRanges
    from magiattention_tpu.config import DispatchConfig as JConfig
    from magiattention_tpu.meta import make_dispatch_meta_from_qk_ranges as j_meta
    from magiattention_tpu_torch.common.enum import AttnMaskType, DispatchAlgType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.config import DispatchConfig
    from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges as p_meta

    def solve(pkg, caps=None):
        ranges, mtype, alg, config, meta = pkg
        mq, _, _ = meta(ranges.from_ranges([[0, S]]), ranges.from_ranges([[0, S]]), [mtype.CAUSAL],
                        S, S, CHUNK, 4, dispatch_config=config(alg=alg.MIN_HEAP), capacities=caps)
        return [list(p) for p in mq.partitions]

    port = (AttnRanges, AttnMaskType, DispatchAlgType, DispatchConfig, p_meta)
    jax_ = (JRanges, JType, JAlg, JConfig, j_meta)
    torch_port_cases.warm_jax_native()
    base = solve(port)
    assert base == solve(jax_)
    caps = [1.0, 1.0, 1.0, 0.25]
    _both(monkeypatch, {"MAGI_ATTENTION_FAULT_INJECT": "weighted_solve:p=1.0",
                        **({"MAGI_ATTENTION_FALLBACK": "1"} if fallback else {})})
    if fallback:
        assert solve(port, caps) == solve(jax_, caps) == base
    else:
        with pytest.raises(jerr.InjectedFault, match="weighted_solve"):
            solve(jax_, caps)
        with pytest.raises(perr.InjectedFault, match="weighted_solve"):
            solve(port, caps)
