"""The port's profiler ranges carry the JAX package's scope names.

Under MAGI_ATTENTION_PROFILE_MODE=1, a forward and backward through the
API at cp 1 under ``torch.profiler`` on the CPU shows the runtime's and
the kernels' ranges (``DistAttnRuntime.calc_attn``, ``ffa_fwd_stage0``,
``ffa_bwd_delta``, ``ffa_bwd``; the qo-comm runtime's ``qo_comm_cast`` and
``ffa_fwd_dyn``); the GroupCast of a stage and its GroupReduce (over a
stand-in plan, no process group) show ``group_cast_stage{i}`` and
``group_reduce_<lowering>``. With the flag unset no range is opened.
``switch_profile`` writes a Chrome trace.
"""

import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from magiattention_tpu_torch import api
from magiattention_tpu_torch.comm.primitives import group_cast_all
from magiattention_tpu_torch.utils.profiling import instrument_scope, profile_scope, switch_profile
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

S = 256
DOCS = [[0, 128], [128, 256]]


def _names(fn) -> set[str]:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _api_fwd_bwd(chunk: int):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
               for s in ((S, 2, 32), (S, 1, 32), (S, 1, 32)))

    def run():
        key = api.magi_attn_flex_key(DOCS, DOCS, ["causal"] * 2, S, S, device="cpu", chunk_size=chunk)
        out, _ = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key, role="kv"),
                               api.dispatch(v, key, role="kv"), key)
        api.undispatch(out, key).sum().backward()

    return run


def test_cp1_ranges_carry_jax_scope_names(monkeypatch):
    from magiattention_tpu_torch.api.magi_attn_interface import clear_cache
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _PLAN_CACHE
    from magiattention_tpu_torch.kernels.ffa_plan import _cached_plan

    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    clear_cache()  # the planners run inside the profiled call
    _PLAN_CACHE.clear()
    _cached_plan.cache_clear()
    names = _names(_api_fwd_bwd(32))
    assert {"DistAttnRuntime.calc_attn", "ffa_fwd_stage0", "ffa_bwd_delta", "ffa_bwd"} <= names
    # the host planners' ranges (instrument_host: their function names)
    assert {"make_attn_meta_from_dispatch_meta", "build_ffa_plan"} <= names


def test_qo_comm_ranges(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    names = _names(_api_fwd_bwd(32))
    assert {"DynamicDistAttnRuntime.calc_attn", "qo_comm_cast", "ffa_fwd_dyn",
            "ffa_bwd_delta", "ffa_bwd"} <= names


class _Plan:
    """A stand-in cast plan: the stage's buffer is x itself, the reduce
    hands the gradient back (no process group)."""

    lowering = "a2a"

    def cast_start(self, x, group, out_dtype):
        return x.detach().to(out_dtype).clone(), lambda: None

    def reduce_start(self, g, group, dtype):
        return g

    def reduce_finish(self, total, handle, group, shard_len):
        return handle.float() if total is None else total + handle.float()


def test_cast_and_reduce_ranges(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    x = torch.ones(4, 2, requires_grad=True)

    def run():
        parts, waits = group_cast_all(x, [_Plan(), _Plan()], None)
        for w in waits:
            w()
        sum(p.sum() for p in parts).backward()

    names = _names(run)
    assert {"group_cast_stage0", "group_cast_stage1", "group_reduce_a2a"} <= names


def test_off_opens_no_range(monkeypatch):
    monkeypatch.delenv("MAGI_ATTENTION_PROFILE_MODE", raising=False)
    names = _names(_api_fwd_bwd(64))
    assert not names & {"DistAttnRuntime.calc_attn", "ffa_fwd_stage0", "ffa_bwd", "build_ffa_plan"}

    @instrument_scope(name="x_scope")
    def f(a):
        return a + 1

    def g():
        with profile_scope("y_scope"):
            f(1)

    assert not _names(g) & {"x_scope", "y_scope"}
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    assert {"x_scope", "y_scope"} <= _names(g)


def test_switch_profile_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_PROFILE_MODE", "1")
    with switch_profile(log_dir=str(tmp_path)) as prof:
        with profile_scope("lse_merge"):
            torch.ones(3).sum()
    assert os.path.exists(prof.trace_path)
    with open(prof.trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("name") == "lse_merge" for e in events)
