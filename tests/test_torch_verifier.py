"""The port's plan verifier (``analysis/``) against the JAX package's.

- One seeded corpus of plans built by both planners (field-equal, as
  ``test_torch_planners.py`` holds): causal, two documents and a sliding
  window at cp 1, 2 and 4 (overlap degree 2), a two-level (dcn 2, ici 2)
  plan and qo-comm dynamic plans at cp 2 and 4. Both verifiers give the
  same ``rules_run``, the same fired rules and the same (rule, severity)
  multiset for R1-R4, clean and under the same seeded mutations (an
  inverted range, a dropped chunk, a duplicated cast row, a stage that
  misses remote work), as ``tests/test_analysis/test_verifier_rules.py``
  mutates JAX's.
- R5 on the port's own rules: the default 64 x 64 passes; a block outside
  the compiled set, a backward override that does not divide the
  forward-padded geometry and a tile over the shared-memory limit each
  fail; every compiled instance passes, and one whose CTA is a byte past
  the limit fails, for bf16 and float32 at d 64, 128 and 256.
- The manager's hook (``MAGI_ATTENTION_VERIFY_PLANS=1``), as
  ``tests/test_analysis/test_runtime_hook.py`` drives JAX's: off by
  default, clean builds, a ``plan_verify`` record, and
  ``PlanVerificationError`` on a corrupted manager.
"""

import collections
import copy
import glob
import json

import numpy as np
import pytest

from magiattention_tpu import analysis as j_analysis
from magiattention_tpu.analysis import verifier as j_verifier
from magiattention_tpu_torch import analysis as p_analysis
from magiattention_tpu_torch.analysis import verifier as p_verifier
from magiattention_tpu_torch.utils import mem_budget
from tests.torch_port_cases import assert_same_fields, warm_jax_native

SEQ, CHUNK = 512, 32


@pytest.fixture(scope="module", autouse=True)
def _warm_jax_native():
    warm_jax_native()


def _window_mask():
    """A sliding window of 64 keys over 512 tokens (JAX's mask compiler)."""
    from magiattention_tpu.api.functools import infer_attn_mask_from_cu_seqlens

    qr, kr, types = infer_attn_mask_from_cu_seqlens([0, SEQ], causal=False, window_size=(64, 0))
    return (
        [list(map(int, r)) for r in qr.to_naive_ranges()],
        [list(map(int, r)) for r in kr.to_naive_ranges()],
        [int(t.to_int_type()) for t in types],
    )


MASKS = {
    "causal": ([[0, SEQ]], [[0, SEQ]], [1]),
    "two_docs": ([[0, 256], [256, SEQ]], [[0, 256], [256, SEQ]], [1, 1]),
    "window": None,  # built from JAX's mask compiler at first use
}


def _mask(name):
    if MASKS[name] is None:
        MASKS[name] = _window_mask()
    return MASKS[name]


def _pkg(name):
    import importlib

    return {
        mod: importlib.import_module(f"{name}.{mod}")
        for mod in ("meta", "common.enum", "common.ranges", "config", "meta._make_attn_meta")
    }


@pytest.fixture(scope="module")
def pkgs():
    return {"port": _pkg("magiattention_tpu_torch"), "jax": _pkg("magiattention_tpu")}


def _static(p, mask, cp, mesh_shape=None):
    """(dispatch q, dispatch kv, bucket, comm, calc, config) of one package."""
    qr, kr, types = _mask(mask)
    cfg = p["config"].DistAttnConfig(overlap_config=p["config"].OverlapConfig(degree=2))
    ranges = p["common.ranges"].AttnRanges
    mq, mkv, bucket = p["meta"].make_dispatch_meta_from_qk_ranges(
        ranges.from_ranges(qr), ranges.from_ranges(kr),
        [p["common.enum"].AttnMaskType.from_int_type(t) for t in types],
        SEQ, SEQ, CHUNK, cp, cfg.dispatch_config,
    )
    comm, calc = p["meta"].make_attn_meta_from_dispatch_meta(
        bucket, mq, cfg, dispatch_meta_kv=mkv, mesh_shape=mesh_shape,
    )
    return dict(mq=mq, mkv=mkv, bucket=bucket, comm=comm, calc=calc, cfg=cfg,
                slices=(ranges.from_ranges(qr), ranges.from_ranges(kr),
                        [p["common.enum"].AttnMaskType.from_int_type(t) for t in types], SEQ, SEQ))


def _dynamic(p, mask, cp):
    qr, kr, types = _mask(mask)
    ranges = p["common.ranges"].AttnRanges
    tmap = [p["common.enum"].AttnMaskType.from_int_type(t) for t in types]
    q, k = ranges.from_ranges(qr), ranges.from_ranges(kr)
    mq, mkv, _ = p["meta"].make_dispatch_meta_from_qk_ranges(q, k, tmap, SEQ, SEQ, CHUNK, cp)
    cfg = p["config"].DistAttnConfig()
    return p["meta._make_attn_meta"].make_dynamic_attn_plan(q, k, tmap, mq, cfg, dispatch_meta_kv=mkv)


def _verify(which, plan, **overrides):
    mod = p_analysis if which == "port" else j_analysis
    kw = dict(
        dispatch_meta=plan["mq"], bucket=plan["bucket"], comm_meta=plan["comm"],
        calc_meta=plan["calc"], global_slices=plan["slices"],
        dispatch_meta_kv=None if plan["mkv"] is plan["mq"] else plan["mkv"],
        split_alignment=plan["cfg"].grpcoll_config.split_alignment,
    )
    kw.update(overrides)
    return mod.verify_plan(**kw)


def _same_report(port, ref):
    """The two reports agree: rules run, fired rules, (rule, severity)."""
    assert port.rules_run == ref.rules_run
    assert port.fired_rules() == ref.fired_rules()
    multiset = lambda r: collections.Counter((v.rule_id, v.severity) for v in r.violations)  # noqa: E731
    assert multiset(port) == multiset(ref), (port.summary(), ref.summary())


CORPUS = [(m, cp, None) for m in ("causal", "two_docs", "window") for cp in (1, 2, 4)] + [
    ("causal", 4, (2, 2)), ("two_docs", 4, (2, 2)),
]


@pytest.mark.parametrize("mask,cp,mesh_shape", CORPUS)
def test_clean_corpus_reports_equal_jax(pkgs, mask, cp, mesh_shape):
    port = _static(pkgs["port"], mask, cp, mesh_shape)
    ref = _static(pkgs["jax"], mask, cp, mesh_shape)
    for what in ("mq", "comm", "calc"):
        if what == "comm" and mesh_shape is not None:
            continue  # the port's hier plans add per-pair rows (test_torch_hier.py)
        assert_same_fields(port[what], ref[what], f"{mask} cp{cp} {what}")
    rp, rj = _verify("port", port), _verify("jax", ref)
    _same_report(rp, rj)
    assert rp.ok() and set(rp.rules_run) == {"R1", "R2", "R3", "R4"}
    if mesh_shape is not None:  # check_hier_plan ran on every stage
        assert all(s.hier_plan is not None for s in port["comm"].kv_stages)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("mask", ["causal", "two_docs"])
def test_dynamic_reports_equal_jax(pkgs, mask, cp):
    port, ref = _dynamic(pkgs["port"], mask, cp), _dynamic(pkgs["jax"], mask, cp)
    rp = p_analysis.verify_dynamic_plan(port)
    _same_report(rp, j_analysis.verify_dynamic_plan(ref))
    assert rp.ok() and set(rp.rules_run) == {"R1", "R3", "R4"}
    for mutate in (lambda p: setattr(p, "q_buf_len", p.q_buf_len + 8),
                   lambda p: p.merge_idx.__setitem__((0,) * p.merge_idx.ndim, p.dummy_index + 7)):
        a, b = copy.deepcopy(port), copy.deepcopy(ref)
        a.merge_idx, b.merge_idx = np.array(a.merge_idx), np.array(b.merge_idx)
        mutate(a)
        mutate(b)
        got = p_analysis.verify_dynamic_plan(a)
        _same_report(got, j_analysis.verify_dynamic_plan(b))
        assert "R4" in got.fired_rules() and not got.ok()


# ---------------------------------------------------------------------------
# seeded mutations: the same corruption of both packages' plans
# ---------------------------------------------------------------------------


def _inverted_range(plan, rng):
    args = [a for a in plan["calc"].merged_args if a.num_slices]
    arg = args[rng.integers(len(args))]
    i = rng.integers(arg.num_slices)
    arg.k_ranges[i] = (arg.k_ranges[i, 1] + 5, arg.k_ranges[i, 0])
    return dict(comm_meta=None, dispatch_meta=None, bucket=None, global_slices=None)


def _dropped_chunk(plan, rng):
    parts = [p for p in plan["mq"].partitions if p]
    parts[rng.integers(len(parts))].pop()
    return dict(comm_meta=None, calc_meta=None, global_slices=None)


def _duplicated_cast_row(plan, rng):
    pairs = [
        (s, dst, src) for s in plan["comm"].kv_stages
        for dst in range(s.send_counts.shape[0]) for src in range(s.send_counts.shape[0])
        if s.transfer_table[dst][src].total_seqlen
    ]
    s, dst, src = pairs[rng.integers(len(pairs))]
    row = s.transfer_table[dst][src][0]
    s.transfer_table[dst][src].append(type(row)(row.start, row.end))
    return {}


def _stage_misses_work(plan, rng):
    plan["calc"].recv_len_per_stage[rng.integers(len(plan["calc"].recv_len_per_stage))] -= 64
    return dict(dispatch_meta=None, bucket=None, global_slices=None)


MUTATIONS = {
    "inverted_range": (_inverted_range, "R1"),
    "dropped_chunk": (_dropped_chunk, "R2"),
    "duplicated_cast_row": (_duplicated_cast_row, "R3"),
    "stage_misses_remote_work": (_stage_misses_work, "R4"),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mask", ["causal", "two_docs"])
@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutations_fire_the_same_rules(pkgs, name, mask, seed):
    mutate, rule = MUTATIONS[name]
    reports = {}
    for which in ("port", "jax"):
        plan = copy.deepcopy(_static(pkgs[which], mask, 4))
        overrides = mutate(plan, np.random.default_rng(seed))
        reports[which] = _verify(which, plan, **overrides)
    _same_report(reports["port"], reports["jax"])
    assert rule in reports["port"].fired_rules() and not reports["port"].ok()


# ---------------------------------------------------------------------------
# R5, the port's rule
# ---------------------------------------------------------------------------


def _r5(fwd, dq=None, dkv=None, geom=(SEQ, SEQ, 128, 128, 2)):
    return p_analysis.verify_plan(tile_blocks=(fwd, dq, dkv), tile_geom=geom)


def test_r5_default_tile_passes():
    report = _r5((64, 64))
    assert report.rules_run == ["R5"] and report.ok() and not report.violations


def test_r5_uncompiled_block_fails_in_both():
    # (32, 64): the port compiles no 32-row tile; JAX's R5 flags it too,
    # for another reason: its block_k 64 is not a multiple of the TPU's
    # 128-lane width
    report = _r5((32, 64))
    assert report.fired_rules() == {"R5"} and not report.ok()
    assert any("no compiled fwd instance" in v.detail for v in report.errors())
    ref = j_analysis.verify_plan(tile_blocks=((32, 64), None, None), tile_geom=(SEQ, SEQ, 128, 128, 2))
    assert ref.fired_rules() == {"R5"} and not ref.ok()


def test_r5_non_dividing_override_fails():
    # the forward pads 448 rows to 7 tiles of 64; a 128-row dk/dv tile
    # does not divide 448
    report = _r5((64, 64), dkv=(128, 64), geom=(448, 448, 128, 128, 2))
    assert report.fired_rules() == {"R5"}
    assert [v.site for v in report.errors()] == ["dkv blocks"]
    assert "divide" in report.errors()[0].detail


def test_r5_tile_over_shared_memory_fails():
    # a 128 x 128 forward at d 256 in bf16 takes more than 232,448 bytes
    assert mem_budget.fwd_smem_bytes(256, 128, 128, 2) > mem_budget.SMEM_PER_CTA
    report = _r5((128, 128), dq=(64, 64), dkv=(64, 64), geom=(SEQ, SEQ, 256, 256, 2))
    assert [v.site for v in report.errors()] == ["fwd blocks"]
    assert "shared memory" in report.errors()[0].detail


def test_jax_r5_would_reject_the_port_default():
    """Why R5 is the port's own: JAX's lane quanta reject 64 x 64."""
    report = j_analysis.verify_plan(tile_blocks=((64, 64), None, None), tile_geom=(SEQ, SEQ, 128, 128, 2))
    assert report.fired_rules() == {"R5"}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_r5_accepts_every_compiled_instance(monkeypatch, kernel, itemsize, d):
    """Every instance ``utils/mem_budget.py`` compiles passes R5; with the
    limit one byte below its CTA's shared memory it fails there, and at
    exactly that memory it passes."""
    pairs = mem_budget.compiled_tiles(kernel, itemsize, d)
    assert (64, 64) in pairs
    geom = (1024, 1024, d, d, itemsize)
    for pair in pairs:
        blocks = {"fwd": (64, 64), "dq": (64, 64), "dkv": (64, 64), kernel: pair}
        report = _r5(blocks["fwd"], blocks["dq"], blocks["dkv"], geom)
        assert report.ok() and not report.violations, report.summary()
        # the least the CTA can take (the float32 forward drops to one
        # stage of split tiles where two do not fit)
        monkeypatch.setattr(mem_budget, "SMEM_PER_CTA", 0)
        smem = mem_budget.ffa_smem_bytes(kernel, d, *pair, itemsize)
        monkeypatch.setattr(mem_budget, "SMEM_PER_CTA", smem - 1)
        report = _r5(blocks["fwd"], blocks["dq"], blocks["dkv"], geom)
        over = [v for v in report.errors() if v.site == f"{kernel} blocks"]
        assert over and "shared memory" in over[0].detail, report.summary()
        monkeypatch.setattr(mem_budget, "SMEM_PER_CTA", smem)
        report = _r5(blocks["fwd"], blocks["dq"], blocks["dkv"], geom)
        assert not [v for v in report.errors() if v.site == f"{kernel} blocks"], report.summary()
        monkeypatch.undo()


def test_plan_extents_hold_on_port_plans(pkgs):
    """R5's extent half over the port's FFA plans of the corpus."""
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    plan = _static(pkgs["port"], "two_docs", 2)
    for arg in plan["calc"].merged_args:
        ffa = get_ffa_plan(arg.q_ranges, arg.k_ranges, arg.d_lo, arg.d_hi,
                           arg.total_seqlen_q, arg.total_seqlen_k, 64, 64)
        report = p_analysis.VerifyReport()
        p_verifier.check_plan_extents(report, ffa)
        assert report.rules_run == ["R5"] and report.ok()
        bad = copy.deepcopy(ffa)
        meta = np.array(bad.meta)
        meta[0, 10] += 1  # one stale extent column
        object.__setattr__(bad, "meta", meta)
        report = p_analysis.VerifyReport()
        p_verifier.check_plan_extents(report, bad)
        assert not report.ok()


# ---------------------------------------------------------------------------
# the manager's hook
# ---------------------------------------------------------------------------

HOOK_S, HOOK_CHUNK = 256, 16


def _port_mgr():
    from magiattention_tpu_torch.api import init_dist_attn_runtime_mgr

    return init_dist_attn_runtime_mgr(
        [[0, HOOK_S]], [[0, HOOK_S]], ["causal"], HOOK_S, HOOK_S, HOOK_CHUNK, device="cpu",
    )


@pytest.fixture
def _fresh_mgrs(monkeypatch):
    from magiattention_tpu_torch import telemetry
    from magiattention_tpu_torch.api.magi_attn_interface import clear_cache
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _PLAN_CACHE

    for var in ("MAGI_ATTENTION_VERIFY_PLANS", "MAGI_ATTENTION_TELEMETRY", "MAGI_ATTENTION_QO_COMM"):
        monkeypatch.delenv(var, raising=False)
    clear_cache()
    _PLAN_CACHE.clear()
    telemetry.reset()
    yield
    clear_cache()
    _PLAN_CACHE.clear()
    telemetry.reset()


def test_verify_plans_getter(monkeypatch):
    from magiattention_tpu_torch.env import general

    monkeypatch.delenv("MAGI_ATTENTION_VERIFY_PLANS", raising=False)
    assert general.is_verify_plans_enable() is False
    monkeypatch.setenv("MAGI_ATTENTION_VERIFY_PLANS", "1")
    assert general.is_verify_plans_enable() is True
    assert "MAGI_ATTENTION_VERIFY_PLANS" not in general.ENV_KEYS_AFFECTING_RUNTIME


def test_hook_noop_when_off(_fresh_mgrs):
    assert p_analysis.maybe_verify_runtime(_port_mgr()) is None


@pytest.mark.parametrize("qo_comm", [False, True])
def test_hook_clean_build_matches_jax(_fresh_mgrs, monkeypatch, qo_comm):
    """A fresh build verifies clean under the hook (static and dynamic
    branches); its report is the JAX manager's for the same mask."""
    import jax

    from magiattention_tpu.api import init_dist_attn_runtime_mgr as j_mgr

    monkeypatch.setenv("MAGI_ATTENTION_VERIFY_PLANS", "1")
    if qo_comm:
        monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    mgr = _port_mgr()
    assert (mgr.dynamic_plan is not None) == qo_comm
    report = p_analysis.maybe_verify_runtime(mgr)
    assert report.ok()
    mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:1]), ("cp",))
    ref = j_verifier.verify_runtime_mgr(j_mgr(
        [[0, HOOK_S]], [[0, HOOK_S]], ["causal"], HOOK_S, HOOK_S, HOOK_CHUNK, mesh=mesh,
    ))
    if qo_comm:
        _same_report(report, ref)
    else:  # R1-R4 alike; JAX's R5 flags the port's 64 x 64 (lane quanta)
        assert report.rules_run == ref.rules_run == ["R1", "R2", "R3", "R4", "R5"]
        assert ref.fired_rules() <= {"R5"} and not report.violations


def test_hook_raises_on_corrupted_manager(_fresh_mgrs, monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_VERIFY_PLANS", "1")
    mgr = _port_mgr()
    arg = next(a for a in mgr.calc_meta.host_args if a.num_slices)
    arg.q_ranges[0, 0] = -5
    try:
        with pytest.raises(p_analysis.PlanVerificationError, match="R1"):
            p_analysis.maybe_verify_runtime(mgr)
    finally:
        arg.q_ranges[0, 0] = 0  # the plan is the plan cache's too


def test_hook_raises_at_build(_fresh_mgrs, monkeypatch):
    """The manager runs the hook itself after a fresh build."""
    from magiattention_tpu_torch import dist_attn_runtime_mgr as mgr_mod

    monkeypatch.setenv("MAGI_ATTENTION_VERIFY_PLANS", "1")
    real = mgr_mod.make_attn_meta_from_dispatch_meta

    def corrupt(*a, **kw):
        comm, calc = real(*a, **kw)
        next(x for x in calc.host_args if x.num_slices).q_ranges[0, 0] = -5
        return comm, calc

    monkeypatch.setattr(mgr_mod, "make_attn_meta_from_dispatch_meta", corrupt)
    with pytest.raises(p_analysis.PlanVerificationError, match="R1"):
        _port_mgr()


def test_plan_verify_record(_fresh_mgrs, monkeypatch, tmp_path):
    from magiattention_tpu_torch import telemetry

    monkeypatch.setenv("MAGI_ATTENTION_VERIFY_PLANS", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY", "1")
    monkeypatch.setenv("MAGI_ATTENTION_TELEMETRY_DIR", str(tmp_path))
    _port_mgr()
    telemetry.flush()
    telemetry.reset()
    records = []
    for path in glob.glob(str(tmp_path / "*.jsonl")):
        with open(path) as f:
            records += [json.loads(line) for line in f if line.strip()]
    pv = [r for r in records if r.get("kind") == "plan_verify"]
    assert pv and pv[-1]["errors"] == 0 and pv[-1]["planner"] == "static"
    assert set(pv[-1]["rules_run"]) == {"R1", "R2", "R3", "R4", "R5"} and pv[-1]["wall_ms"] >= 0


def test_violation_registry():
    """The registry and report surface are JAX's, R5's text the port's."""
    assert set(p_analysis.RULES) == {"R1", "R2", "R3", "R4", "R5"}
    for rule in ("R1", "R2", "R3", "R4"):
        assert p_analysis.RULES[rule] == j_analysis.RULES[rule]
    assert p_analysis.RULE_COVERAGE == j_analysis.RULE_COVERAGE
    report = p_analysis.VerifyReport()
    report.add("R1", "error", "here", "bad")
    with pytest.raises(p_analysis.PlanVerificationError, match=r"\[R1:error\] here: bad"):
        report.raise_if_errors()
