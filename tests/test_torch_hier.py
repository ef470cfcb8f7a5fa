"""The port's two-level (hierarchical) GroupCast against the JAX package's.

- The plan (``comm/hier.py:make_hier_group_cast_plan``) field-equal to
  JAX's on the JAX package's ``tests/test_comm/test_hier_group_cast.py``
  cases: seeds x multicast, a single node, one rank a node, a ragged
  all-to-one pattern and the DCN dedup, with JAX's row-count checks; and
  the port's executor (``HierCastPlan``, one view per rank) simulated in
  numpy, bit for bit equal to the flat cast, its reverse to the flat
  GroupReduce.
- The solver's plans (``make_attn_meta_from_dispatch_meta(...,
  mesh_shape=...)``) at (2, 2), (2, 4) and (4, 2) on
  ``tests/test_solver/test_two_level_plans.py``'s masks: every stage's
  ``hier_plan`` field-equal to JAX's, ``dcn_rows`` equal (the branch
  imported a module the port lacked before).
- Over gloo at world 4 (one process per rank, a file-store
  ``init_method``) on a (dcn 2, ici 2) mesh: the API over
  ``magi_attn_flex_key(mesh=..., cp_axis=("dcn", "ici"))`` with
  MAGI_ATTENTION_HIERARCHICAL_COMM=1 against JAX's on a (2, 2) CPU mesh
  (its ``sdpa`` backend) on ``test_hier_pipeline.py``'s masks, out, lse
  and gradients within float32 1e-5; out bitwise equal to the port's flat
  cast; each stage's two-phase cast bitwise equal to the flat one and its
  backward within float32 1e-6 of the flat GroupReduce, with the
  high-precision reduce on bf16 rows (bf16 forward wire, float32
  backward wire); qo-comm with the flag refused with JAX's message; the
  plan cache never mixing flat and two-level plans.
"""

import dataclasses
import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu.comm import hier as jax_hier
from magiattention_tpu.common.range import AttnRange as JaxRange
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu_torch.common.range import AttnRange
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import (
    HIER_CHUNK,
    HIER_MASKS,
    HIER_SEQ,
    hier_inputs,
    hier_worker,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
N_OUTER, N_INNER = 2, 4
CP = N_OUTER * N_INNER
SHARD, ALIGN, R_MAX = 32, 8, 512
PORT_ONLY = ("a_pair_rows", "b_pair_rows")


# ---------------------------------------------------------------------------
# the plan and its executor, on the host
# ---------------------------------------------------------------------------


def _random_requests(seed, multicast=True):
    """JAX's test_hier_group_cast.py requests as (dst, src) lists of
    (start, end): multicast repeats one src's rows to every rank."""
    rng = np.random.default_rng(seed)
    reqs = [[[] for _ in range(CP)] for _ in range(CP)]
    for dst in range(CP):
        for src in range(CP):
            if src == dst:
                continue
            if multicast and src % 2 == 0:
                s0 = src * SHARD + 4
                reqs[dst][src].append((s0, s0 + 12))
            elif rng.random() < 0.5:
                a = int(rng.integers(0, SHARD - 8))
                ln = int(rng.integers(1, 8))
                reqs[dst][src].append((src * SHARD + a, src * SHARD + a + ln))
    return reqs


def _ragged_requests():
    reqs = [[[] for _ in range(CP)] for _ in range(CP)]
    for dst in range(1, CP):
        reqs[dst][0] = [(4, 24), (24, 24 + dst % 3)]
    return reqs


def _ranges(cls_ranges, cls_range, pairs):
    return cls_ranges([cls_range(a, b) for a, b in pairs]).merge()


def _plans(reqs, n_outer, n_inner):
    """(the port's plan, JAX's plan) of the same requests, and the port's
    request and host ranges."""
    from magiattention_tpu_torch.comm import hier

    out = []
    for rr, r in ((AttnRanges, AttnRange), (JaxRanges, JaxRange)):
        req = [[_ranges(rr, r, reqs[d][s]) for s in range(CP)] for d in range(CP)]
        host = [rr([r(i * SHARD, (i + 1) * SHARD)]) for i in range(CP)]
        mod = hier if rr is AttnRanges else jax_hier
        out.append((mod.make_hier_group_cast_plan(req, host, n_outer, n_inner, ALIGN, R_MAX), req, host))
    return out


def _assert_plan_equal(port, ref, msg=""):
    """Every field of JAX's plan equal in the port's (which adds the
    per-pair row counts)."""
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{msg}{f.name}")
        else:
            assert a == b, f"{msg}{f.name}: {a!r} != {b!r}"
    assert {f.name for f in dataclasses.fields(port)} - {f.name for f in dataclasses.fields(ref)} == set(PORT_ONLY)


def _a2a(chunks, line):
    """The all_to_all of a line (global ranks in group order): member j
    receives every member's chunk j, in member order."""
    return {r: [chunks[s][j] for s in line] for j, r in enumerate(line)}


def _split(x, splits):
    return np.split(x, np.cumsum(splits)[:-1])


def _simulate(plan, xs, ys):
    """The port's executor over every rank's view, in numpy: (final
    buffers, the reverse's sums into each shard)."""
    from magiattention_tpu_torch.comm.hier import HierCastPlan

    n_outer, n_inner = plan.n_outer, plan.n_inner
    views = [HierCastPlan.from_plan(plan, r) for r in range(CP)]
    outer = [[o * n_inner + i for o in range(n_outer)] for i in range(n_inner)]
    inner = [[o * n_inner + i for i in range(n_inner)] for o in range(n_outer)]
    got_a = {}
    for line in outer:
        got_a.update(_a2a({r: _split(xs[r][views[r].a_send_rows], views[r].a_send_splits) for r in line}, line))
    held = {r: np.concatenate([xs[r], *got_a[r]]) for r in range(CP)}
    got_b = {}
    for line in inner:
        got_b.update(_a2a({r: _split(held[r][views[r].b_send_rows], views[r].b_send_splits) for r in line}, line))
    bufs = []
    for r in range(CP):
        v = views[r]
        assert [len(c) for c in got_a[r]] == list(v.a_recv_splits)
        assert [len(c) for c in got_b[r]] == list(v.b_recv_splits)
        buf = np.zeros((v.buf_len, xs[r].shape[1]))
        buf[: v.recv_len] = np.concatenate(got_b[r])[v.b_order]
        bufs.append(buf)
    # the reverse: phase B back, then phase A back
    back_b = {}
    for line in inner:
        chunks = {}
        for r in line:
            arrived = np.zeros((views[r].recv_len, ys[r].shape[1]))
            arrived[views[r].b_order] = ys[r][: views[r].recv_len]
            chunks[r] = _split(arrived, views[r].b_recv_splits)
        back_b.update(_a2a(chunks, line))
    held_g = {}
    for r in range(CP):
        g = np.zeros((SHARD + views[r].recv_a_len, ys[r].shape[1]))
        np.add.at(g, views[r].b_send_rows, np.concatenate(back_b[r]))
        held_g[r] = g
    back_a = {}
    for line in outer:
        back_a.update(_a2a({r: _split(held_g[r][SHARD:], views[r].a_recv_splits) for r in line}, line))
    sums = []
    for r in range(CP):
        total = held_g[r][:SHARD].copy()
        np.add.at(total, views[r].a_send_rows, np.concatenate(back_a[r]))
        sums.append(total)
    return bufs, sums


def _check_executor(plan, req, host):
    """The simulated executor against the flat cast of the same requests
    (``_make_cast_arg``): buffers equal, the reverse equal to the flat
    GroupReduce's sums."""
    from magiattention_tpu_torch.meta.solver.dynamic_attn_solver import _make_cast_arg

    flat = _make_cast_arg(req, host, CP, ALIGN, r_max=R_MAX)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((SHARD, 3)) for _ in range(CP)]
    ys = [rng.standard_normal((R_MAX, 3)) for _ in range(CP)]
    bufs, sums = _simulate(plan, xs, ys)
    c = flat.send_counts
    for d in range(CP):
        want = np.zeros((R_MAX, 3))
        cat = np.concatenate([xs[s][flat.send_idx[s, d, : c[s, d]]] for s in range(CP)])
        want[: len(cat)] = cat
        np.testing.assert_array_equal(bufs[d], want, err_msg=f"rank {d}")
    for s in range(CP):
        want = np.zeros((SHARD, 3))
        for d in range(CP):
            off = int(c[:s, d].sum())
            np.add.at(want, flat.send_idx[s, d, : c[s, d]], ys[d][off: off + c[s, d]])
        np.testing.assert_allclose(sums[s], want, rtol=1e-12, atol=1e-12, err_msg=f"rank {s}")


@pytest.mark.parametrize("multicast", [True, False])
@pytest.mark.parametrize("seed", [0, pytest.param(1, marks=pytest.mark.slow)])
def test_plan_matches_jax(seed, multicast):
    (port, req, host), (ref, *_) = _plans(_random_requests(seed, multicast), N_OUTER, N_INNER)
    _assert_plan_equal(port, ref)
    _check_executor(port, req, host)


def test_single_node_no_dcn():
    """n_outer 1: no row crosses the outer axis."""
    (port, req, host), (ref, *_) = _plans(_random_requests(3, True), 1, CP)
    _assert_plan_equal(port, ref)
    assert port.dcn_rows() == 0 and int(port.a_pair_rows.sum()) == 0
    _check_executor(port, req, host)


def test_single_rank_inner():
    """n_inner 1: every cross-rank row crosses the outer axis once."""
    reqs = _random_requests(4, multicast=False)
    (port, req, host), (ref, *_) = _plans(reqs, CP, 1)
    _assert_plan_equal(port, ref)
    assert port.dcn_rows() == sum(req[d][s].total_seqlen for d in range(CP) for s in range(CP) if d != s)
    _check_executor(port, req, host)


def test_ragged_all_to_one():
    """Every rank wants rank 0's shared rows (plus a ragged tail): they
    cross the outer axis once per remote node."""
    (port, req, host), (ref, *_) = _plans(_ragged_requests(), N_OUTER, N_INNER)
    _assert_plan_equal(port, ref)
    expect = sum(
        AttnRanges([g for d in range(CP) if d // N_INNER == o for g in req[d][0]]).merge().total_seqlen
        for o in range(1, N_OUTER)
    )
    assert port.dcn_rows() == expect
    _check_executor(port, req, host)


def test_dcn_dedup():
    (port, req, host), (ref, *_) = _plans(_random_requests(0, True), N_OUTER, N_INNER)
    _assert_plan_equal(port, ref)
    flat_dcn = sum(req[d][s].total_seqlen for d in range(CP) for s in range(CP)
                   if d // N_INNER != s // N_INNER)
    assert port.dcn_rows() < flat_dcn
    assert port.dcn_rows() == sum(
        AttnRanges([g for d in range(CP) if d // N_INNER == o for g in req[d][s]]).merge().total_seqlen
        for o in range(N_OUTER) for s in range(CP) if s // N_INNER != o
    )


# ---------------------------------------------------------------------------
# the solver's two-level plans (the repaired import)
# ---------------------------------------------------------------------------

SOLVER_SEQ, SOLVER_CHUNK = 2048, 128
SOLVER_MASKS = {
    "causal": ([[0, SOLVER_SEQ]], [[0, SOLVER_SEQ]], [1]),
    "shared_prefix": ([[0, SOLVER_SEQ], [256, SOLVER_SEQ]], [[0, 256], [256, SOLVER_SEQ]], [0, 1]),
}


def _solve(pkg, mask, mesh_shape):
    import importlib

    meta = importlib.import_module(f"{pkg}.meta")
    enum = importlib.import_module(f"{pkg}.common.enum")
    ranges = importlib.import_module(f"{pkg}.common.ranges")
    config = importlib.import_module(f"{pkg}.config")
    qr, kr, types = SOLVER_MASKS[mask]
    cfg = config.DistAttnConfig(overlap_config=config.OverlapConfig(degree=2))
    mq, mkv, bucket = meta.make_dispatch_meta_from_qk_ranges(
        ranges.AttnRanges.from_ranges(qr), ranges.AttnRanges.from_ranges(kr),
        [enum.AttnMaskType.from_int_type(t) for t in types], SOLVER_SEQ, SOLVER_SEQ,
        SOLVER_CHUNK, mesh_shape[0] * mesh_shape[1], cfg.dispatch_config,
    )
    comm, _ = meta.make_attn_meta_from_dispatch_meta(
        bucket, mq, cfg, dispatch_meta_kv=mkv, mesh_shape=mesh_shape
    )
    return comm


@pytest.mark.parametrize("mask", sorted(SOLVER_MASKS))
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2)])
def test_solver_hier_plans_match_jax(mesh_shape, mask):
    """The planner's two-level branch (C6: before ``comm/hier.py`` it
    raised ``ModuleNotFoundError``) against JAX's."""
    port = _solve("magiattention_tpu_torch", mask, mesh_shape)
    ref = _solve("magiattention_tpu", mask, mesh_shape)
    assert len(port.kv_stages) == len(ref.kv_stages) > 0
    for st, (a, b) in enumerate(zip(port.kv_stages, ref.kv_stages)):
        assert a.hier_plan is not None
        _assert_plan_equal(a.hier_plan, b.hier_plan, f"stage {st} ")
        assert a.telemetry_dict()["dcn_rows"] == b.telemetry_dict()["dcn_rows"]


# ---------------------------------------------------------------------------
# over gloo at world 4: the (dcn 2, ici 2) mesh
# ---------------------------------------------------------------------------

FAST_MASKS = ("causal",)
SLOW_MASKS = ("shared_prefix",)


@lru_cache(maxsize=None)
def _port_run(masks: tuple) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_hier_")
    mp.start_processes(
        hier_worker, args=(4, os.path.join(out_dir, "init"), out_dir, list(masks)), nprocs=4,
        start_method="spawn", join=True,
    )
    return out_dir


def _port(mask: str, rank: int):
    masks = FAST_MASKS if mask in FAST_MASKS else SLOW_MASKS
    return np.load(os.path.join(_port_run(masks), f"{mask}_{rank}.npz"))


@lru_cache(maxsize=None)
def _jax_run(mask: str):
    """JAX's two-level run on a (dcn 2, ici 2) CPU mesh (``sdpa``
    backend): out, lse (dispatched layout), dq, dk, dv."""
    qr, kr, tm = HIER_MASKS[mask]
    env = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa", "MAGI_ATTENTION_HIERARCHICAL_COMM": "1"}
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in env.items():
            mpatch.setenv(k, v)
        mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("dcn", "ici"))
        key = jax_api.magi_attn_flex_key(qr, kr, tm, HIER_SEQ, HIER_SEQ, mesh=mesh,
                                         cp_axis=("dcn", "ici"), chunk_size=HIER_CHUNK)
        q, k, v, do = hier_inputs()

        def loss(q, k, v):
            out_d, meta = jax_api.calc_attn(
                jax_api.dispatch(q, key), jax_api.dispatch(k, key, role="kv"),
                jax_api.dispatch(v, key, role="kv"), key,
            )
            out = jax_api.undispatch(out_d, key)
            return jnp.sum(out * do), (out, meta.lse)

        grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (out, lse)), grads = grad_fn(*(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out), np.asarray(lse), *(np.asarray(g) for g in grads)]


MASK_PARAMS = [*FAST_MASKS, *(pytest.param(m, marks=pytest.mark.slow) for m in SLOW_MASKS)]
NAMES = ("out", "lse", "dq", "dk", "dv")


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_hier_pipeline_matches_jax(mask):
    """Two-level comm through the API at (2, 2) against JAX's, forward and
    gradients; the runtime ran the two-level cast."""
    want = _jax_run(mask)
    shard = want[1].shape[0] // 4
    for r in range(4):
        got = _port(mask, r)
        assert bool(got["hier_runtime"]) and not bool(got["flat_runtime"])
        for n, w in zip(NAMES, want):
            if n == "lse":
                w = w[r * shard:(r + 1) * shard]
            assert_close(got[f"hier_{n}"], w, msg=f"{mask} rank {r} {n}", **TOL)
            assert_close(got[f"hier_hp_{n}"], w, msg=f"{mask} rank {r} hp {n}", **TOL)


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_hier_out_bitwise_equals_flat(mask):
    """Out and lse under the two-level cast equal the flat cast's to the
    bit; gradients within float32 1e-5 (the reverse sums in another
    order); fewer rows cross the outer axis than the flat cast sends
    across it."""
    for r in range(4):
        got = _port(mask, r)
        for n in ("out", "lse"):
            np.testing.assert_array_equal(got[f"hier_{n}"], got[f"flat_{n}"], err_msg=f"rank {r} {n}")
        for n in ("dq", "dk", "dv"):
            assert_close(got[f"hier_{n}"], got[f"flat_{n}"], msg=f"rank {r} {n}", **TOL)
        assert np.all(got["dcn_rows"] <= got["flat_dcn_rows"]) and got["dcn_rows"].sum() > 0


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_hier_cast_matches_flat(mask):
    """Each stage's two-phase cast alone: buffers bitwise equal to the flat
    cast's, the backward within float32 1e-6 of the flat GroupReduce; under
    the high-precision reduce on bf16 rows, both forwards send bf16, both
    backwards float32, and the float32 buffers are the bf16 ones upcast.
    Each plan lists the exchanges its cast issues (``exchanges``, what a
    failed rank's completion issues: two phases two-level, one flat), with
    rows matching the splits."""
    got = [_port(mask, r) for r in range(4)]
    stages = sorted({k.split("_")[1] for k in got[0].files if k.startswith("buf_f")})
    assert stages
    for r, g in enumerate(got):
        for st in stages:
            st = st[1:]
            for tag in ("f32", "hp"):
                np.testing.assert_array_equal(g[f"buf_h{st}_{tag}"], g[f"buf_f{st}_{tag}"])
                tol = 1e-6 if tag == "f32" else 1e-2
                assert_close(g[f"grad_h{st}_{tag}"], g[f"grad_f{st}_{tag}"], atol=tol, rtol=tol,
                             norm_rtol=tol, msg=f"rank {r} stage {st} {tag}")
            for name in ("f", "h"):
                assert set(g[f"fwd_wire_{name}{st}_hp"]) == {"torch.bfloat16"}
                assert set(g[f"bwd_wire_{name}{st}_hp"]) == {"torch.float32"}
                assert set(g[f"fwd_wire_{name}{st}_f32"]) == {"torch.float32"}
            assert len(g[f"fwd_wire_h{st}_hp"]) == 2  # phase A, phase B
            for name in ("f", "h"):
                for tag in ("f32", "hp"):
                    listed = g[f"listed_{name}{st}_{tag}"]
                    assert len(listed) == int(g[f"issued_{name}{st}_{tag}"]) == (2 if name == "h" else 1)
                    assert np.array_equal(listed[:, 0], listed[:, 2])
                    assert np.array_equal(listed[:, 1], listed[:, 3])


def test_plan_cache_never_mixes_flat_and_two_level():
    """Under the flag, a two-level key and a flat key over the same cp
    group and mask solve separately; the two-level key's plan is reused by
    its own signature only."""
    for r in range(4):
        got = np.load(os.path.join(_port_run(FAST_MASKS), f"cache_{r}.npz"))
        assert list(got["sources"]) == ["memory", "cold", "memory"]
        assert list(got["hier_plans"]) == [True, False, True]
        assert list(got["runtimes"]) == [True, False, True]
        assert bool(got["same_metas"])


def test_qo_comm_with_two_level_raises_jax_message():
    want = "MAGI_ATTENTION_QO_COMM=1 does not support MAGI_ATTENTION_HIERARCHICAL_COMM=1 yet; unset one"
    for r in range(4):
        got = np.load(os.path.join(_port_run(FAST_MASKS), f"cache_{r}.npz"))
        assert str(got["qo_refusal"]) == want


def test_mesh_key_forms_on_one_rank(monkeypatch):
    """A key takes ``cp_group`` or ``mesh``, not both; a one-rank mesh with
    a pair ``cp_axis`` under the flag plans a cp 1 two-level key (no
    group, no stage), and its signature carries the mesh shape."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _plan_signature
    from magiattention_tpu_torch.parallel import ProcessMesh

    mesh = ProcessMesh(np.zeros((1, 1), np.int64), ("dcn", "ici"))
    qr, kr, tm = HIER_MASKS["causal"]
    with pytest.raises(ValueError, match="cp_group or mesh"):
        api.magi_attn_flex_key(qr, kr, tm, HIER_SEQ, HIER_SEQ, device="cpu", mesh=mesh,
                               cp_axis=("dcn", "ici"), cp_group=object())
    monkeypatch.setenv("MAGI_ATTENTION_HIERARCHICAL_COMM", "1")
    key = api.magi_attn_flex_key(qr, kr, tm, HIER_SEQ, HIER_SEQ, device="cpu", mesh=mesh,
                                 cp_axis=["dcn", "ici"], chunk_size=HIER_CHUNK)
    assert key.cp_axis == ("dcn", "ici") and key.cp_size == 1 and key.cp_group is None
    assert _plan_signature(key)[-1] == ("mesh_shape", (1, 1))
    assert not _mgr(key).comm_meta.kv_stages
