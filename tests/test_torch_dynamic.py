"""The port's dynamic (qo-comm) planner and runtime against the JAX
package's.

Plans, host only: for the JAX package's own solver masks
(``tests/test_solver/test_dynamic_attn_solver.py``: causal, varlen full and
a shared prefix over 128 tokens, chunks of 16) at cp 2 and 4, the port's
``make_dynamic_attn_plan`` equals the JAX package's field by field (the
three casts, every rank's band slices, the merge index, the lengths and
the solver state) for every algorithm. ``BINARY_GREEDY_PARALLEL`` solves
in the port's native host backend, whose stable tile order places tiles as
its numpy path does; the JAX package's native solver orders equal-area
tiles otherwise (``std::sort``), so the port is held against the JAX
package's numpy path (``_solve_numpy``). Two successive masks of one
family go through the incremental re-solve in both packages.

The pipeline over gloo: for cp 2 and 4, one process per rank (spawned, a
file-store ``init_method``) runs ``magi_attn_flex_key -> dispatch ->
calc_attn -> undispatch`` and the backward of ``sum(out * dO)`` under
MAGI_ATTENTION_QO_COMM=1 on the CPU (the kernels' plain versions), for
causal, varlen causal and shared-prefix masks over 512 tokens, one case
under each high-precision reduce flag, at cp 2 the ``sdpa`` backend and
at cp 2 and 4 the ``sdpa_online`` backend (at cp 1 too, without a spawn).
The JAX package runs the same mask and flags on a cp-device CPU mesh with
its ``sdpa`` backend (``sdpa_online`` for that case), jitted. Held at float32 atol/rtol/rel-norm 1e-5: the
natural-order out, dq, dk and dv, every rank's lse rows and max-logits;
the plans' communicated rows must be equal.

Also the merge of partial rows, the row-range ops, the paths that raise,
and a mask with rows no slice covers at cp 1, both passes.
"""

import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu import meta as jax_meta
from magiattention_tpu.common.enum import AttnMaskType as JaxMaskType
from magiattention_tpu.common.enum import DynamicAttnAlgType as JaxAlg
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.config import DistAttnConfig as JaxConfig
from magiattention_tpu.config import DynamicAttnConfig as JaxDynConfig
from magiattention_tpu.meta._make_attn_meta import make_dynamic_attn_plan as jax_dynamic_plan
from magiattention_tpu_torch import api
from magiattention_tpu_torch import meta as port_meta
from magiattention_tpu_torch.common.enum import AttnMaskType, DynamicAttnAlgType
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.config import DistAttnConfig, DynamicAttnConfig
from magiattention_tpu_torch.meta._make_attn_meta import make_dynamic_attn_plan
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import (
    CP_CHUNK,
    CP_SEQ,
    assert_same_fields,
    cp_inputs,
    dyn_worker,
    warm_jax_native,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
QO = {"MAGI_ATTENTION_QO_COMM": "1"}


@pytest.fixture(scope="module", autouse=True)
def _warm_jax_native():
    """The JAX planners need the JAX package's native library; recover it
    where another process won the race to build it."""
    warm_jax_native()


# ---------------------------------------------------------------------------
# plans, host only
# ---------------------------------------------------------------------------

S, CHUNK = 128, 16
PLAN_MASKS = {
    "causal": ([[0, S]], [[0, S]], [1]),
    "varlen_full": ([[0, 48], [48, S]], [[0, 48], [48, S]], [0, 0]),
    "shared_prefix": ([[0, 64], [64, S], [64, S]], [[0, 64], [0, 64], [64, S]], [1, 0, 1]),
}
WHOLE_PLAN_ALGS = list(DynamicAttnAlgType)

PORT = (AttnRanges, AttnMaskType, DistAttnConfig, DynamicAttnConfig, DynamicAttnAlgType,
        port_meta, make_dynamic_attn_plan)
JAX = (JaxRanges, JaxMaskType, JaxConfig, JaxDynConfig, JaxAlg, jax_meta, jax_dynamic_plan)


def _plan(pkg, mask, cp, alg=DynamicAttnAlgType.BINARY_GREEDY, prev_state=None):
    """One package's dynamic plan of ``mask`` (q ranges, k ranges, types)."""
    ranges, mtype, config, dyn_config, algs, meta, make_plan = pkg
    qr, kr, types = mask
    q, k = ranges.from_ranges(qr), ranges.from_ranges(kr)
    tmap = [mtype.from_int_type(t) for t in types]
    mq, mkv, _ = meta.make_dispatch_meta_from_qk_ranges(q, k, tmap, S, S, CHUNK, cp)
    cfg = config(dynamic_config=dyn_config(alg=algs(alg.value)))
    return make_plan(q, k, tmap, mq, cfg, dispatch_meta_kv=mkv, prev_state=prev_state)


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("alg", WHOLE_PLAN_ALGS, ids=lambda a: a.value)
@pytest.mark.parametrize("name", sorted(PLAN_MASKS))
def test_dynamic_plans_equal_jax(name, alg, cp, monkeypatch):
    from magiattention_tpu.meta.solver import algorithms as jax_algs

    # the JAX package's numpy path (its native one orders tied tiles otherwise)
    monkeypatch.setattr(jax_algs.BinaryGreedyParallelAlg, "_solve_native", lambda *a: None)
    port = _plan(PORT, PLAN_MASKS[name], cp, alg)
    ref = _plan(JAX, PLAN_MASKS[name], cp, alg)
    assert_same_fields(port, ref, f"{name} {alg.value} cp{cp}")
    assert port.comm_rows() == ref.comm_rows()
    assert port.cp_size == cp and port.dummy_index == ref.dummy_index


def _tiles_and_ctx(algs_mod, ranges, mtype, rect_mod, meta, mask, cp):
    qr, kr, types = mask
    q, k = ranges.from_ranges(qr), ranges.from_ranges(kr)
    tmap = [mtype.from_int_type(t) for t in types]
    mq, mkv, _ = meta.make_dispatch_meta_from_qk_ranges(q, k, tmap, S, S, CHUNK, cp)
    ctx = algs_mod.DynSolveContext(
        host_ranges_q=[r.merge() for r in mq.host_ranges_per_rank],
        host_ranges_k=[r.merge() for r in mkv.host_ranges_per_rank],
        cp_size=cp,
    )
    rects = rect_mod.AttnRectangles.from_ranges(q, k, tmap)
    return rects, ctx


def _bucket_rows(buckets) -> list[list[tuple]]:
    return [
        [(r.q_range.start, r.q_range.end, r.k_range.start, r.k_range.end, r.d_lo, r.d_hi)
         for r in b]
        for b in buckets
    ]


@pytest.mark.parametrize("cp", [2, 4])
@pytest.mark.parametrize("name", sorted(PLAN_MASKS))
def test_binary_greedy_parallel_matches_jax_numpy_path(name, cp):
    """The port's BinaryGreedyParallel (its native solve) assigns every
    tile as its own numpy path and the JAX package's numpy path do on the
    same tiles."""
    from magiattention_tpu.common import rectangle as jax_rect
    from magiattention_tpu.meta.solver import algorithms as jax_algs
    from magiattention_tpu_torch.common import rectangle as port_rect
    from magiattention_tpu_torch.csrc_backend import ops as host_ops
    from magiattention_tpu_torch.meta.solver import algorithms as port_algs
    from magiattention_tpu_torch.meta.solver.algorithms.base import cut_to_tiles

    mask = PLAN_MASKS[name]
    rects, ctx = _tiles_and_ctx(port_algs, AttnRanges, AttnMaskType, port_rect, port_meta, mask, cp)
    host_ops.CALLS.clear()
    got = port_algs.BinaryGreedyParallelAlg().solve(rects, ctx)
    assert host_ops.CALLS.get("binary_greedy_solve") == 1
    numpy_path = port_algs.BinaryGreedyParallelAlg()._solve_numpy(cut_to_tiles(rects, ctx), ctx)
    j_rects, j_ctx = _tiles_and_ctx(jax_algs, JaxRanges, JaxMaskType, jax_rect, jax_meta, mask, cp)
    tiles = jax_algs.cut_to_tiles(j_rects, j_ctx)
    want = jax_algs.BinaryGreedyParallelAlg()._solve_numpy(tiles, j_ctx)
    assert _bucket_rows(got) == _bucket_rows(numpy_path) == _bucket_rows(want)
    assert sum(b.area() for b in got) == rects.area()


# the JAX package's incremental case (tests/test_api/test_plan_cache.py) at
# this size: four causal blocks; a new step moves the last block's k end
BLOCKS = [[0, 32], [32, 64], [64, 96], [96, S]]
INCREMENTAL = (
    (BLOCKS, BLOCKS, [1] * 4),
    (BLOCKS, BLOCKS[:3] + [[96, 120]], [1] * 4),
)


@pytest.mark.parametrize("cp", [2, 4])
def test_incremental_resolve_equals_jax(cp):
    """A second mask of the same family re-solves only its changed
    rectangles from the first plan's solver state, in both packages."""
    first = [_plan(pkg, INCREMENTAL[0], cp) for pkg in (PORT, JAX)]
    second = [
        _plan(pkg, INCREMENTAL[1], cp, prev_state=p.solver_state)
        for pkg, p in zip((PORT, JAX), first)
    ]
    assert_same_fields(first[0], first[1], f"first cp{cp}")
    assert_same_fields(second[0], second[1], f"second cp{cp}")
    # the unchanged blocks' tiles kept their ranks
    kept = [
        [[t for t in rank if t[1] <= 96] for rank in _bucket_rows(p.solver_state.buckets)]
        for p in (first[0], second[0])
    ]
    assert any(kept[0]) and kept[0] == kept[1]


def test_manager_seeds_the_family_with_the_last_solve(monkeypatch):
    """Through the API: a new mask of a key's family is planned from the
    previous key's solver state, as the JAX manager plans it."""
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _PLAN_CACHE

    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    _PLAN_CACHE.clear()
    keys = [api.magi_attn_flex_key(*m, S, S, device="cpu", chunk_size=CHUNK) for m in INCREMENTAL]
    plans = [_mgr(k).dynamic_plan for k in keys]
    want = _plan(PORT, INCREMENTAL[1], 1, prev_state=plans[0].solver_state)
    assert_same_fields(plans[1], want, "second key")
    assert type(_mgr(keys[1]).runtime).__name__ == "DynamicDistAttnRuntime"


# ---------------------------------------------------------------------------
# the merge, the row-range ops and the paths that raise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ret_dtype", ["float32", "bfloat16"])
def test_merge_rows_matches_jax(ret_dtype):
    """``merge_rows`` against the JAX package's ``_merge_rows`` on the same
    partials: rows merged from local and returned entries, rows with the
    dummy entry among them, and rows with only the dummy, which come out
    (0, -inf) with no NaN."""
    from magiattention_tpu.functional.dynamic_dist_attn import _merge_rows
    from magiattention_tpu_torch.functional.dynamic_dist_attn import merge_rows

    rng = np.random.default_rng(7)
    nbuf, nret, shard, h, dv, m = 24, 16, 12, 2, 8, 3
    out_buf = rng.standard_normal((nbuf, h, dv)).astype(np.float32)
    lse_buf = rng.standard_normal((nbuf, h)).astype(np.float32)
    ret_out = rng.standard_normal((nret, h, dv)).astype(np.float32)
    ret_lse = rng.standard_normal((nret, h)).astype(np.float32)
    lse_buf[3] = -np.inf  # an empty partial
    out_buf[3] = 0.0
    if ret_dtype == "bfloat16":  # a returned partial in bf16 (no fwd high-precision)
        ret_out = np.array(jnp.asarray(ret_out, jnp.bfloat16).astype(jnp.float32))
    dummy = nbuf + nret
    idx = np.full((shard, m), dummy, np.int32)
    idx[:, 0] = np.arange(shard)
    idx[:6, 1] = nbuf + np.arange(6)
    idx[2, 2] = nbuf + 10
    idx[9:] = dummy  # rows 9..11: the dummy only
    got = merge_rows(*(torch.from_numpy(a) for a in (out_buf, lse_buf, ret_out, ret_lse)),
                     torch.from_numpy(idx).long())
    want = _merge_rows(*(jnp.asarray(a) for a in (out_buf, lse_buf, ret_out, ret_lse, idx)))
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        np.testing.assert_array_equal(np.isneginf(a.numpy()), np.isneginf(np.asarray(b)))
        assert_close(a.numpy(), np.asarray(b), **TOL)
    assert not got[0][9:].any() and torch.isneginf(got[1][9:]).all()


@pytest.mark.parametrize("op", ["fill", "gather", "scatter", "sum", "avg", "lse"])
def test_range_ops_match_jax(op):
    """``common/range_op.py`` against the JAX package's on the same rows."""
    from magiattention_tpu.common import range_op as jax_ops
    from magiattention_tpu_torch.common import range_op as ops

    rng = np.random.default_rng(11)
    x = rng.standard_normal((20, 2, 4)).astype(np.float32)
    y = rng.standard_normal((20, 2, 4)).astype(np.float32)
    out_r, in_r = [[0, 3], [5, 9], [5, 7]], [[10, 13], [2, 6], [14, 16]]
    t = torch.from_numpy
    j = jnp.asarray
    if op == "fill":
        got, want = ops.range_fill(t(x), out_r, 2.5), jax_ops.range_fill(j(x), out_r, 2.5)
    elif op == "gather":
        got, want = ops.range_gather(t(x), in_r), jax_ops.range_gather(j(x), in_r)
    elif op == "scatter":
        rows = y[:9]
        got = ops.range_scatter(t(x), [[0, 3], [10, 16]], t(rows))
        want = jax_ops.range_scatter(j(x), [[0, 3], [10, 16]], j(rows))
    elif op in ("sum", "avg"):
        got = ops.range_reduce(t(x), t(y), out_r, in_r, op=op)
        want = jax_ops.range_reduce(j(x), j(y), out_r, in_r, op=op)
    else:
        lse, lse_in = (rng.standard_normal((20, 2)).astype(np.float32) for _ in range(2))
        lse_in[12] = -np.inf
        got = ops.range_lse_reduce(t(x), t(lse), t(y), t(lse_in), out_r, in_r)
        want = jax_ops.range_lse_reduce(j(x), j(lse), j(y), j(lse_in), out_r, in_r)
    for a, b in zip(*((got, want) if op == "lse" else ((got,), (want,)))):
        assert_close(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize(
    "env,kwargs",
    [({"MAGI_ATTENTION_HIERARCHICAL_COMM": "1"}, {}), ({}, {"head_axis": "tp"})],
    ids=["hierarchical", "head_axis"],
)
def test_qo_comm_with_unported_paths_raises(env, kwargs, monkeypatch):
    """qo-comm with two-level comm or TP head sharding raises, as the JAX
    manager does, instead of running something else."""
    for k, v in {**QO, **env}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError):
        api.magi_attn_flex_key([[0, 64]], [[0, 64]], [1], 64, 64, device="cpu", **kwargs)


def test_qo_comm_sdpa_online_backend_raises(monkeypatch):
    """qo-comm on the ``sdpa_online`` backend (it raised before it was
    ported; the name is kept): at cp 1 through the API, out, lse and the
    gradients against the JAX package's dynamic runtime on the same
    backend, float32 1e-5."""
    env = {**QO, "MAGI_ATTENTION_KERNEL_BACKEND": "sdpa_online"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    qr, kr, types = MASKS["shared_prefix"]
    q, k, v, do = cp_inputs(3)
    key = api.magi_attn_flex_key(qr, kr, types, CP_SEQ, CP_SEQ, device="cpu", chunk_size=CP_CHUNK)
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr

    rt = _mgr(key).runtime
    assert type(rt).__name__ == "DynamicDistAttnRuntime" and rt.backend == "sdpa_online"
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out_d, meta = api.calc_attn(
        api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
        api.dispatch(leaves[2], key, role="kv"), key,
    )
    out = api.undispatch(out_d, key)
    (out * torch.from_numpy(do)).sum().backward()
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), axis_names=("cp",))
    jkey = jax_api.magi_attn_flex_key(qr, kr, types, CP_SEQ, CP_SEQ, mesh=mesh, chunk_size=CP_CHUNK)

    def loss(q, k, v):
        o_d, m = jax_api.calc_attn(
            jax_api.dispatch(q, jkey), jax_api.dispatch(k, jkey, role="kv"),
            jax_api.dispatch(v, jkey, role="kv"), jkey,
        )
        o = jax_api.undispatch(o_d, jkey)
        return jnp.sum(o * do), (o, m.lse)

    (_, (jout, jlse)), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    assert_close(out.detach().numpy(), np.asarray(jout), msg="out", **TOL)
    jlse = np.asarray(jlse)
    np.testing.assert_array_equal(np.isneginf(meta.lse.numpy()), np.isneginf(jlse))
    assert_close(meta.lse.numpy(), jlse, msg="lse", **TOL)
    for name, t, g in zip(("dq", "dk", "dv"), leaves, jgrads):
        assert_close(t.grad.numpy(), np.asarray(g), msg=name, **TOL)


def test_uncovered_rows_at_cp1_both_passes(monkeypatch):
    """qo-comm at cp 1 over a mask with rows no slice covers: out 0 and lse
    -inf on those rows, no NaN anywhere in out or the gradients, and the
    result equal to the dense plain attention."""
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    qr, kr, types = [[0, 48], [80, 128]], [[0, 64], [32, 128]], [1, 0]
    key = api.magi_attn_flex_key(qr, kr, types, 128, 128, device="cpu", chunk_size=16)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((128, 4, 32), (128, 2, 32), (128, 2, 32)))
    do = torch.from_numpy(rng.standard_normal((128, 4, 32)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out_d, meta = api.calc_attn(api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
                                api.dispatch(leaves[2], key, role="kv"), key)
    out = api.undispatch(out_d, key)
    lse = api.undispatch(meta.lse, key)
    (out * do).sum().backward()
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out, ref_lse = sdpa_attn(*ref_leaves, np.array(qr), np.array(kr), np.array(types))
    (ref_out * do).sum().backward()
    assert torch.isneginf(lse[48:80]).all() and not out[48:80].any()
    for got, want in ((out, ref_out), *zip((t.grad for t in leaves), (t.grad for t in ref_leaves))):
        assert torch.isfinite(got).all()
        assert_close(got.detach().numpy(), want.detach().numpy(), **TOL)
    assert_close(lse.numpy(), ref_lse.detach().numpy(), **TOL)


# ---------------------------------------------------------------------------
# the pipeline over gloo against the JAX package on a CPU mesh
# ---------------------------------------------------------------------------

FWD_HP = {"MAGI_ATTENTION_FWD_HIGH_PRECISION_REDUCE": "1"}
BWD_HP = {"MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE": "1"}
SDPA = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}
MASKS = {
    "causal": ([(0, 512)], [(0, 512)], [1]),
    "varlen_causal": ([(0, 160), (160, 352), (352, 512)],) * 2 + ([1, 1, 1],),
    "shared_prefix": ([(0, 128), (128, 512), (128, 512)], [(0, 128), (0, 128), (128, 512)], [1, 0, 1]),
}
CASES = {
    "causal": ("causal", {}),
    "varlen_causal": ("varlen_causal", {}),
    "shared_prefix": ("shared_prefix", {}),
    "shared_prefix_fwd_hp": ("shared_prefix", FWD_HP),
    "varlen_causal_bwd_hp": ("varlen_causal", BWD_HP),
    "causal_sdpa": ("causal", SDPA),
    "shared_prefix_sdpa_online": ("shared_prefix", {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa_online"}),
}
CP_CASES = [(cp, name) for cp in (2, 4) for name in CASES if cp == 2 or name != "causal_sdpa"]


@lru_cache(maxsize=None)
def _port_run(cp: int) -> str:
    """Spawn the cp ranks once; they run every case of this cp size."""
    out_dir = tempfile.mkdtemp(prefix="torch_dyn_")
    cases = [(name, *MASKS[CASES[name][0]], CASES[name][1]) for c, name in CP_CASES if c == cp]
    mp.start_processes(
        dyn_worker, args=(cp, os.path.join(out_dir, "init"), out_dir, cases), nprocs=cp,
        start_method="spawn", join=True,
    )
    return out_dir


@lru_cache(maxsize=None)
def _jax_run(cp: int, name: str):
    """JAX (out, lse in the dispatched layout, (dq, dk, dv), max-logits,
    comm rows) under qo-comm with its sdpa backend."""
    mask, env = CASES[name]
    qr, kr, types = MASKS[mask]
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in {**QO, **SDPA, **env}.items():  # a case's own backend wins
            mpatch.setenv(k, v)
        mesh = Mesh(np.array(jax.devices("cpu")[:cp]), axis_names=("cp",))
        key = jax_api.magi_attn_flex_key(qr, kr, types, CP_SEQ, CP_SEQ, mesh=mesh, chunk_size=CP_CHUNK)
        q, k, v, do = cp_inputs(len(name))

        def loss(q, k, v):
            out_d, meta = jax_api.calc_attn(
                jax_api.dispatch(q, key), jax_api.dispatch(k, key, role="kv"),
                jax_api.dispatch(v, key, role="kv"), key, return_max_logits=True,
            )
            out = jax_api.undispatch(out_d, key)
            return jnp.sum(out * do), (out, meta.lse, meta.max_logits)

        grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (out, lse, ml)), grads = grad_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        from magiattention_tpu.api.magi_attn_interface import _mgr as jax_mgr

        rows = list(jax_mgr(key).dynamic_plan.comm_rows().values())
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads], np.asarray(ml), rows


@pytest.mark.parametrize("cp,name", CP_CASES, ids=[f"cp{c}-{n}" for c, n in CP_CASES])
def test_qo_comm_matches_jax(cp, name):
    out_dir = _port_run(cp)
    out, lse, grads, ml, rows = _jax_run(cp, name)
    shard = lse.shape[0] // cp
    for r in range(cp):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))
        assert str(got["runtime"]) == "DynamicDistAttnRuntime"
        assert got["comm_rows"].tolist() == rows
        assert_close(got["out"], out, msg=f"{name} rank {r} out", **TOL)
        want_lse = lse[r * shard:(r + 1) * shard]
        np.testing.assert_array_equal(np.isneginf(got["lse"]), np.isneginf(want_lse))
        assert_close(got["lse"], want_lse, msg=f"{name} rank {r} lse", **TOL)
        for g, want in zip(("dq", "dk", "dv"), grads):
            assert_close(got[g], want, msg=f"{name} rank {r} {g}", **TOL)
        assert got["ml"].shape == ml.shape and np.isfinite(got["ml"]).all()
        assert_close(got["ml"], ml, msg=f"{name} rank {r} max_logits", **TOL)
    if cp == 4 and CASES[name][0] == "shared_prefix":
        assert rows[0] > 0  # q rows moved: the qo-comm path ran
