"""The port's host planners against the JAX package's, field by field.

For the canonical masks of ``tests/test_solver/golden_plan_lib.py`` (2048
tokens, chunks of 128) at cp 1, 2 and 4 and overlap degrees 1, 2 and 4,
and for capacity-weighted dispatches (a slow rank, a drained rank), both
packages plan from the same slice metadata: the dispatch metas (chunk
partitions, position ids, unpermute index, host ranges), every stage's
comm args (transfer table, send indices and counts, receive selectors and
lengths, capacities, the ppermute lowering and the chosen lowering) and
the calc args (host, per-stage remote and merged band slices, shard and
receive lengths) must be equal (``np.array_equal`` on every array). The
plans are host values with no SPMD padding (that is added later, by the
JAX runtime), so nothing is dropped. Each stage must also have a receive
layout that ``all_to_all_single`` delivers (``CastPlan.from_stage``).
"""

import numpy as np
import pytest

from magiattention_tpu import meta as jax_meta
from magiattention_tpu.common.ranges import AttnRanges as JaxRanges
from magiattention_tpu.config import DistAttnConfig as JaxConfig
from magiattention_tpu.config import OverlapConfig as JaxOverlap
from magiattention_tpu_torch import meta as port_meta
from magiattention_tpu_torch.comm.primitives import CastPlan
from magiattention_tpu_torch.common.enum import AttnMaskType
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig

from tests.test_solver.golden_plan_lib import CHUNK, SEQ, canonical_masks
from tests.torch_port_cases import assert_same_fields, warm_jax_native

MASKS = canonical_masks()


@pytest.fixture(scope="module", autouse=True)
def _warm_jax_native():
    """The JAX planners need the JAX package's native library; recover it
    where another process won the race to build it."""
    warm_jax_native()


def _plans(name, cp, degree=1, capacities=None):
    """(port, jax) pairs of (dispatch meta q, dispatch meta kv, comm meta,
    calc meta) for one mask."""
    qr, kr, types = MASKS[name]
    out = []
    for pkg, ranges, config, tmap in (
        (port_meta, AttnRanges, DistAttnConfig(overlap_config=OverlapConfig(degree=degree)),
         [AttnMaskType.normalize(t.to_int_type()) for t in types]),
        (jax_meta, JaxRanges, JaxConfig(overlap_config=JaxOverlap(degree=degree)), list(types)),
    ):
        mq, mkv, bucket = pkg.make_dispatch_meta_from_qk_ranges(
            ranges.from_ranges(qr), ranges.from_ranges(kr), tmap, SEQ, SEQ, CHUNK, cp,
            config.dispatch_config, capacities=capacities,
        )
        comm, calc = pkg.make_attn_meta_from_dispatch_meta(bucket, mq, config, dispatch_meta_kv=mkv)
        out.append((mq, mkv, comm, calc))
    return out


def _assert_plans_equal(port, ref, tag):
    for what, a, b in zip(("dispatch_q", "dispatch_kv", "comm", "calc"), port, ref):
        assert_same_fields(a, b, f"{tag} {what}")
    comm, calc = port[2], port[3]
    cp = len(calc.host_args)
    for st, stage in enumerate(comm.kv_stages):
        for r in range(cp):
            plan = CastPlan.from_stage(stage, r)
            assert plan.recv_len == int(stage.recv_len[r])
            assert plan.buf_len == calc.recv_len_per_stage[st]


@pytest.mark.parametrize("degree", [1, 2, 4])
@pytest.mark.parametrize("cp", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_plans_equal_jax(name, cp, degree):
    port, ref = _plans(name, cp, degree)
    _assert_plans_equal(port, ref, f"{name} cp{cp} deg{degree}")
    if cp == 1:
        assert port[2].kv_stages == []  # no remote kv at all


@pytest.mark.parametrize(
    "caps", [(1.0, 0.5), (1.0, 1.0, 1.0, 0.25), (1.0, 1.0, 1.0, 0.0), (1.0, 1.0, 1.0, 1.0)]
)
@pytest.mark.parametrize("name", ["causal", "varlen_block_causal", "shared_prefix"])
def test_weighted_plans_equal_jax(name, caps):
    port, ref = _plans(name, len(caps), degree=2, capacities=list(caps))
    _assert_plans_equal(port, ref, f"{name} caps{caps}")
    if caps[-1] == 0.0:  # a drained rank owns no chunk
        assert port[0].partitions[-1] == []


def test_stages_exist_where_the_mask_needs_remote_kv():
    """The corpus exercises multi-stage plans: causal at cp 4, degree 4."""
    port, _ = _plans("causal", 4, degree=4)
    assert len(port[2].kv_stages) > 1


@pytest.mark.parametrize(
    "cu,causal,window,glob",
    [
        ([0, 100, 256], True, (-1, -1), 0),
        ([0, 100, 256], False, (-1, -1), 0),
        ([0, 128, 256], False, (32, 0), 0),
        ([0, 128, 256], False, (32, 8), 4),
    ],
)
def test_varlen_key_masks_equal_jax(cu, causal, window, glob):
    """``magi_attn_varlen_key`` compiles cu_seqlens (and windows with global
    tokens) to the slices the JAX package's mask compiler gives."""
    from magiattention_tpu.api.functools import infer_attn_mask_from_cu_seqlens
    from magiattention_tpu_torch import api

    key = api.magi_attn_varlen_key(
        cu, causal=causal, window_size=window, global_window_size=glob,
        device="cpu", chunk_size=32,
    )
    qr, kr, types = infer_attn_mask_from_cu_seqlens(
        cu, causal=causal, window_size=window, global_window_size=glob
    )
    assert key.q_ranges == tuple(qr.to_naive_ranges())
    assert key.k_ranges == tuple(kr.to_naive_ranges())
    assert key.attn_mask_type == tuple(t.to_int_type() for t in types)


def test_plan_cache_reuses_a_solved_mask():
    """A key that differs only in its device reuses the solved plan (the
    memory tier of the plan cache): the very same dispatch metas."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr

    docs = [[0, 192], [192, 512]]
    a = api.magi_attn_flex_key(docs, docs, [1, 1], 512, 512, device="cpu")
    b = api.magi_attn_flex_key(docs, docs, [1, 1], 512, 512, device="cpu:0")
    assert a != b
    assert _mgr(b).plan_source == "memory"
    assert _mgr(b).dispatch_meta_q is _mgr(a).dispatch_meta_q


@pytest.mark.parametrize(
    "env,kwargs",
    [
        ({"MAGI_ATTENTION_HIERARCHICAL_COMM": "1"}, {}),
        ({}, {"head_axis": "tp"}),
    ],
)
def test_paths_not_ported_yet_raise(env, kwargs, monkeypatch):
    """Two-level comm and TP head sharding, once refused here, are ported
    (tests/test_torch_hier.py, tests/test_torch_tp_cp.py). Without a mesh
    neither runs something else: the flag leaves a key over a flat cp
    group (here cp 1) flat, and a ``head_axis`` that names no axis of a
    mesh raises."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "head_axis" in kwargs:
        with pytest.raises(ValueError, match="names no axis of the key's mesh"):
            api.magi_attn_flex_key([[0, 64]], [[0, 64]], [1], 64, 64, device="cpu", **kwargs)
        return
    key = api.magi_attn_flex_key([[0, 64]], [[0, 64]], [1], 64, 64, device="cpu", **kwargs)
    assert not _mgr(key).runtime.hier
    assert all(s.hier_plan is None for s in _mgr(key).comm_meta.kv_stages)


def test_planner_recovers_a_lost_native_build_race(tmp_path):
    """A process whose native build lost the race to another (its
    ``get_lib`` memoized ``FileNotFoundError`` while the library exists)
    fails every JAX planner call; ``warm_jax_native`` recovers it, and the
    JAX planner then returns a plan. Run in a subprocess over a fresh
    cache directory (one build, by the import of ``torch_port_cases``)."""
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(
        """
        import os
        from tests import torch_port_cases as c
        from magiattention_tpu import meta
        from magiattention_tpu.common.enum import AttnMaskType
        from magiattention_tpu.common.ranges import AttnRanges

        build, so = c._native_so()
        assert so.exists() and str(so).startswith(os.environ["MAGI_ATTENTION_JIT_CACHE_DIR"])
        tmp = so.with_suffix(".so.tmp")
        build._LIB = None  # this process lost the race: the rename found no tmp file
        build._LIB_ERR = ImportError(
            f"native build failed: {FileNotFoundError(2, 'No such file or directory', str(tmp))}"
        )

        def plan():
            r = AttnRanges.from_ranges([[0, 256]])
            mq, mkv, bucket = meta.make_dispatch_meta_from_qk_ranges(
                r, r, [AttnMaskType.CAUSAL], 256, 256, 32, 2)
            return meta.make_attn_meta_from_dispatch_meta(bucket, mq, dispatch_meta_kv=mkv)

        try:
            plan()
            print("planned before the repair")
        except ImportError:
            print("failed before the repair")
        c.warm_jax_native()
        comm, calc = plan()
        print("stages", len(comm.kv_stages), "ranks", len(calc.host_args))
        """
    )
    env = dict(os.environ, MAGI_ATTENTION_JIT_CACHE_DIR=str(tmp_path / "jit"),
               PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["failed before the repair", "stages 1 ranks 2"]
    assert len(list((tmp_path / "jit").glob("magi_host_*.so"))) == 1
