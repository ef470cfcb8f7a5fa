"""The port's native host backend (``csrc_backend/``, ``common/protocols.py``)
against its Python paths and the JAX package's native library.

- Every op (``band_area``, ``chunk_areas``, ``ranges_{merge,holes,overlap,
  make_local}``, ``minheap_solve``, ``binary_greedy_solve``, the FFA plan
  builder) on seeded inputs: the port's library equals the port's Python
  path and the JAX package's library (loaded through
  ``torch_port_cases.warm_jax_native``). ``binary_greedy_solve`` orders
  equal-area tiles stably, as the port's numpy path does (held there by
  ``tests/test_torch_dynamic.py``), and the JAX library by ``std::sort``:
  it is held against the JAX library on distinct areas.
- ``build_ffa_plan``: native and Python plans array-equal, and equal to the
  JAX package's plan at its quanta.
- The protocol conformance of ``tests/test_common/test_protocol_conformance.py``
  for the port's two backends, and the ``common`` swap.
- The call sites take the native path under MAGI_ATTENTION_CPP_BACKEND=1 and
  never under 0 (the FFA work lists too, under the default 'auto'); a missing ``g++`` falls back to Python under 'auto' and
  raises ``NativeBuildError`` under MAGI_ATTENTION_NATIVE_FFA_PLAN=1.
- The build is race-free: four processes building into one empty cache at
  once all load the library, and leave no temporary file.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from magiattention_tpu.csrc_backend import ops as jops
from magiattention_tpu.kernels.ffa_plan import build_ffa_plan as j_build_ffa_plan
from magiattention_tpu_torch import common
from magiattention_tpu_torch.common import protocols
from magiattention_tpu_torch.common.range import AttnRange as PyRange
from magiattention_tpu_torch.common.ranges import AttnRanges as PyRanges
from magiattention_tpu_torch.csrc_backend import CppAttnRange, CppAttnRanges, build, ops
from magiattention_tpu_torch.kernels import ffa_plan
from magiattention_tpu_torch.kernels.mask_utils import BAND_INF
from magiattention_tpu_torch.meta.container import slice as slice_mod
from tests.torch_port_cases import warm_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _libs():
    warm_jax_native()
    assert build.available()


def _ranges(rng, n, lim=200):
    out = []
    for _ in range(n):
        a = int(rng.integers(0, lim))
        out.append((a, int(rng.integers(a, lim + 1))))
    return out


def _slices(rng, sq, sk, n):
    qs = rng.integers(0, sq, n)
    ks = rng.integers(0, sk, n)
    qr = np.stack([qs, np.minimum(sq, qs + rng.integers(0, 300, n))], 1).astype(np.int32)
    kr = np.stack([ks, np.minimum(sk, ks + rng.integers(0, 300, n))], 1).astype(np.int32)
    lo = rng.integers(-400, 50, n).astype(np.int32)
    hi = (lo + rng.integers(0, 500, n)).astype(np.int32)
    return qr, kr, lo, hi


# ---------------------------------------------------------------------------
# every op against the Python path and JAX's library
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_band_area_and_chunk_areas(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(30):
        i0, i1 = sorted(rng.integers(0, 120, 2).tolist())
        j0, j1 = sorted(rng.integers(0, 120, 2).tolist())
        lo = int(rng.integers(-100, 60))
        rows.append((i0, i1, j0, j1, lo, lo + int(rng.integers(-5, 80))))
    native = [slice_mod.band_area(*r) for r in rows]
    monkeypatch.setenv("MAGI_ATTENTION_CPP_BACKEND", "0")
    python = [slice_mod.band_area(*r) for r in rows]
    assert native == python == [jops.band_area_native(*r) if r[0] < r[1] and r[2] < r[3] and r[4] <= r[5]
                                else 0 for r in rows]
    slices = np.array([(a, b, c, d, e, f) for a, b, c, d, e, f in rows if a < b], np.int64)
    got = ops.chunk_areas_native(slices, 16, 8)
    np.testing.assert_array_equal(got, jops.chunk_areas_native(slices, 16, 8))
    want = np.zeros(8, np.int64)
    for i0, i1, j0, j1, lo, hi in slices:
        for c in range(8):
            a, b = max(i0, 16 * c), min(i1, 16 * c + 16)
            if a < b:
                want[c] += slice_mod.band_area(a, b, j0, j1, lo, hi)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_range_algebra(seed):
    rng = np.random.default_rng(seed)
    a = _ranges(rng, int(rng.integers(0, 10)))
    b = _ranges(rng, int(rng.integers(0, 10)))
    pa, pb = PyRanges.from_ranges(a), PyRanges.from_ranges(b)
    ma, mb = (np.array(x.merge().to_naive_ranges(), np.int32).reshape(-1, 2) for x in (pa, pb))
    for port_fn, jax_fn, args, want in (
        (ops.ranges_merge_native, jops.ranges_merge_native, (np.array(a, np.int32).reshape(-1, 2),),
         pa.merge()),
        (ops.ranges_holes_native, jops.ranges_holes_native, (ma, mb), pa.find_hole_ranges(pb)),
        (ops.ranges_overlap_native, jops.ranges_overlap_native, (ma, mb), pa.find_overlap_ranges(pb)),
    ):
        got = port_fn(*args)
        np.testing.assert_array_equal(got, jax_fn(*args))
        assert got.tolist() == [list(r) for r in want.to_naive_ranges()]


@pytest.mark.parametrize("seed", range(4))
def test_make_local(seed):
    rng = np.random.default_rng(100 + seed)
    host = PyRanges.from_ranges(_ranges(rng, 5)).merge()
    subs = [(r.start, r.start + r.seqlen // 2) for r in host if r.seqlen >= 2]
    if not subs:
        subs = [(host[0].start, host[0].start)] if len(host) else []
    h = np.array(host.to_naive_ranges(), np.int32).reshape(-1, 2)
    s = np.array(subs, np.int32).reshape(-1, 2)
    got = ops.ranges_make_local_native(h, s)
    np.testing.assert_array_equal(got, jops.ranges_make_local_native(h, s))
    if subs:
        want = host.make_ranges_local(PyRanges.from_ranges(subs))
        assert got.tolist() == [list(r) for r in want.to_naive_ranges()]


@pytest.mark.parametrize("cp", [2, 4, 8])
def test_minheap_solve(cp):
    rng = np.random.default_rng(cp)
    areas = rng.integers(0, 1000, cp * 6).astype(np.int64)
    got = ops.minheap_solve_native(areas, cp, 6)
    assert got == jops.minheap_solve_native(areas, cp, 6)
    assert sorted(c for p in got for c in p) == list(range(cp * 6))
    assert all(len(p) == 6 for p in got)


@pytest.mark.parametrize("seed", range(3))
def test_binary_greedy_solve(seed):
    rng = np.random.default_rng(seed)
    n, cp = 40, 4
    qs = rng.integers(0, 512, n).astype(np.int64)
    ks = rng.integers(0, 512, n).astype(np.int64)
    qe, ke = qs + rng.integers(1, 64, n), ks + rng.integers(1, 64, n)
    # distinct areas: the two libraries order tied tiles differently
    area = rng.choice(np.arange(1, 4096), n, replace=False).astype(np.int64)
    qo = rng.integers(0, cp, n).astype(np.int32)
    ko = rng.integers(0, cp, n).astype(np.int32)
    args = (qs, qe, ks, ke, area, qo, ko, cp, 0.02, 16)
    got = ops.binary_greedy_solve(*args)
    want = jops.binary_greedy_solve(*args)
    assert got is not None and np.array_equal(got, want)
    assert set(got.tolist()) <= set(range(cp))


PLAN_FIELDS = ("work_qt", "work_kt", "meta", "work_qt_t", "work_kt_t", "meta_t", "run_ptr", "run_ptr_t")


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128), (128, 128)])
@pytest.mark.parametrize("seed", range(5))
def test_build_ffa_plan_native_python_and_jax(seed, blocks, monkeypatch):
    rng = np.random.default_rng(seed)
    sq, sk = int(rng.integers(1, 700)), int(rng.integers(1, 700))
    qr, kr, lo, hi = _slices(rng, sq, sk, int(rng.integers(1, 8)))
    plans = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("MAGI_ATTENTION_NATIVE_FFA_PLAN", mode)
        plans[mode] = ffa_plan.build_ffa_plan(qr, kr, lo, hi, sq, sk, *blocks)
    for f in PLAN_FIELDS:
        a, b = getattr(plans["1"], f), getattr(plans["0"], f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the native count and fill alone are the JAX library's
    nq, nk = plans["1"].num_q_tiles, plans["1"].num_k_tiles
    got = ops.ffa_plan_native(qr, kr, lo, hi, nq, nk, *blocks, BAND_INF)
    want = jops.ffa_plan_native(qr, kr, lo, hi, nq, nk, *blocks, BAND_INF)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # and the whole plan at the JAX package's quanta is JAX's plan
    monkeypatch.setenv("MAGI_ATTENTION_NATIVE_FFA_PLAN", "1")
    port = ffa_plan.build_ffa_plan(qr, kr, lo, hi, sq, sk, *blocks, quanta=(8, 128))
    ref = j_build_ffa_plan(qr, kr, lo, hi, sq, sk, *blocks)
    for f in PLAN_FIELDS[:6]:
        np.testing.assert_array_equal(getattr(port, f), np.asarray(getattr(ref, f)), err_msg=f)


# ---------------------------------------------------------------------------
# protocols and the common swap
# ---------------------------------------------------------------------------


def test_protocol_conformance():
    assert isinstance(PyRange(0, 4), protocols.AttnRangeProtocol)
    assert isinstance(CppAttnRange(0, 4), protocols.AttnRangeProtocol)
    assert isinstance(PyRanges(), protocols.AttnRangesProtocol)
    assert isinstance(CppAttnRanges(), protocols.AttnRangesProtocol)
    assert common.AttnRanges is CppAttnRanges and common.AttnRange is CppAttnRange


@pytest.mark.parametrize("seed", range(6))
def test_cpp_ranges_match_python(seed):
    rng = np.random.default_rng(seed)
    a, b = _ranges(rng, int(rng.integers(0, 10))), _ranges(rng, int(rng.integers(0, 10)))
    pa, pb = PyRanges.from_ranges(a), PyRanges.from_ranges(b)
    ca, cb = CppAttnRanges.from_ranges(a), CppAttnRanges.from_ranges(b)
    before = ops.CALLS["ranges_merge_native"]
    assert pa.merge().to_naive_ranges() == ca.merge().to_naive_ranges()
    assert ops.CALLS["ranges_merge_native"] == before + int(bool(a))
    assert pa.find_hole_ranges(pb).to_naive_ranges() == ca.find_hole_ranges(cb).to_naive_ranges()
    assert pa.find_overlap_ranges(pb).to_naive_ranges() == ca.find_overlap_ranges(cb).to_naive_ranges()
    host = pa.merge()
    subs = [(r.start, r.start + r.seqlen // 2) for r in host if r.seqlen >= 2]
    if subs:
        want = host.make_ranges_local(PyRanges.from_ranges(subs)).to_naive_ranges()
        got = CppAttnRanges.from_ranges(host.to_naive_ranges()).make_ranges_local(
            CppAttnRanges.from_ranges(subs))
        assert got.to_naive_ranges() == want


def test_common_swap_off(monkeypatch):
    """Under MAGI_ATTENTION_CPP_BACKEND=0 ``common`` exports the Python
    classes (a fresh interpreter: the swap is made at import)."""
    code = textwrap.dedent("""
        import magiattention_tpu_torch.common as c
        from magiattention_tpu_torch.common.ranges import AttnRanges
        print(c.AttnRanges is AttnRanges)
    """)
    env = dict(os.environ, MAGI_ATTENTION_CPP_BACKEND="0", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.stdout.strip() == "True", proc.stderr


# ---------------------------------------------------------------------------
# the call sites, the fallback, the build
# ---------------------------------------------------------------------------


def test_call_sites_take_the_native_path_only_when_on(monkeypatch):
    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges

    def plan():
        r = PyRanges.from_ranges([[0, 512]])
        mq, _, _ = make_dispatch_meta_from_qk_ranges(r, r, [AttnMaskType.CAUSAL], 512, 512, 32, 4)
        q = np.array([[0, 300]], np.int32)
        ffa_plan.build_ffa_plan(q, q, np.array([-300], np.int32), np.array([0], np.int32),
                                300, 300, 64, 64)
        return [list(p) for p in mq.partitions]

    ops.CALLS.clear()
    on = plan()
    assert {"band_area_native", "minheap_solve_native", "ffa_plan_native"} <= set(ops.CALLS)
    ops.CALLS.clear()
    monkeypatch.setenv("MAGI_ATTENTION_CPP_BACKEND", "0")
    assert plan() == on
    assert not ops.CALLS
    # an explicit '1' still requires the native FFA work lists
    monkeypatch.setenv("MAGI_ATTENTION_NATIVE_FFA_PLAN", "1")
    assert plan() == on
    assert set(ops.CALLS) == {"ffa_plan_native"}


def test_missing_compiler_falls_back_or_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_LIB_ERR", None)
    monkeypatch.setenv("MAGI_ATTENTION_JIT_CACHE_DIR", str(tmp_path))

    def no_gxx(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(build.subprocess, "run", no_gxx)
    q = np.array([[0, 200]], np.int32)
    args = (q, q, np.array([-200], np.int32), np.array([0], np.int32), 200, 200, 64, 64)
    monkeypatch.setenv("MAGI_ATTENTION_NATIVE_FFA_PLAN", "0")
    want = ffa_plan.build_ffa_plan(*args)
    monkeypatch.setenv("MAGI_ATTENTION_NATIVE_FFA_PLAN", "auto")
    got = ffa_plan.build_ffa_plan(*args)
    np.testing.assert_array_equal(got.meta, want.meta)
    assert not build.available() and isinstance(build._LIB_ERR, build.NativeBuildError)
    monkeypatch.setenv("MAGI_ATTENTION_NATIVE_FFA_PLAN", "1")
    with pytest.raises(build.NativeBuildError):
        ffa_plan.build_ffa_plan(*args)
    # the Python paths of the other sites
    assert slice_mod.band_area(0, 10, 0, 10, -3, 0) == 34
    assert CppAttnRanges.from_ranges([(0, 4), (2, 9)]).merge().to_naive_ranges() == [(0, 9)]


def test_concurrent_builds_are_race_free(tmp_path):
    code = textwrap.dedent("""
        import sys
        from magiattention_tpu_torch.csrc_backend import build, ops
        assert ops.band_area_native(0, 10, 0, 10, -3, 0) == 34
        print(build.library_path())
    """)
    env = dict(os.environ, MAGI_ATTENTION_JIT_CACHE_DIR=str(tmp_path), PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    files = sorted(f.name for f in tmp_path.iterdir())
    assert [f for f in files if f.endswith(".so")] == [os.path.basename(outs[0][0].strip())]
    assert not [f for f in files if f.endswith(".tmp")]
