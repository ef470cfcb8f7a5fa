"""Numpy-facing wrappers over the native hot loops (the port's copy of
``magiattention_tpu/csrc_backend/ops.py``).

Every wrapper builds the library at its first call (:func:`.build.get_lib`,
an ``ImportError`` where ``g++`` is missing: the callers fall back to
Python) and counts its calls in :data:`CALLS`, so a run can show that the
native path was taken.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np

from . import build

# native calls by wrapper name, since import (or the last ``CALLS.clear()``)
CALLS: Counter = Counter()


def get_lib(name: str) -> ctypes.CDLL:
    """The library, counting one call of ``name``."""
    lib = build.get_lib()
    CALLS[name] += 1
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def band_area_native(i0, i1, j0, j1, lo, hi) -> int:
    return int(get_lib("band_area_native").magi_band_area(i0, i1, j0, j1, lo, hi))


def chunk_areas_native(
    slices: np.ndarray, chunk_size: int, num_chunks: int
) -> np.ndarray:
    """slices: (n, 6) int64 (qs, qe, ks, ke, lo, hi) -> (num_chunks,) areas."""
    s = np.ascontiguousarray(slices, dtype=np.int64)
    out = np.zeros(num_chunks, dtype=np.int64)
    get_lib("chunk_areas_native").magi_chunk_areas(
        _i64p(s), len(s), chunk_size, num_chunks, _i64p(out)
    )
    return out


def minheap_solve_native(
    areas: np.ndarray, cp_size: int, per_rank: int
) -> list[list[int]]:
    a = np.ascontiguousarray(areas, dtype=np.int64)
    assign = np.zeros(len(a), dtype=np.int32)
    get_lib("minheap_solve_native").magi_minheap_solve(
        _i64p(a), len(a), cp_size, per_rank, _i32p(assign)
    )
    return [np.nonzero(assign == r)[0].tolist() for r in range(cp_size)]


def binary_greedy_solve(
    qs: np.ndarray, qe: np.ndarray, ks: np.ndarray, ke: np.ndarray,
    area: np.ndarray, q_owner: np.ndarray, k_owner: np.ndarray,
    cp_size: int, slack: float, max_iters: int,
) -> np.ndarray | None:
    """Native BinaryGreedyParallel hot loop: the chunk-to-rank assignment,
    or None where no assignment fits."""
    n = len(area)
    out = np.empty(n, dtype=np.int32)
    rc = get_lib("binary_greedy_solve").magi_binary_greedy_solve(
        _i64p(np.ascontiguousarray(qs)), _i64p(np.ascontiguousarray(qe)),
        _i64p(np.ascontiguousarray(ks)), _i64p(np.ascontiguousarray(ke)),
        _i64p(np.ascontiguousarray(area)),
        _i32p(np.ascontiguousarray(q_owner)),
        _i32p(np.ascontiguousarray(k_owner)),
        n, cp_size, float(slack), int(max_iters), _i32p(out),
    )
    return out if rc == 0 else None


def ranges_merge_native(ranges: np.ndarray) -> np.ndarray:
    r = np.ascontiguousarray(ranges, dtype=np.int32).reshape(-1, 2)
    out = np.empty_like(r)
    m = get_lib("ranges_merge_native").magi_ranges_merge(_i32p(r), len(r), _i32p(out))
    return out[:m].copy()


def ranges_holes_native(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Both inputs must be merged."""
    a = np.ascontiguousarray(a, dtype=np.int32).reshape(-1, 2)
    b = np.ascontiguousarray(b, dtype=np.int32).reshape(-1, 2)
    out = np.empty((len(a) + len(b) + 1, 2), dtype=np.int32)
    m = get_lib("ranges_holes_native").magi_ranges_holes(
        _i32p(a), len(a), _i32p(b), len(b), _i32p(out)
    )
    return out[:m].copy()


def ranges_overlap_native(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Both inputs must be merged."""
    a = np.ascontiguousarray(a, dtype=np.int32).reshape(-1, 2)
    b = np.ascontiguousarray(b, dtype=np.int32).reshape(-1, 2)
    out = np.empty((len(a) + len(b) + 1, 2), dtype=np.int32)
    m = get_lib("ranges_overlap_native").magi_ranges_overlap(
        _i32p(a), len(a), _i32p(b), len(b), _i32p(out)
    )
    return out[:m].copy()


def ranges_make_local_native(host: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """host must be merged; raises if a range is not covered."""
    h = np.ascontiguousarray(host, dtype=np.int32).reshape(-1, 2)
    r = np.ascontiguousarray(ranges, dtype=np.int32).reshape(-1, 2)
    out = np.empty(((len(r) + 1) * (len(h) + 1), 2), dtype=np.int32)
    m = get_lib("ranges_make_local_native").magi_ranges_make_local(
        _i32p(h), len(h), _i32p(r), len(r), _i32p(out)
    )
    if m < 0:
        from ..common.range import RangeError

        raise RangeError("range not fully covered by host ranges")
    return out[:m].copy()


def ffa_plan_native(
    q_ranges: np.ndarray,
    k_ranges: np.ndarray,
    d_lo: np.ndarray,
    d_hi: np.ndarray,
    num_q_tiles: int,
    num_k_tiles: int,
    block_q: int,
    block_k: int,
    band_inf: int,
):
    """Native FFA work-list builder (csrc magi_ffa_plan_{count,fill}).

    Returns the 6 plan arrays (work_qt, work_kt, meta, work_qt_t,
    work_kt_t, meta_t) with dummy items inserted for empty tiles, matching
    the first 9 meta columns of the Python builder in
    kernels/ffa_plan.build_ffa_plan exactly.
    The meta arrays are 9 columns wide — the fixed row stride the C fill
    routine writes (csrc/magi_host.cpp magi_ffa_plan_fill); the caller
    (build_ffa_plan) appends the live-extent columns host-side.
    """
    from ..kernels.ffa_plan import DHI, DLO, IS_FIRST, IS_LAST

    native_meta_dim = 9  # must match the `meta + p * 9` stride in C

    lib = get_lib("ffa_plan_native")
    qr = np.ascontiguousarray(q_ranges, dtype=np.int32)
    kr = np.ascontiguousarray(k_ranges, dtype=np.int32)
    lo = np.ascontiguousarray(d_lo, dtype=np.int32)
    hi = np.ascontiguousarray(d_hi, dtype=np.int32)
    n = len(qr)
    q_counts = np.zeros(num_q_tiles, dtype=np.int64)
    k_counts = np.zeros(num_k_tiles, dtype=np.int64)
    rc = lib.magi_ffa_plan_count(
        _i32p(qr), _i32p(kr), _i32p(lo), _i32p(hi), n,
        block_q, block_k, num_q_tiles, num_k_tiles,
        _i64p(q_counts), _i64p(k_counts),
    )
    if rc != 0:
        raise ValueError(
            "slice metadata outside the tile grid (negative range or "
            "beyond seqlen)"
        )

    def alloc(counts, major_is_q: bool):
        # every empty tile still gets one dummy item (finalize writes zeros)
        sizes = np.maximum(counts, 1)
        offsets = np.zeros_like(sizes)
        np.cumsum(sizes[:-1], out=offsets[1:])
        total = int(sizes.sum())
        work_a = np.zeros(total, dtype=np.int32)
        work_b = np.zeros(total, dtype=np.int32)
        meta = np.zeros((total, native_meta_dim), dtype=np.int32)
        empty = counts == 0
        if empty.any():
            pos = offsets[empty]
            tiles = np.nonzero(empty)[0].astype(np.int32)
            if major_is_q:
                work_a[pos] = tiles
            else:
                work_b[pos] = tiles
            meta[pos, DLO] = -band_inf
            meta[pos, DHI] = band_inf
            meta[pos, IS_FIRST] = 1
            meta[pos, IS_LAST] = 1
        return work_a, work_b, meta, offsets

    work_qt, work_kt, meta, q_off = alloc(q_counts, True)
    work_qt_t, work_kt_t, meta_t, k_off = alloc(k_counts, False)
    lib.magi_ffa_plan_fill(
        _i32p(qr), _i32p(kr), _i32p(lo), _i32p(hi), n,
        block_q, block_k, num_q_tiles, num_k_tiles,
        _i64p(q_off), _i64p(q_counts), _i64p(k_off), _i64p(k_counts),
        _i32p(work_qt), _i32p(work_kt), _i32p(meta),
        _i32p(work_qt_t), _i32p(work_kt_t), _i32p(meta_t),
    )
    return work_qt, work_kt, meta, work_qt_t, work_kt_t, meta_t
