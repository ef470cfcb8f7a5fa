"""Host-side work list for the FFA forward kernel.

The port's copy of the pure-Python builder in
``magiattention_tpu/kernels/ffa_plan.py``: from concrete slice metadata it
lists exactly the (q tile, k tile, slice) work items a kernel must visit.
Fully-masked tiles are never listed; fully-unmasked tiles carry IS_FULL so
the kernel can skip the mask. The arrays are the reference's, column for
column, so a plan built here at the reference's blocks and quanta is
``np.array_equal`` to the reference's.

What the port adds: **run offsets**. A q tile's items form one contiguous
run of the q-major list (IS_FIRST .. IS_LAST), and a k tile's items one run
of the k-major list. ``run_ptr[t] .. run_ptr[t + 1]`` are the item indices of
q tile ``t`` (``run_ptr_t`` likewise over k tiles), so the GPU kernel
launches one CTA per (run, head) and loops over the run itself instead of
relying on a sequential grid.

The extent columns EQ0..EK1 are rounded to quanta that are parameters here:
the reference rounds q rows to the TPU's sublane (8) and k columns to its
lane (128); the port's default rounds to 1 (exact live extents), since no
GPU kernel of the port reads them yet.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..env.general import is_range_merge_enable
from .mask_utils import BAND_INF, merge_band_slices

# meta columns per work item (same layout as the reference)
QS, QE, KS, KE, DLO, DHI, IS_FIRST, IS_LAST, IS_FULL = range(9)
EQ0, EQ1, EK0, EK1 = 9, 10, 11, 12
QVF, QVL = 13, 14
META_DIM = 15
# extent rounding quanta (rows, cols); the reference's are (8, 128)
DEFAULT_QUANTA = (1, 1)


@dataclass(frozen=True, eq=False)
class FFAPlan:
    """A flat, q-tile-major work list plus its k-tile-major transpose."""

    # q-major (forward): runs of items grouped by q tile
    work_qt: np.ndarray  # (W,) int32 — q tile index per item
    work_kt: np.ndarray  # (W,) int32 — k tile index per item
    meta: np.ndarray  # (W, META_DIM) int32
    # k-major (backward dk/dv): runs grouped by k tile
    work_qt_t: np.ndarray
    work_kt_t: np.ndarray
    meta_t: np.ndarray
    num_q_tiles: int
    num_k_tiles: int
    block_q: int
    block_k: int
    run_ptr: np.ndarray  # (num_q_tiles + 1,) int32 CSR over q-major runs
    run_ptr_t: np.ndarray  # (num_k_tiles + 1,) int32 CSR over k-major runs
    _device: dict = field(default_factory=dict, init=False, repr=False)
    _memo: dict = field(default_factory=dict, init=False, repr=False)

    @property
    def num_work(self) -> int:
        return len(self.work_qt)

    @property
    def num_work_t(self) -> int:
        return len(self.work_qt_t)

    def device_arrays(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The q-major ``(work_kt, meta, run_ptr)`` as int32 tensors on
        ``device`` (forward and dq), copied once per device and kept with
        the (cached) plan."""
        return self._on_device(device, "q", (self.work_kt, self.meta, self.run_ptr))

    def device_arrays_t(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The k-major ``(work_qt_t, meta_t, run_ptr_t)`` on ``device``
        (dk/dv), cached like :meth:`device_arrays`."""
        return self._on_device(
            device, "k", (self.work_qt_t, self.meta_t, self.run_ptr_t)
        )

    def slices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """The (merged) band slices the plan covers, read back from its real
        items: ``(q_ranges, k_ranges, d_lo, d_hi)``."""
        got = self._memo.get("slices")
        if got is None:
            real = self.meta[self.meta[:, QE] > self.meta[:, QS]]
            cols = np.unique(real[:, [QS, QE, KS, KE, DLO, DHI]], axis=0)
            got = (cols[:, 0:2], cols[:, 2:4], cols[:, 4], cols[:, 5])
            self._memo["slices"] = got
        return got

    def retiled(self, block_q: int, block_k: int, seqlen_q: int, seqlen_k: int) -> "FFAPlan":
        """The plan of the same slices at tiles (block_q, block_k): itself
        at its own tiles, else built once (the backward's per-pass plans)."""
        if (block_q, block_k) == (self.block_q, self.block_k):
            return self
        key = ("tiles", block_q, block_k, seqlen_q, seqlen_k)
        got = self._memo.get(key)
        if got is None:
            got = get_ffa_plan(*self.slices(), seqlen_q, seqlen_k, block_q, block_k)
            self._memo[key] = got
        return got

    def runs_digest(self, major: str) -> str:
        """A digest of the real items of each q-major (``"q"``) or k-major
        (``"k"``) run: what the backward-mode model reads of the plan."""
        key = ("digest", major)
        got = self._memo.get(key)
        if got is None:
            meta, ptr = (self.meta, self.run_ptr) if major == "q" else (self.meta_t, self.run_ptr_t)
            real = ((meta[:, QE] > meta[:, QS]) & (meta[:, KE] > meta[:, KS])).astype(np.int64)
            items = np.add.reduceat(real, ptr[:-1]) if len(meta) else real
            got = hashlib.md5(np.ascontiguousarray(items).tobytes()).hexdigest()[:16]
            self._memo[key] = got
        return got

    def _on_device(self, device, major: str, host: tuple) -> tuple[torch.Tensor, ...]:
        key = (str(device), major)
        arrays = self._device.get(key)
        if arrays is None:
            arrays = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host
            )
            self._device[key] = arrays
        return arrays


def plan_extent_stats(plan: FFAPlan) -> dict:
    """Executed-vs-padded element accounting from the extent columns (the
    JAX package's ``plan_extent_stats``): real items are rows with a
    non-empty q range; padded elements are real items x bq x bk, executed
    ones the live extents' areas (at the port's exact extents, quanta 1,
    the live sub-rectangles)."""
    meta = plan.meta.astype(np.int64)
    real = meta[:, QE] > meta[:, QS]
    n_real = int(real.sum())
    executed = int(
        ((meta[real, EQ1] - meta[real, EQ0]) * (meta[real, EK1] - meta[real, EK0])).sum()
    )
    return {
        "num_real_work": n_real,
        "padded_elems": n_real * plan.block_q * plan.block_k,
        "executed_elems": executed,
    }


# per-slice padded/band cover-ratio buckets of the fragmentation histogram
FRAG_BUCKETS: tuple[tuple[str, float], ...] = (
    ("lt_1.2", 1.2),
    ("lt_2", 2.0),
    ("lt_4", 4.0),
    ("lt_8", 8.0),
    ("ge_8", float("inf")),
)


def fragmentation_histogram(ratios: np.ndarray) -> dict[str, int]:
    """Per-slice cover ratios (``tile_policy.slice_cover_ratios``) in the
    :data:`FRAG_BUCKETS` histogram (the JAX package's
    ``fragmentation_histogram``)."""
    hist = {name: 0 for name, _ in FRAG_BUCKETS}
    for r in np.asarray(ratios, dtype=np.float64).ravel():
        for name, ub in FRAG_BUCKETS:
            if r < ub:
                hist[name] += 1
                break
    return hist


def _extend_meta_extents(
    meta9: np.ndarray,
    work_qt: np.ndarray,
    work_kt: np.ndarray,
    block_q: int,
    block_k: int,
    quanta: tuple[int, int],
) -> np.ndarray:
    """Append the tile-local live-extent columns EQ0..EK1 to 9-col meta rows.

    For each work item the band ``d_lo <= j - i <= d_hi`` restricted to the
    slice rectangle intersected with the tile gives a live sub-rectangle;
    its q rows are floored/ceiled to ``quanta[0]``, its k cols to
    ``quanta[1]``. Items with an empty intersection (dummy items of empty
    tiles) get the all-zero extent. int64 internally: DLO/DHI carry
    ±BAND_INF and the un-clamped interval arithmetic must not wrap.
    """
    qq, kq = quanta
    m = meta9.astype(np.int64)
    qb = work_qt.astype(np.int64) * block_q
    kb = work_kt.astype(np.int64) * block_k
    i0 = np.maximum(m[:, QS], qb)
    i1 = np.minimum(m[:, QE], qb + block_q)
    j0 = np.maximum(m[:, KS], kb)
    j1 = np.minimum(m[:, KE], kb + block_k)
    lo, hi = m[:, DLO], m[:, DHI]
    q0 = np.maximum(i0, j0 - hi)
    q1 = np.minimum(i1, j1 - lo)
    k0 = np.maximum(j0, i0 + lo)
    k1 = np.minimum(j1, i1 + hi)
    eq0 = (q0 - qb) // qq * qq
    eq1 = -(-(q1 - qb) // qq) * qq
    ek0 = (k0 - kb) // kq * kq
    ek1 = -(-(k1 - kb) // kq) * kq
    ext = np.stack(
        [
            np.clip(eq0, 0, block_q),
            np.clip(eq1, 0, block_q),
            np.clip(ek0, 0, block_k),
            np.clip(ek1, 0, block_k),
        ],
        axis=1,
    )
    empty = (i0 >= i1) | (j0 >= j1) | (q1 <= q0) | (k1 <= k0)
    ext[empty] = 0
    return np.concatenate([meta9, ext.astype(np.int32)], axis=1)


def _extend_meta_visits(meta13: np.ndarray, work_qt: np.ndarray) -> np.ndarray:
    """Append the q-visit flag columns QVF/QVL: 1 on the row where the
    item's q tile appears for the first (resp. last) time in the WHOLE list
    (on the q-major list they coincide with IS_FIRST/IS_LAST)."""
    w = np.asarray(work_qt)
    n = len(w)
    qvf = np.zeros(n, dtype=np.int32)
    qvl = np.zeros(n, dtype=np.int32)
    if n:
        first_idx: dict[int, int] = {}
        last_idx: dict[int, int] = {}
        for i, qt in enumerate(w.tolist()):
            if qt not in first_idx:
                first_idx[qt] = i
            last_idx[qt] = i
        qvf[list(first_idx.values())] = 1
        qvl[list(last_idx.values())] = 1
    return np.concatenate(
        [meta13, np.stack([qvf, qvl], axis=1)], axis=1
    ).astype(np.int32)


def _run_offsets(meta: np.ndarray) -> np.ndarray:
    """CSR offsets of the runs: the IS_FIRST rows, then the list length.
    Every tile has a run (an empty tile gets one dummy item), so run t is
    tile t."""
    starts = np.flatnonzero(meta[:, IS_FIRST])
    return np.append(starts, len(meta)).astype(np.int32)


def _band_tile_interaction(
    i0: int, i1: int, j0: int, j1: int, lo: int, hi: int
) -> tuple[bool, bool]:
    """(nonempty, fully_unmasked) of band [lo, hi] on rect [i0,i1) x [j0,j1)."""
    if i0 >= i1 or j0 >= j1:
        return False, False
    d_min = j0 - (i1 - 1)
    d_max = (j1 - 1) - i0
    nonempty = d_min <= hi and d_max >= lo
    full = nonempty and d_max <= hi and d_min >= lo
    return nonempty, full


def build_ffa_plan(
    q_ranges: np.ndarray,
    k_ranges: np.ndarray,
    d_lo: np.ndarray,
    d_hi: np.ndarray,
    seqlen_q: int,
    seqlen_k: int,
    block_q: int,
    block_k: int,
    quanta: tuple[int, int] = DEFAULT_QUANTA,
) -> FFAPlan:
    """Build the work-item lists for the given band-slice metadata.

    When ``MAGI_ATTENTION_RANGE_MERGE`` is on (default), band-compatible
    adjacent slices are merged first (exact: bands are global-coordinate,
    so the merged cover is identical).
    """
    if is_range_merge_enable():
        q_ranges, k_ranges, d_lo, d_hi = merge_band_slices(
            q_ranges, k_ranges, d_lo, d_hi
        )
    num_q_tiles = max(1, -(-seqlen_q // block_q))
    num_k_tiles = max(1, -(-seqlen_k // block_k))

    n = len(q_ranges)
    q_items: list[list[tuple[int, ...]]] = [[] for _ in range(num_q_tiles)]
    k_items: list[list[tuple[int, ...]]] = [[] for _ in range(num_k_tiles)]

    for s in range(n):
        qs, qe = int(q_ranges[s, 0]), int(q_ranges[s, 1])
        ks, ke = int(k_ranges[s, 0]), int(k_ranges[s, 1])
        lo, hi = int(d_lo[s]), int(d_hi[s])
        if qs >= qe or ks >= ke or lo > hi:
            continue
        if (
            qs < 0
            or ks < 0
            or -(-qe // block_q) > num_q_tiles
            or -(-ke // block_k) > num_k_tiles
        ):
            raise ValueError(
                f"ffa plan slice {s} out of bounds: q[{qs},{qe}) "
                f"k[{ks},{ke}) vs grid {num_q_tiles}x{num_k_tiles} tiles"
            )
        qt_lo, qt_hi = qs // block_q, -(-qe // block_q)
        kt_lo, kt_hi = ks // block_k, -(-ke // block_k)
        for qt in range(qt_lo, qt_hi):
            i0, i1 = max(qs, qt * block_q), min(qe, (qt + 1) * block_q)
            for kt in range(kt_lo, kt_hi):
                j0, j1 = max(ks, kt * block_k), min(ke, (kt + 1) * block_k)
                nonempty, full = _band_tile_interaction(i0, i1, j0, j1, lo, hi)
                if not nonempty:
                    continue
                tile_full = (
                    full
                    and i0 == qt * block_q
                    and i1 == (qt + 1) * block_q
                    and j0 == kt * block_k
                    and j1 == (kt + 1) * block_k
                )
                item = (qt, kt, qs, qe, ks, ke, lo, hi, int(tile_full))
                q_items[qt].append(item)
                k_items[kt].append(item)

    def flatten(buckets, major_is_q: bool):
        work_a, work_b, metas = [], [], []
        for tile_idx, items in enumerate(buckets):
            if not items:
                # dummy item: empty k range -> all-masked -> the kernel
                # writes zeros/-inf for this tile
                items = [
                    (
                        tile_idx if major_is_q else 0,
                        0 if major_is_q else tile_idx,
                        0, 0, 0, 0, -BAND_INF, BAND_INF, 0,
                    )
                ]
            for pos, (qt, kt, qs, qe, ks, ke, lo, hi, full) in enumerate(items):
                m = np.zeros(9, dtype=np.int32)
                m[QS], m[QE], m[KS], m[KE] = qs, qe, ks, ke
                m[DLO], m[DHI] = lo, hi
                m[IS_FIRST] = 1 if pos == 0 else 0
                m[IS_LAST] = 1 if pos == len(items) - 1 else 0
                m[IS_FULL] = full
                work_a.append(qt)
                work_b.append(kt)
                metas.append(m)
        work_a = np.asarray(work_a, dtype=np.int32)
        work_b = np.asarray(work_b, dtype=np.int32)
        meta9 = np.stack(metas).astype(np.int32)
        meta = _extend_meta_visits(
            _extend_meta_extents(
                meta9, work_a, work_b, block_q, block_k, quanta
            ),
            work_a,
        )
        return work_a, work_b, meta

    work_qt, work_kt, meta = flatten(q_items, major_is_q=True)
    work_qt_t, work_kt_t, meta_t = flatten(k_items, major_is_q=False)

    return FFAPlan(
        work_qt=work_qt,
        work_kt=work_kt,
        meta=meta,
        work_qt_t=work_qt_t,
        work_kt_t=work_kt_t,
        meta_t=meta_t,
        num_q_tiles=num_q_tiles,
        num_k_tiles=num_k_tiles,
        block_q=block_q,
        block_k=block_k,
        run_ptr=_run_offsets(meta),
        run_ptr_t=_run_offsets(meta_t),
    )


@lru_cache(maxsize=256)
def _cached_plan(
    qr_bytes: bytes,
    kr_bytes: bytes,
    lo_bytes: bytes,
    hi_bytes: bytes,
    n: int,
    seqlen_q: int,
    seqlen_k: int,
    block_q: int,
    block_k: int,
    range_merge: bool,  # cache-key only: build reads the env flag itself
) -> FFAPlan:
    qr = np.frombuffer(qr_bytes, dtype=np.int32).reshape(n, 2)
    kr = np.frombuffer(kr_bytes, dtype=np.int32).reshape(n, 2)
    lo = np.frombuffer(lo_bytes, dtype=np.int32)
    hi = np.frombuffer(hi_bytes, dtype=np.int32)
    return build_ffa_plan(qr, kr, lo, hi, seqlen_q, seqlen_k, block_q, block_k)


def get_ffa_plan(
    q_ranges: np.ndarray,
    k_ranges: np.ndarray,
    d_lo: np.ndarray,
    d_hi: np.ndarray,
    seqlen_q: int,
    seqlen_k: int,
    block_q: int,
    block_k: int,
) -> FFAPlan:
    """LRU-cached plan lookup keyed by the full metadata contents, so a
    serving loop that repeats a chunk geometry reuses its plan (and the
    plan's device arrays)."""
    qr = np.ascontiguousarray(q_ranges, dtype=np.int32)
    kr = np.ascontiguousarray(k_ranges, dtype=np.int32)
    lo = np.ascontiguousarray(d_lo, dtype=np.int32)
    hi = np.ascontiguousarray(d_hi, dtype=np.int32)
    return _cached_plan(
        qr.tobytes(), kr.tobytes(), lo.tobytes(), hi.tobytes(), len(qr),
        seqlen_q, seqlen_k, block_q, block_k, is_range_merge_enable(),
    )
