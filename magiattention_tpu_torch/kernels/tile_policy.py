"""Tile policy and backward-mode cost model, derived for the port's Hopper
kernels.

**Tiles** (the port's counterpart of the JAX package's auto-tile policy,
``magiattention_tpu/kernels/tile_policy.py``: ``auto_tile_enabled``,
``count_ffa_work``, ``choose_blocks*``, ``_band_candidates``,
``reachable_block_space``, ``slice_cover_*``, ``choose_mixed_dispatch``).
The counting functions depend on geometry alone and equal the JAX
package's for the same (bq, bk). The choosers score each candidate as the
JAX package does, ``W * (bq * bk + OVERHEAD_ELEMS)`` (W the plan's work
items, the maximum over a CP group's ranks), over a :class:`TileSpace`
re-derived for the card: the candidates are the pairs compiled for the
pass, dtype and width (``utils/mem_budget.py:compiled_tiles``: q and k
tiles of 64 or 128 rows, 64 x 64 for the float32 backward), the guard is
that compile set's shared-memory budget (in place of VMEM), the tile
quantum is 64 (in place of the TPU's 128 lanes), the default and fallback
pair 64 x 64 (the env's), and :data:`OVERHEAD_ELEMS` and
:data:`MERGE_OVERHEAD_PER_ROW` are fitted to this card's times
(``chip_smoke.py`` phase ``tiles``). A test can hand the choosers the JAX
package's space (its candidates, quanta, overhead and VMEM guard) and
must get its picks. Auto-tile is opt-in
(MAGI_ATTENTION_FFA_AUTO_TILE=1); the mixed dispatch is on by default
through the backend registry's ``ffa_dispatch`` decision.

**Backward mode.** The JAX package's model (``magiattention_tpu/kernels/tile_policy.py``:
``bwd_mxu_elems``, ``bwd_hbm_bytes``, ``choose_bwd_mode``) prices
tensor-core tile products per work item plus HBM blocks per work item,
and charges the fused mode a float32 dq read-modify-write in HBM for
every (k-major item, head). None of that describes the port's kernels:
in float32 the split kernels (dq, dk/dv) and the fused kernel run float32
FMA on the CUDA cores, in bf16 all three run their products on the tensor
cores (csrc/ffa_bwd_dq_tc.cuh, csrc/bwd_kv_tc.cuh), all one CTA per run
of a tile's items (operands of the run's tile resident, the other side
streamed per item), and the fused kernel's dq atomics resolve in L2. So
this model prices what the card does:

- **compute**: each kernel's CTAs, in launch order, dealt to the SMs'
  slots as they free up (one CTA per SM for the CUDA-core kernels; per
  tensor-core kernel :data:`TC_CTAS_PER_SM`), each CTA taking (items in
  its run) x (heads it loops) x the kernel's measured time per
  (item, head); the kernel's time is the
  last CTA's finish. This is what separates the modes: both do the same
  items, but the fused mode runs all of them over the k-major runs, so a
  mask with one long k-major run (a column every q tile reaches, e.g.
  global tokens before a sliding window) leaves it waiting on that run,
  where split spreads the dq part over the short q-major runs;
- **atomics**: the float32 fused kernel's scalar float32 adds of dq (64 x
  d per item and head) at the rate the card sustains (the bf16 body's
  16-byte vector adds fit at no cost beside its products, so it has no
  such term);
- **DRAM**: the operand streams per run and per item, the outputs, and
  the fused dq workspace about once per pass (zeroed, written back from
  L2, read and written by the convert pass), at the data-sheet HBM rate.

The constants were measured by ``chip_smoke.py`` (phase ``bwd_mode``) on an
NVIDIA H100 80GB HBM3 at a 700 W power limit. CUDA-core kernels
(:func:`calibrate`): each kernel's time at the train phase's attention
shape over its modeled makespan in (item, head) units, at head_dim 128;
the atomic rate from the float32 fused kernel's time less 5/4 of the dk/dv
kernel's (that body is the dk/dv body plus one tile product, dS K, and the
atomics). The tensor-core bodies (:func:`calibrate_tc`): each kernel's
per-(item, head) time fitted by least squares to its times at the bf16
masks of the phase. Head dims up to 128 scale the per-item times by
d / 128. At 256 (:func:`width_scale`) every kernel splits the columns it
writes in two 128-column halves across the grid, so it runs twice the
CTAs, and each CTA does its 128-wide output products beside S and dP over
the full 256 (the recompute: :data:`TC_PRODUCTS`, :data:`FMA_PRODUCTS`);
the tensor-core bodies then run one CTA an SM (shared memory). Which
bodies a backward runs follows its dtype (``BwdShape.itemsize``: 2 is
bf16, the tensor-core bodies; :func:`dtype_body`).
"""

from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .. import telemetry
from ..env.general import _get_int
from ..env import backend as env_backend
from ..resilience.inject import maybe_inject
from ..utils import mem_budget
from . import registry as _registry
from .head_dims import SPLIT_WIDTH, column_halves, kernel_head_dim

# ---------------------------------------------------------------------------
# tiles: plan-geometry-driven (bq, bk) per pass, and the mixed dispatch
# ---------------------------------------------------------------------------

# the Hopper tile quantum: wgmma's 64-row product, the kernels' 64-row tiles
NUM_LANES = 64
# The per-work-item fixed cost in score-element equivalents (the JAX
# package's OVERHEAD_ELEMS, re-fitted for the card), per dtype (itemsize):
# a CTA step's loads, waits, barriers and softmax bookkeeping beside its
# bq * bk scores. Fitted by least squares, time / heads = e * (padded
# elements + OVERHEAD_ELEMS * items), to the forward's (B1) times of every
# compiled (bq, bk) at d 128 (bf16: the causal, train, varlen and
# sink-window masks; float32: the serving prefill and varlen masks) in
# chip_smoke.py phase ``tiles`` (``tiles_fit``), NVIDIA H100 80GB HBM3,
# 700.00 W, and held at >= 0.
# bf16: -179 (residuals up to 51%: the two terms cannot say that the
# 64 x 128 instance runs 30-40% slower per element than the other pairs),
# held at 0, so the policy minimizes padded area and keeps 64 x 64 wherever
# the padding differs (the fastest or tied-fastest pair of every bf16
# kernel at the measured masks); float32: 2109 (residuals up to 20%), so
# it takes 128-row q tiles where they add little padding (the 3xTF32
# body splits each K/V chunk once for both warpgroups).
OVERHEAD_ELEMS = {2: 0, 4: 2109}
# The lse merge of a mixed dispatch in the same units, per merged q row and
# head: :func:`..kernels.ffa._merge_out_lse` of two (8192, 16, 128) outs
# timed in that phase (bf16 0.542 ms, float32 0.387 ms), over e.
MERGE_OVERHEAD_PER_ROW = {2: 1846, 4: 387}
# a slice is "fragmented" when its tile cover runs >= 2x its band area
FRAG_THRESHOLD = 2.0
# the card's tile pairs (every compiled (bq, bk)); the resilience layer's
# tile ladder descends them (``resilience/fallback.py:tile_ladder``)
CANDIDATES = mem_budget.TILE_PAIRS


def overhead_elems() -> dict[int, float]:
    """:data:`OVERHEAD_ELEMS`, each dtype's constant replaced by the
    store-fitted ``overhead_elems.<itemsize>`` where the observatory's
    calibration loop is on (``telemetry/drift.fit_constants`` writes it;
    ``store.calibrated`` gates on telemetry and MAGI_ATTENTION_CALIBRATION,
    so with the observatory off these are exactly the constants)."""
    if not env_backend.calibration_enabled():
        return OVERHEAD_ELEMS
    from ..telemetry import store as _tstore

    return {
        itemsize: _tstore.calibrated(f"overhead_elems.{itemsize}", value)
        for itemsize, value in OVERHEAD_ELEMS.items()
    }


def auto_tile_enabled() -> bool:
    return _get_int("MAGI_ATTENTION_FFA_AUTO_TILE", 0) == 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# the card-space choosers' results by geometry and constants: ffa_attn asks
# on every call, and scoring the candidates costs host time (~0.6 ms for a
# one-slice mask)
_MEMO: dict = {}
_MEMO_SIZE = 512


def _memo(name: str, arrays, args: tuple, compute):
    """``compute()``, remembered per (name, the slice arrays' bytes, args,
    the fitted constants) while those constants stay what they are."""
    h = hashlib.md5()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    consts = tuple(sorted(overhead_elems().items())), tuple(sorted(MERGE_OVERHEAD_PER_ROW.items()))
    key = (name, h.hexdigest(), args, consts)
    if key not in _MEMO:
        if len(_MEMO) >= _MEMO_SIZE:
            _MEMO.pop(next(iter(_MEMO)))
        _MEMO[key] = compute()
    return _MEMO[key]


def hopper_fits(kind: str, bq: int, bk: int, d: int, dv: int, itemsize: int) -> bool:
    """The Hopper guard of one pass ("fwd" | "dq" | "dkv", each named as its
    kernel; the fused kernel's set is dk/dv's): the pair is compiled for the
    pass's kernel at this dtype and the kernels' width of (d, dv), which is
    where its CTA fits the shared memory (``utils/mem_budget.py``)."""
    return mem_budget.is_compiled(kind, itemsize, kernel_head_dim(d, dv), bq, bk)


@dataclass(frozen=True)
class TileSpace:
    """What the tile choosers score over: the candidate pairs, the
    quanta the problem clamps them to, the band-derived extras, the
    fallback pair, the per-item overhead and merge cost (score-element
    units; one value, or one per dtype itemsize), the budget guard
    ``fits(kind, bq, bk, d, dv, itemsize)``, and whether backward picks
    must divide the forward's padded geometry (the JAX package's kernels
    index the forward's padded buffers; the port's passes each have their
    own plan)."""

    candidates: tuple[tuple[int, int], ...]
    quantum_q: int
    quantum_k: int
    band_q: tuple[int, ...]
    band_k_max: int
    fallback: tuple[int, int]
    overhead: "float | dict[int, float]"
    merge_per_row: "float | dict[int, float]"
    fits: Callable[[str, int, int, int, int, int], bool]
    bwd_divides: bool = False

    def overhead_for(self, itemsize: int) -> float:
        ov = self.overhead
        return ov[itemsize] if isinstance(ov, dict) else ov

    def merge_for(self, itemsize: int) -> float:
        m = self.merge_per_row
        return m[itemsize] if isinstance(m, dict) else m


def hopper_space() -> TileSpace:
    """The card's space: every compiled pair (:data:`..utils.mem_budget.
    TILE_PAIRS`, filtered per pass by :func:`hopper_fits`), 64-row quanta,
    band extras at 64- and 128-row q tiles, 64 x 64 fallback, the fitted
    constants (read at call time)."""
    return TileSpace(
        candidates=mem_budget.TILE_PAIRS, quantum_q=NUM_LANES, quantum_k=NUM_LANES,
        band_q=(64, 128), band_k_max=128, fallback=mem_budget.DEFAULT_TILES,
        overhead=overhead_elems(), merge_per_row=MERGE_OVERHEAD_PER_ROW, fits=hopper_fits,
    )


def _clamp(space: TileSpace, bq: int, bk: int, sq: int, sk: int) -> tuple[int, int]:
    """A candidate clamped to the problem (the JAX package's
    ``default_blocks`` rule at the space's quanta)."""
    return min(bq, _round_up(sq, space.quantum_q)), min(bk, _round_up(sk, space.quantum_k))


def count_ffa_work(qr, kr, d_lo, d_hi, sq: int, sk: int, bq: int, bk: int) -> int:
    """Exact work-item count of the plan builder (``ffa_plan.build_ffa_plan``)
    at this tiling without building the plan: one item per (slice, q tile,
    k tile) whose diagonal band meets the clipped tile rectangle (per q tile
    the k tiles form one contiguous run, closed-form per (slice, q tile)),
    plus one dummy item for every q tile no slice reaches. The JAX
    package's ``count_ffa_work``, line for line."""
    total = 0
    num_q_tiles = max(1, -(-sq // bq))
    num_k_tiles = max(1, -(-sk // bk))
    covered = np.zeros(num_q_tiles, dtype=bool)
    for s in range(len(qr)):
        qs, qe = int(qr[s, 0]), int(qr[s, 1])
        ks, ke = int(kr[s, 0]), int(kr[s, 1])
        lo, hi = int(d_lo[s]), int(d_hi[s])
        if qs >= qe or ks >= ke or lo > hi:
            continue
        t = np.arange(qs // bq, (qe - 1) // bq + 1, dtype=np.int64)
        i0 = np.maximum(qs, t * bq)  # clipped row span per q tile
        i1 = np.minimum(qe, (t + 1) * bq)
        # attended column window of the clipped rows, clipped to [ks, ke)
        j0 = np.maximum(ks, i0 + lo)
        j1 = np.minimum(ke - 1, (i1 - 1) + hi)
        nonempty = j0 <= j1
        kt0 = np.clip(j0 // bk, 0, num_k_tiles - 1)
        kt1 = np.clip(j1 // bk, 0, num_k_tiles - 1)
        total += int(np.sum((kt1 - kt0 + 1)[nonempty]))
        covered[t[nonempty]] = True
    return total + int(num_q_tiles - covered.sum())


def count_ffa_work_t(qr, kr, d_lo, d_hi, sq: int, sk: int, bq: int, bk: int) -> int:
    """Exact k-major work-item count (the dk/dv pass's items):
    :func:`count_ffa_work` with the roles of q and k swapped, plus one
    dummy item per k tile no slice reaches. The JAX package's
    ``count_ffa_work_t``, line for line."""
    total = 0
    num_q_tiles = max(1, -(-sq // bq))
    num_k_tiles = max(1, -(-sk // bk))
    covered = np.zeros(num_k_tiles, dtype=bool)
    for s in range(len(qr)):
        qs, qe = int(qr[s, 0]), int(qr[s, 1])
        ks, ke = int(kr[s, 0]), int(kr[s, 1])
        lo, hi = int(d_lo[s]), int(d_hi[s])
        if qs >= qe or ks >= ke or lo > hi:
            continue
        t = np.arange(ks // bk, (ke - 1) // bk + 1, dtype=np.int64)
        j0 = np.maximum(ks, t * bk)  # clipped col span per k tile
        j1 = np.minimum(ke, (t + 1) * bk)
        # attended row window of the clipped cols (j - hi <= i <= j - lo)
        i0 = np.maximum(qs, j0 - hi)
        i1 = np.minimum(qe - 1, (j1 - 1) - lo)
        nonempty = i0 <= i1
        qt0 = np.clip(i0 // bq, 0, num_q_tiles - 1)
        qt1 = np.clip(i1 // bq, 0, num_q_tiles - 1)
        total += int(np.sum((qt1 - qt0 + 1)[nonempty]))
        covered[t[nonempty]] = True
    return total + int(num_k_tiles - covered.sum())


def choose_blocks_multi(
    rank_geoms: list, sq: int, sk: int, d: int = 128, dv: int = 128, itemsize: int = 2,
    space: TileSpace | None = None,
) -> tuple[int, int]:
    """The forward (bq, bk) minimizing ``max_rank(W) * (bq * bk +
    overhead)`` over a group of per-rank slice sets ``(qr, kr, d_lo,
    d_hi)``, each candidate clamped to the problem and guarded by the
    space's budget; the clamped fallback if every candidate is excluded.
    Arms the ``vmem_check`` injection site (the budget guard)."""
    maybe_inject("vmem_check")
    space = space or hopper_space()
    seen: set[tuple[int, int]] = set()
    best = best_score = None
    for bq, bk in space.candidates:
        bq, bk = _clamp(space, bq, bk, sq, sk)
        if (bq, bk) in seen:
            continue
        seen.add((bq, bk))
        if not space.fits("fwd", bq, bk, d, dv, itemsize):
            continue
        w = max(count_ffa_work(qr, kr, lo, hi, sq, sk, bq, bk) for qr, kr, lo, hi in rank_geoms)
        score = w * (bq * bk + space.overhead_for(itemsize))
        if best_score is None or score < best_score:
            best, best_score = (bq, bk), score
    chosen = best or _clamp(space, *space.fallback, sq, sk)
    if telemetry.enabled():
        telemetry.record_event(
            "tile_policy",
            mode="fwd_only",
            sq=sq, sk=sk, d=d, dv=dv, itemsize=itemsize,
            num_geoms=len(rank_geoms),
            candidates_scored=len(seen),
            fwd_blocks=list(chosen),
            fallback=best is None,
        )
    return chosen


def choose_blocks(qr, kr, d_lo, d_hi, sq: int, sk: int, d: int, dv: int, itemsize: int = 2,
                  space: TileSpace | None = None) -> tuple[int, int]:
    """Single-slice-set entry of :func:`choose_blocks_multi`."""
    return choose_blocks_multi([(qr, kr, d_lo, d_hi)], sq, sk, d, dv, itemsize, space)


def _band_candidates(rank_geoms: list, sq: int, sk: int, space: TileSpace | None = None):
    """The space's candidates extended with a k tile derived from the
    narrowest band of the slice set (rounded up to the k quantum, within
    [quantum, band_k_max]) at each of the space's band q tiles: a thin band
    wastes padded columns in any wider k tile."""
    space = space or hopper_space()
    widths = []
    for qr, kr, lo, hi in rank_geoms:
        for s in range(len(qr)):
            if qr[s, 0] >= qr[s, 1] or kr[s, 0] >= kr[s, 1]:
                continue
            band = int(hi[s]) - int(lo[s]) + 1
            rect = int(kr[s, 1]) - int(kr[s, 0])
            widths.append(min(max(band, 0), rect))
    if not widths:
        return space.candidates
    quantum = space.quantum_k
    bk_band = min(max(_round_up(min(widths), quantum), quantum), space.band_k_max)
    return space.candidates + tuple((bq, bk_band) for bq in space.band_q)


def choose_blocks_per_pass_multi(
    rank_geoms: list, sq: int, sk: int, d: int = 128, dv: int = 128, itemsize: int = 2,
    space: TileSpace | None = None,
):
    """Per-pass tiles ``(fwd_blocks, dq_blocks, dkv_blocks)``: the forward
    and dq score the q-major item counts, dk/dv the k-major ones, each
    against its own kernel's budget (compiled set); a backward entry is
    None where the forward's pick is that pass's best too (it inherits).
    Under ``space.bwd_divides`` backward candidates must divide the
    forward's padded geometry (the JAX package's gate). Arms the
    ``vmem_check`` injection site (the budget guard)."""
    maybe_inject("vmem_check")
    space = space or hopper_space()
    cands = _band_candidates(rank_geoms, sq, sk, space)

    def score_pass(kind: str, allowed=None):
        seen: set[tuple[int, int]] = set()
        best = best_score = None
        counter = count_ffa_work_t if kind == "dkv" else count_ffa_work
        for bq, bk in cands:
            bq, bk = _clamp(space, bq, bk, sq, sk)
            if (bq, bk) in seen:
                continue
            seen.add((bq, bk))
            if allowed is not None and not allowed(bq, bk):
                continue
            if not space.fits(kind, bq, bk, d, dv, itemsize):
                continue
            w = max(counter(qr, kr, lo, hi, sq, sk, bq, bk) for qr, kr, lo, hi in rank_geoms)
            score = w * (bq * bk + space.overhead_for(itemsize))
            if best_score is None or score < best_score:
                best, best_score = (bq, bk), score
        return best

    fwd = score_pass("fwd") or _clamp(space, *space.fallback, sq, sk)
    allowed = None
    if space.bwd_divides:
        sqp, skp = _round_up(sq, fwd[0]), _round_up(sk, fwd[1])
        allowed = lambda bq, bk: sqp % bq == 0 and skp % bk == 0  # noqa: E731
    dq = score_pass("dq", allowed)
    dkv = score_pass("dkv", allowed)
    dq, dkv = (None if dq == fwd else dq), (None if dkv == fwd else dkv)
    if telemetry.enabled():
        telemetry.record_event(
            "tile_policy",
            mode="per_pass",
            sq=sq, sk=sk, d=d, dv=dv, itemsize=itemsize,
            num_geoms=len(rank_geoms),
            candidates_scored=len(cands),
            fwd_blocks=list(fwd),
            # None = inherit fwd
            dq_blocks=list(dq) if dq else None,
            dkv_blocks=list(dkv) if dkv else None,
        )
    return fwd, dq, dkv


def choose_blocks_per_pass(qr, kr, d_lo, d_hi, sq: int, sk: int, d: int, dv: int,
                           itemsize: int = 2, space: TileSpace | None = None):
    """Single-slice-set entry of :func:`choose_blocks_per_pass_multi`
    (remembered per geometry in the card's space)."""
    def pick():
        return choose_blocks_per_pass_multi([(qr, kr, d_lo, d_hi)], sq, sk, d, dv, itemsize, space)

    if space is not None:
        return pick()
    return _memo("per_pass", (qr, kr, d_lo, d_hi), (sq, sk, d, dv, itemsize), pick)


def reachable_block_space(
    sq: int, sk: int, kind: str = "fwd", d: int = 128, dv: int = 128, itemsize: int = 2,
    space: TileSpace | None = None,
) -> list[tuple[int, int]]:
    """Every (bq, bk) this policy can emit for a pass of ``kind`` ("fwd" |
    "dq" | "dkv") at (sq, sk): the clamped fallback, every clamped
    candidate within the budget, and the band-derived grid (every k tile
    the band rule can produce at each band q tile)."""
    if kind not in ("fwd", "dq", "dkv"):
        raise ValueError(f"kind must be 'fwd'|'dq'|'dkv', got {kind!r}")
    space = space or hopper_space()
    cands = set(space.candidates)
    cands.update(
        (bq, bk) for bq in space.band_q
        for bk in range(space.quantum_k, space.band_k_max + 1, space.quantum_k)
    )
    reach = set()
    for bq, bk in cands:
        bq, bk = _clamp(space, bq, bk, sq, sk)
        if space.fits(kind, bq, bk, d, dv, itemsize):
            reach.add((bq, bk))
    reach.add(_clamp(space, *space.fallback, sq, sk))
    return sorted(reach)


def band_area(qr, kr, d_lo, d_hi) -> int:
    """Exact (i, j) pair count of band slices: rows i in [qs, qe), columns
    j in [ks, ke) with lo <= j - i <= hi (the JAX package's
    ``telemetry/stats.py:band_area``)."""
    total = 0
    for s in range(len(qr)):
        qs, qe = int(qr[s, 0]), int(qr[s, 1])
        ks, ke = int(kr[s, 0]), int(kr[s, 1])
        lo, hi = int(d_lo[s]), int(d_hi[s])
        if qs >= qe or ks >= ke or lo > hi:
            continue
        i = np.arange(qs, qe, dtype=np.int64)
        j0 = np.maximum(ks, i + lo)
        j1 = np.minimum(ke - 1, i + hi)
        total += int(np.maximum(j1 - j0 + 1, 0).sum())
    return total


def slice_cover_tiles(qr, kr, d_lo, d_hi, block_q: int, block_k: int) -> np.ndarray:
    """Per slice, the (q tile, k tile) pairs its band touches (the
    counting core of :func:`count_ffa_work` kept per slice, without the
    dummy items)."""
    n = len(qr)
    tiles = np.zeros(n, dtype=np.int64)
    for s in range(n):
        qs, qe = int(qr[s, 0]), int(qr[s, 1])
        ks, ke = int(kr[s, 0]), int(kr[s, 1])
        lo, hi = int(d_lo[s]), int(d_hi[s])
        if qs >= qe or ks >= ke or lo > hi:
            continue
        t = np.arange(qs // block_q, (qe - 1) // block_q + 1, dtype=np.int64)
        i0 = np.maximum(qs, t * block_q)
        i1 = np.minimum(qe, (t + 1) * block_q)
        j0 = np.maximum(ks, i0 + lo)
        j1 = np.minimum(ke - 1, (i1 - 1) + hi)
        nonempty = j0 <= j1
        tiles[s] = int(np.sum((j1 // block_k - j0 // block_k + 1)[nonempty]))
    return tiles


def slice_cover_ratios(qr, kr, d_lo, d_hi, block_q: int, block_k: int) -> np.ndarray:
    """Per slice, padded tile-cover elements over band elements at this
    tiling (1.0: the tiles fit the band; empty slices 1.0)."""
    n = len(qr)
    tiles = slice_cover_tiles(qr, kr, d_lo, d_hi, block_q, block_k)
    ratios = np.ones(n, dtype=np.float64)
    for s in range(n):
        if tiles[s] <= 0:
            continue
        band = band_area(qr[s:s + 1], kr[s:s + 1], d_lo[s:s + 1], d_hi[s:s + 1])
        if band <= 0:
            continue
        ratios[s] = int(tiles[s]) * block_q * block_k / band
    return ratios


@dataclass(frozen=True)
class MixedDispatch:
    """A profitable two-pass split of one slice set."""

    dense_idx: np.ndarray  # slice indices of the coarse-tile pass
    frag_idx: np.ndarray  # slice indices of the fine-tile pass
    coarse_blocks: tuple[int, int]
    fine_blocks: tuple[int, int]
    single_score: float  # modeled cost of the coarse tiles over every slice
    split_score: float  # modeled cost of the split, the merge included


def choose_mixed_dispatch(
    qr, kr, d_lo, d_hi, sq: int, sk: int, d: int = 128, dv: int = 128, itemsize: int = 2,
    coarse_blocks: tuple[int, int] | None = None, space: TileSpace | None = None,
) -> MixedDispatch | None:
    """Split the slice set into a coarse-tile pass over its dense slices
    and a fine-tile pass over its fragmented ones (cover ratio >=
    :data:`FRAG_THRESHOLD` at the coarse tiles), merged by lse; or None
    (one plan). Through the backend registry's ``ffa_dispatch`` decision: a
    'single' pin returns None, a 'mixed' pin skips the profitability test
    (it still returns None where the partition is trivial or the fine
    tiles equal the coarse ones); unpinned, the heuristic is the cost
    model: split when score(coarse on dense) + score(fine on fragmented) +
    ``sq * merge_per_row`` < score(coarse on everything), score = band-
    touching tiles * bq * bk + items * overhead. Unpinned, a geometry
    where that test cannot pass (:func:`_single_always_wins`: bf16 on the
    card) returns None before any hashing or scoring."""
    pin = env_backend.mixed_blocks_pin()
    if pin == "single" or len(qr) < 2:
        return None
    if pin is None and _single_always_wins(space or hopper_space(), itemsize, coarse_blocks, sq, sk):
        return None
    if space is None:  # the card's space: remembered per geometry and pin
        args = (sq, sk, d, dv, itemsize, coarse_blocks, pin)
        return _memo("mixed", (qr, kr, d_lo, d_hi), args, lambda: _choose_mixed(
            qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize, coarse_blocks, hopper_space(), pin,
        ))
    return _choose_mixed(qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize, coarse_blocks, space, pin)


def _single_always_wins(space: TileSpace, itemsize: int, coarse_blocks, sq: int, sk: int) -> bool:
    """Whether the cost model rejects every split before it is scored: with
    no per-item overhead the score is the padded cover area, which the
    quantum pair minimizes slice by slice (each tile of a candidate whose
    sides are multiples of the quanta is a union of quantum tiles, and a
    quantum tile the band meets lies in a candidate tile it meets), so with
    coarse tiles at the quanta the fine pass covers its slices with no less
    area than the coarse one and the merge only adds (bf16 on the card)."""
    coarse = coarse_blocks or _clamp(space, *space.fallback, sq, sk)
    return (
        space.overhead_for(itemsize) == 0 and space.merge_for(itemsize) > 0
        and tuple(coarse) == (space.quantum_q, space.quantum_k)
        and all(bq % space.quantum_q == 0 and bk % space.quantum_k == 0 for bq, bk in space.candidates)
    )


def _choose_mixed(qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize, coarse_blocks, space, pin):
    coarse = coarse_blocks or _clamp(space, *space.fallback, sq, sk)
    ratios = slice_cover_ratios(qr, kr, d_lo, d_hi, coarse[0], coarse[1])
    frag = ratios >= FRAG_THRESHOLD
    frag_idx, dense_idx = np.nonzero(frag)[0], np.nonzero(~frag)[0]
    if len(frag_idx) == 0 or len(dense_idx) == 0:
        return None
    fi = frag_idx
    fine = choose_blocks(qr[fi], kr[fi], d_lo[fi], d_hi[fi], sq, sk, d, dv, itemsize, space)
    if fine == coarse:
        return None

    def score(idx: np.ndarray, blocks: tuple[int, int]) -> float:
        w = count_ffa_work(qr[idx], kr[idx], d_lo[idx], d_hi[idx], sq, sk, *blocks)
        tiles = int(slice_cover_tiles(qr[idx], kr[idx], d_lo[idx], d_hi[idx], *blocks).sum())
        return tiles * blocks[0] * blocks[1] + w * space.overhead_for(itemsize)

    single = score(np.arange(len(qr)), coarse)
    split = score(dense_idx, coarse) + score(frag_idx, fine) + sq * space.merge_for(itemsize)
    if pin == "mixed":
        choice = "mixed"
    else:
        key = _mixed_dispatch_key(qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize, coarse) + (
            fine, space.overhead_for(itemsize), space.merge_for(itemsize),
        )
        choice = _registry.resolve(
            "ffa_dispatch", key, lambda: "mixed" if split < single else "single",
        ).name
    if choice != "mixed":
        return None
    result = MixedDispatch(
        dense_idx=dense_idx, frag_idx=frag_idx, coarse_blocks=coarse, fine_blocks=fine,
        single_score=single, split_score=split,
    )
    if telemetry.enabled():
        telemetry.record_event(
            "mixed_dispatch",
            num_slices=len(qr),
            num_dense=len(dense_idx),
            num_frag=len(frag_idx),
            coarse_blocks=list(coarse),
            fine_blocks=list(fine),
            single_score=single,
            split_score=split,
            forced=not split < single,
        )
    return result


def _mixed_dispatch_key(qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize, coarse) -> tuple:
    """Registry key of one mixed-dispatch decision: a digest of the slice
    geometry plus the static dims the cost model reads."""
    h = hashlib.md5()
    for arr in (qr, kr, d_lo, d_hi):
        h.update(np.ascontiguousarray(arr).tobytes())
    return (h.hexdigest()[:16], sq, sk, d, dv, itemsize, coarse[0], coarse[1])


# ---------------------------------------------------------------------------
# backward mode: fused one-pass vs split dq + dk/dv
# ---------------------------------------------------------------------------

# the card: NVIDIA H100 SXM data sheet
NUM_SMS = 132
HBM_BYTES_PER_S = 3.35e12

# The CUDA-core kernels (float32), measured on NVIDIA H100 80GB HBM3,
# 700.00 W (chip_smoke.py phase bwd_mode, in a run where bf16 took them
# too): microseconds one CTA spends per (work item, q head) at head_dim
# 128 in each kernel's loop (dq packed: per head of its block).
ITEM_US = {"dq": 11.50, "dq_gqa": 11.73, "dkv": 15.27}
# the fused kernel's per-(item, head) body, 5/4 of the dk/dv kernel's (one
# more 64 x 64 x d product of the same shape)
FUSED_BODY_OVER_DKV = 1.25
# float32 atomic adds per second the fused kernel's dq block sustains
ATOMIC_ADDS_PER_S = 4.45e11
# The tensor-core kernels (bf16: csrc/ffa_bwd_dq_tc.cuh for dq and
# dq_gqa, csrc/bwd_kv_tc.cuh for dkv and fused), measured on NVIDIA H100
# 80GB HBM3, 700.00 W (chip_smoke.py phase bwd_mode, calibrate_tc over the
# four bf16 masks; dq_gqa over the two that time it): microseconds one CTA
# spends per (work item, q head) at head_dim 128, the fused kernel's dq
# atomics included (dq_gqa: per head of its block of 2).
TC_ITEM_US = {"dq": 0.9092, "dq_gqa": 1.0122, "dkv": 2.8878, "fused": 5.121}
# CTAs of each tensor-core kernel one SM runs at once, from its shared
# memory at head_dim 128 (dq 99,328 bytes, dq_gqa 132,096, dkv 100,352,
# fused 108,544; 227 KB a CTA at most, 228 KB an SM): its per-item time is
# a CTA's while it shares the SM. A lone long run (the sink window's 516
# steps) is slower than that pace: the model is 4-23% under it there.
TC_CTAS_PER_SM = {"dq": 2, "dq_gqa": 1, "dkv": 2, "fused": 2}
# The 256-wide instances: per (item, head) each body's products over the
# full head dim (S, dP: recomputed by both column halves) and over its half
# (the outputs; the tensor-core dk/dv products are hi + lo pairs), for
# :func:`width_scale`.
TC_PRODUCTS = {"dq": (2, 1), "dq_gqa": (2, 1), "dkv": (2, 4), "fused": (2, 5)}
FMA_PRODUCTS = {"dq": (2, 1), "dq_gqa": (2, 1), "dkv": (2, 2), "fused": (2, 3)}


def width_scale(d: int, products: tuple[int, int]) -> float:
    """One CTA's per-(item, head) time at head dim d over its time at 128:
    d / 128 up to 128; above, its (full-width, half-width) ``products``
    at d and at the 128-column half, over all of them at 128."""
    if d <= SPLIT_WIDTH:
        return d / 128.0
    full, half = products
    return (full * d + half * SPLIT_WIDTH) / ((full + half) * 128.0)


@dataclass(frozen=True)
class BwdShape:
    """What the model reads of one backward: real (non-dummy) items per
    q-major run (the dq pass's plan, at tiles ``block_q`` x ``block_k``)
    and per k-major run (the dk/dv pass's, at ``block_q_dkv`` x
    ``block_k_dkv``, 0: the dq pass's), heads and head dims."""

    items_q: np.ndarray  # (num_q_tiles,) real items of each q-major run
    items_k: np.ndarray  # (num_k_tiles,) real items of each k-major run
    block_q: int
    block_k: int
    hq: int
    hk: int
    d: int
    dv: int
    itemsize: int
    block_q_dkv: int = 0
    block_k_dkv: int = 0

    def dkv_blocks(self) -> tuple[int, int]:
        return self.block_q_dkv or self.block_q, self.block_k_dkv or self.block_k


def tile_area(s: "BwdShape", kernel: str) -> float:
    """One item's area over a 64 x 64 item's, for the pass ``kernel``
    runs: the measured per-item times are 64 x 64 ones."""
    bq, bk = (s.block_q, s.block_k) if kernel in ("dq", "dq_gqa") else s.dkv_blocks()
    return bq * bk / 4096.0


def makespan(cta_work: np.ndarray, slots: int = NUM_SMS) -> float:
    """Finish time of CTAs of the given work, dealt in launch order to
    ``slots`` slots, each CTA to the slot that frees first."""
    work = np.asarray(cta_work, dtype=np.float64)
    if len(work) <= slots:
        return float(work.max(initial=0.0))
    free = [0.0] * slots
    for w in work.tolist():
        heapq.heapreplace(free, free[0] + w)
    return max(free)


def _ctas(items: np.ndarray, heads: int, heads_per_cta: int, reverse: bool) -> np.ndarray:
    """Per-CTA (item, head) work in launch order: grid x over the runs
    (last first when ``reverse``, as the q-major kernels take them), y
    over the head blocks."""
    runs = items[::-1] if reverse else items
    return np.tile(runs * heads_per_cta, heads // heads_per_cta)


def _halves(s: "BwdShape") -> int:
    return column_halves(max(s.d, s.dv))


def kernel_units(
    s: BwdShape, dq_heads_per_cta: int = 1, kv_slots: int = NUM_SMS,
    dq_slots: int = NUM_SMS,
) -> dict[str, float]:
    """Makespans in (item, head) units: the dq kernel over the q-major runs
    (one CTA per (run, block of ``dq_heads_per_cta`` heads), last run
    first, on ``dq_slots`` slots) and the k-major kernels (dk/dv and fused:
    one CTA per (run, kv head) looping the group, first run first, on
    ``kv_slots`` slots)."""
    g, n = s.hq // s.hk, _halves(s)  # grid z: the column halves
    return {
        "dq": makespan(np.tile(_ctas(s.items_q, s.hq, dq_heads_per_cta, True), n), dq_slots),
        "kv": makespan(np.tile(_ctas(s.items_k, s.hk, 1, False) * g, n), kv_slots),
    }


def _dq_key(dq_heads_per_cta: int) -> str:
    return "dq_gqa" if dq_heads_per_cta > 1 else "dq"


def _tc_units(s: BwdShape, kernel: str, dq_heads_per_cta: int = 1) -> float:
    """A tensor-core kernel's makespan in (item, head) units ("dq",
    "dq_gqa", "dkv" or "fused"), its CTAs dealt to its
    :data:`TC_CTAS_PER_SM` slots per SM (one at 256)."""
    bq, bk = (s.block_q, s.block_k) if kernel in ("dq", "dq_gqa") else s.dkv_blocks()
    if _halves(s) > 1:
        per_sm = 1
    elif (bq, bk) == mem_budget.DEFAULT_TILES:
        per_sm = TC_CTAS_PER_SM[kernel]
    else:  # other tiles: from their shared memory and warpgroups
        per_sm = mem_budget.ctas_per_sm(kernel, max(s.d, s.dv), bq, bk, dq_heads_per_cta)
    slots = NUM_SMS * per_sm
    if kernel in ("dq", "dq_gqa"):
        return kernel_units(s, dq_heads_per_cta, dq_slots=slots)["dq"]
    return kernel_units(s, kv_slots=slots)["kv"]


def dram_bytes(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Bytes each kernel streams from and to device memory: per CTA the
    run tile's resident operands and its outputs, per (item, head) the
    streamed operands (K/V for dq, once per head block; Q/dO with lse and
    delta for the k-major kernels), and the fused dq workspace about once
    per pass (zeroed, written back, read and written by the convert)."""
    isz, bq, bk, d, dv = s.itemsize, s.block_q, s.block_k, s.d, s.dv
    bq_kv, bk_kv = s.dkv_blocks()
    n_q, n_k, n = len(s.items_q), len(s.items_k), _halves(s)  # each half reads all
    kv = (
        n_k * s.hk * bk_kv * (d + dv) * (n * isz + 4)  # K, V in; dk, dv out
        + n * float(s.items_k.sum()) * s.hq * bq_kv * ((d + dv) * isz + 2 * 4)  # Q, dO, lse, delta
    )
    return {
        "dq": n_q * s.hq * bq * ((d + dv) * n * isz + 2 * 4 * n + d * 4)  # Q, dO, stats; dq
        + n * float(s.items_q.sum()) * (s.hq // dq_heads_per_cta) * bk * (d + dv) * isz,  # K, V
        "dkv": kv,
        "fused": kv + 4 * n_q * bq * s.hq * d * 4,  # the dq workspace
    }


def atomic_adds(s: BwdShape) -> float:
    """The fused kernel's float32 adds into the dq workspace: one 64 x d
    block per (real item, q head)."""
    return float(s.items_k.sum()) * s.hq * s.dkv_blocks()[0] * s.d


def dtype_body(s: BwdShape) -> str:
    """The backward kernels' body for the backward's dtype: "tc" (bf16, the
    tensor cores) or "fma" (float32, the CUDA cores)."""
    return "tc" if s.itemsize == 2 else "fma"


def _with_dram(s: BwdShape, dq_heads_per_cta: int, compute: dict[str, float]) -> dict[str, float]:
    nbytes = dram_bytes(s, dq_heads_per_cta)
    return {k: compute[k] + nbytes[k] / HBM_BYTES_PER_S * 1e3 for k in compute}


def fma_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of each backward kernel in its CUDA-core body
    (float32 FMA; the one float32 runs)."""
    units = kernel_units(s, dq_heads_per_cta)
    dq, d = _dq_key(dq_heads_per_cta), max(s.d, s.dv)
    return _with_dram(s, dq_heads_per_cta, {
        "dq": units["dq"] * ITEM_US[dq] * width_scale(d, FMA_PRODUCTS[dq]) * 1e-3,
        "dkv": units["kv"] * ITEM_US["dkv"] * width_scale(d, FMA_PRODUCTS["dkv"]) * 1e-3,
        "fused": units["kv"] * FUSED_BODY_OVER_DKV * ITEM_US["dkv"]
        * width_scale(d, FMA_PRODUCTS["fused"]) * 1e-3
        + atomic_adds(s) / ATOMIC_ADDS_PER_S * 1e3,
    })


def tc_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of each backward kernel in its tensor-core body
    (the one bf16 runs)."""
    dq, d = _dq_key(dq_heads_per_cta), max(s.d, s.dv)
    units = {
        "dq": _tc_units(s, dq, dq_heads_per_cta) * TC_ITEM_US[dq],
        "dkv": _tc_units(s, "dkv") * TC_ITEM_US["dkv"],
        "fused": _tc_units(s, "fused") * TC_ITEM_US["fused"],
    }
    kern = {"dq": dq, "dkv": "dkv", "fused": "fused"}
    return _with_dram(s, dq_heads_per_cta, {
        k: us * width_scale(d, TC_PRODUCTS[kern[k]]) * tile_area(s, kern[k]) * 1e-3
        for k, us in units.items()
    })


def kernel_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of each backward kernel on one backward, in the
    dtype's body (:func:`dtype_body`)."""
    return (tc_ms if dtype_body(s) == "tc" else fma_ms)(s, dq_heads_per_cta)


def bwd_mode_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of the split pair (dq, then dk/dv) and of the
    fused kernel on one backward."""
    t = kernel_ms(s, dq_heads_per_cta)
    return {"split": t["dq"] + t["dkv"], "fused": t["fused"]}


def calibrate(s: BwdShape, ms: dict[str, float], dq_heads_per_cta: int = 1) -> dict[str, float]:
    """The constants that make the model reproduce measured kernel times
    ``ms`` ("dq", "dkv", "fused") at one shape: per-(item, head)
    microseconds at head_dim 128 after the DRAM time, and the atomic rate
    from the fused time less its body (5/4 of the dk/dv time) and DRAM."""
    units = kernel_units(s, dq_heads_per_cta)
    nbytes = dram_bytes(s, dq_heads_per_cta)
    per_128 = 128.0 / s.d

    def item_us(kernel, unit):
        return (ms[kernel] - nbytes[kernel] / HBM_BYTES_PER_S * 1e3) * 1e3 / units[unit] * per_128

    dkv_us = item_us("dkv", "kv")
    body_ms = units["kv"] * FUSED_BODY_OVER_DKV * dkv_us / per_128 * 1e-3
    rest_ms = ms["fused"] - body_ms - nbytes["fused"] / HBM_BYTES_PER_S * 1e3
    return {
        "dq_gqa" if dq_heads_per_cta > 1 else "dq": item_us("dq", "dq"),
        "dkv": dkv_us,
        "atomic_adds_per_s": atomic_adds(s) / (rest_ms * 1e-3) if rest_ms > 0 else float("inf"),
    }


def calibrate_tc(
    kernel: str, shapes: list[BwdShape], ms: list[float], dq_heads_per_cta: int = 1
) -> float:
    """A tensor-core kernel's ("dq", "dq_gqa", "dkv" or "fused")
    per-(item, head) microseconds at head_dim 128 from its measured times
    ``ms`` at several shapes: least squares of (time - DRAM time) over its
    makespan in (item, head) units on its :data:`TC_CTAS_PER_SM` slots per
    SM (dq_gqa: ``dq_heads_per_cta`` heads a CTA)."""
    heads = dq_heads_per_cta if kernel == "dq_gqa" else 1
    dram = "dq" if kernel == "dq_gqa" else kernel
    units = np.asarray([_tc_units(s, kernel, heads) * s.d / 128.0 * 1e-3 for s in shapes])
    rest = np.asarray([
        t - dram_bytes(s, heads)[dram] / HBM_BYTES_PER_S * 1e3 for s, t in zip(shapes, ms)
    ])
    return float(np.dot(units, rest) / np.dot(units, units))


def choose_bwd_mode(s: BwdShape, dq_heads_per_cta: int = 1) -> str:
    """"fused" or "split", whichever the model times faster (fused on a
    tie). Fused does 5 tile products per (item, head) where split does 7
    (tensor cores: 7 executed, with the lo products, against 9), so it
    wins whenever its k-major runs spread over the card about as well as
    the q-major ones; split wins when one k-major run is far longer than
    the rest and holds the fused kernel back (its dk/dv kernel, lighter
    per item, waits on that run less). Feasibility
    (shared memory and registers, plan meta columns) and the pins are the
    caller's job (kernels/ffa.ffa_bwd_mode)."""
    t = bwd_mode_ms(s, dq_heads_per_cta)
    return "fused" if t["fused"] <= t["split"] else "split"
