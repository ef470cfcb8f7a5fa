"""Host-side planning helpers for the CP baselines.

The port's counterpart of ``magiattention_tpu/parallel/_utils.py`` (ref
exps/dist_attn/baselines/shard.py, utils_cp.py): the *global* band-slice
metadata is clipped to each (q block, kv block) pair a rank meets and an
FFA plan is built from each clip. The JAX package stacks every rank's
plans, padded to one shape, into one SPMD program; here each process
builds only its own rank's plans, unpadded, so nothing of
``stack_step_plans`` / ``pad_plan`` is needed. The helpers are numpy and
copied here, so the port imports nothing of the JAX package.

Blocks are :func:`..kernels.ffa.default_blocks` (the kernels' 64 x 64);
the JAX baselines ignore the backward-tile override flags, and the port
has none.
"""

from __future__ import annotations

import numpy as np

from ..kernels.ffa import FFAParams
from ..kernels.ffa_plan import KE, KS, QE, QS, FFAPlan, get_ffa_plan
from ..kernels.mask_utils import BAND_INF, types_to_bands


def band_meta(q_ranges, k_ranges, attn_type_map):
    """Normalize global slice metadata to (qr, kr, d_lo, d_hi) int32 arrays."""
    qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
    tm = np.asarray(attn_type_map, dtype=np.int32).reshape(-1)
    lo, hi = types_to_bands(qr, kr, tm)
    return qr, kr, lo, hi


def zigzag_perm(S: int, cp: int) -> np.ndarray:
    """Global row permutation of zigzag sharding (ref shard.py:486
    generate_zigzag_dispatch_indices): the sequence splits into ``2*cp``
    equal chunks and rank r owns chunks ``r`` and ``2*cp-1-r``, which
    balances a causal mask's area. ``perm[i]`` is the natural row at
    zigzag position ``i``."""
    if S % (2 * cp):
        raise ValueError(f"zigzag needs seqlen % (2*cp) == 0, got {S} % {2 * cp}")
    c = S // (2 * cp)
    order = []
    for r in range(cp):
        order += [r, 2 * cp - 1 - r]
    return np.concatenate([np.arange(ch * c, (ch + 1) * c, dtype=np.int64) for ch in order])


def zigzag_inv_perm(S: int, cp: int) -> np.ndarray:
    """Inverse of :func:`zigzag_perm` (the zigzag position of each natural row)."""
    perm = zigzag_perm(S, cp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return inv


def check_zigzag_geometry(shard: int, n: int) -> None:
    """Each rank owns two equal chunks, so a shard must be even
    (seqlen % (2*n) == 0); an odd one would truncate silently."""
    if shard % 2:
        raise ValueError(
            f"zigzag sharding needs an even per-rank shard "
            f"(seqlen % {2 * n} == 0), got shard={shard}"
        )


def zigzag_segs(rank: int, cp: int, chunk: int) -> list[tuple[int, int, int]]:
    """The two global segments ``rank`` owns under zigzag sharding, as
    ``(gstart, gend, local_offset)``."""
    return [
        (rank * chunk, (rank + 1) * chunk, 0),
        ((2 * cp - 1 - rank) * chunk, (2 * cp - rank) * chunk, chunk),
    ]


def clip_to_segs(q_ranges, k_ranges, d_lo, d_hi, q_segs, k_segs) -> np.ndarray:
    """Clip global band slices to every (q_seg, k_seg) pair of possibly
    non-contiguous ownership, shifted to buffer-local coordinates by each
    segment's local offset. Returns ``(n, 6)`` int64 local slices
    ``(qs, qe, ks, ke, d_lo, d_hi)``."""
    out = []
    for q0, q1, qoff in q_segs:
        for k0, k1, koff in k_segs:
            # local ql = g - q0 + qoff, kl = g - k0 + koff: the band
            # j - i >= lo becomes kl - ql >= lo + (q0 - qoff) - (k0 - koff)
            shift = (q0 - qoff) - (k0 - koff)
            for i in range(len(q_ranges)):
                qs, qe = max(int(q_ranges[i, 0]), q0), min(int(q_ranges[i, 1]), q1)
                ks, ke = max(int(k_ranges[i, 0]), k0), min(int(k_ranges[i, 1]), k1)
                if qs >= qe or ks >= ke:
                    continue
                lo, hi = int(d_lo[i]), int(d_hi[i])
                out.append((
                    qs - q0 + qoff, qe - q0 + qoff, ks - k0 + koff, ke - k0 + koff,
                    lo if lo <= -BAND_INF else lo + shift,
                    hi if hi >= BAND_INF else hi + shift,
                ))
    return np.asarray(out, dtype=np.int64).reshape(-1, 6)


def clip_to_blocks(q_ranges, k_ranges, d_lo, d_hi, q0, q1, k0, k1) -> np.ndarray:
    """Clip global band slices to q rows [q0, q1) x k cols [k0, k1),
    shifted to block-local coordinates: ``(n, 6)`` int64 local slices."""
    return clip_to_segs(q_ranges, k_ranges, d_lo, d_hi, [(q0, q1, 0)], [(k0, k1, 0)])


def block_plan(slices: np.ndarray, sq: int, sk: int, bq: int, bk: int) -> FFAPlan:
    """The (cached) FFA plan of one block pair from clipped ``(n, 6)`` slices."""
    return get_ffa_plan(
        slices[:, 0:2].astype(np.int32), slices[:, 2:4].astype(np.int32),
        slices[:, 4].astype(np.int32), slices[:, 5].astype(np.int32),
        sq, sk, bq, bk,
    )


def ring_step_slices(qr, kr, lo, hi, shard: int, n: int, rank: int, ring_rank_of=None):
    """``slices[step]`` of ``rank`` in an n-rank kv ring over contiguous
    blocks of ``shard`` rows: the kv block visiting at step s came from
    rank ``(rank - s) % n``, or ``ring_rank_of(rank, s)`` (LoongTrain's
    double ring)."""
    out = []
    for s in range(n):
        src = ring_rank_of(rank, s) if ring_rank_of else (rank - s) % n
        out.append(clip_to_blocks(
            qr, kr, lo, hi, rank * shard, (rank + 1) * shard, src * shard, (src + 1) * shard,
        ))
    return out


def zigzag_ring_step_slices(qr, kr, lo, hi, shard: int, n: int, rank: int, ring_rank_of=None):
    """``slices[step]`` of ``rank`` in an n-rank kv ring under zigzag
    sharding: q and the visiting kv buffer each hold their owner's two
    chunks."""
    check_zigzag_geometry(shard, n)
    c = shard // 2
    out = []
    for s in range(n):
        src = ring_rank_of(rank, s) if ring_rank_of else (rank - s) % n
        out.append(clip_to_segs(qr, kr, lo, hi, zigzag_segs(rank, n, c), zigzag_segs(src, n, c)))
    return out


def ring_step_plans(qr, kr, lo, hi, shard, n, bq, bk, rank, ring_rank_of=None) -> list[FFAPlan]:
    """``plans[step]`` of ``rank``'s contiguous ring (:func:`ring_step_slices`)."""
    return [
        block_plan(sl, shard, shard, bq, bk)
        for sl in ring_step_slices(qr, kr, lo, hi, shard, n, rank, ring_rank_of)
    ]


def zigzag_ring_step_plans(qr, kr, lo, hi, shard, n, bq, bk, rank, ring_rank_of=None) -> list[FFAPlan]:
    """``plans[step]`` of ``rank``'s zigzag ring (:func:`zigzag_ring_step_slices`)."""
    return [
        block_plan(sl, shard, shard, bq, bk)
        for sl in zigzag_ring_step_slices(qr, kr, lo, hi, shard, n, rank, ring_rank_of)
    ]


def hybrid_step_slices(qr, kr, lo, hi, S: int, outer: int, inner: int, rank: int):
    """``slices[step]`` of ``rank`` (block ``io*I + ii``) in HybridCP: its
    q block against the super-block of inter rank ``(io - o) % O`` at step
    o (the intra group of ``io`` jointly owns super-block ``io``)."""
    shard, sup = S // (outer * inner), S // outer
    io = rank // inner
    return [
        clip_to_blocks(
            qr, kr, lo, hi, rank * shard, (rank + 1) * shard,
            (io - o) % outer * sup, ((io - o) % outer + 1) * sup,
        )
        for o in range(outer)
    ]


def live_items(plan: FFAPlan) -> int:
    """Work items of a plan that cover rows and keys (a plan of none is
    a part with no work: out 0, lse -inf, no gradient)."""
    m = plan.meta
    return int(np.count_nonzero((m[:, QS] < m[:, QE]) & (m[:, KS] < m[:, KE])))


def baseline_params(plan: FFAPlan, scale: float) -> FFAParams:
    """The FFAParams of one part of a baseline (softcap-free)."""
    return FFAParams(
        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
        block_q=plan.block_q, block_k=plan.block_k,
        softmax_scale=float(scale), softcap=0.0,
    )


def softmax_scale_of(d: int, softmax_scale: float | None) -> float:
    return float(d) ** -0.5 if softmax_scale is None else float(softmax_scale)
