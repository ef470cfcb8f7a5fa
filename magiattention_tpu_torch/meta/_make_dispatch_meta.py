"""Dispatch meta construction (ref: magi_attention/meta/_make_dispatch_meta.py:56-405).

The port's copy of ``magiattention_tpu/meta/_make_dispatch_meta.py`` (numpy only, imports
rewired).

Chunks the global sequence, computes per-chunk attention areas from the slice
metadata (the global AttnBucket), runs the DispatchSolver, and emits the
DispatchMeta with permutation indices.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import telemetry
from ..common.enum import AttnMaskType, AttnType, DispatchAlgType
from ..common.range import AttnRange
from ..common.ranges import AttnRanges
from .collection.dispatch_meta import DispatchMeta
from .container.bucket import AttnBucket, AttnChunk
from .container.slice import AttnSlice
from .solver.dispatch_solver import (
    DispatchConfig,
    DispatchSolution,
    DispatchSolver,
    normalize_capacities,
)
from ..env.general import is_cpp_backend_enable
from ..utils.profiling import instrument_host

_logger = logging.getLogger("magiattention_tpu.dispatch")


def make_global_bucket_from_qk_ranges(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    attn_mask_type: list[AttnMaskType],
    total_seqlen_q: int,
    chunk_size: int,
) -> AttnBucket:
    """Per-chunk slice lists + areas (ref: _make_dispatch_meta.py:450).

    Each global slice is clipped to every chunk it intersects; band encoding
    keeps the clip exact (no type re-derivation).
    """
    num_chunks = -(-total_seqlen_q // chunk_size)
    chunks = [
        AttnChunk(
            chunk_id=c,
            q_range=AttnRange(
                c * chunk_size, min((c + 1) * chunk_size, total_seqlen_q)
            ),
        )
        for c in range(num_chunks)
    ]
    slices = [
        AttnSlice.from_mask_type(qr, kr, AttnMaskType.normalize(mt))
        for qr, kr, mt in zip(q_ranges, k_ranges, attn_mask_type)
    ]
    for s in slices:
        if s.q_range.is_empty():
            continue
        c_lo = s.q_range.start // chunk_size
        c_hi = -(-s.q_range.end // chunk_size)
        for c in range(c_lo, min(c_hi, num_chunks)):
            clipped = s.clip_q(chunks[c].q_range.start, chunks[c].q_range.end)
            if not clipped.q_range.is_empty() and clipped.area > 0:
                chunks[c].attn_slices.append(clipped)
    return AttnBucket(cp_rank=None, q_chunks=chunks)


def _solve_partitions_with_alg(
    bucket: AttnBucket,
    areas: list[int],
    cp_size: int,
    num_chunks: int,
    dispatch_config: DispatchConfig,
    alg: DispatchAlgType,
) -> list[list[int]]:
    """Chunk->rank partitions under one concrete algorithm (the equal-count
    min-heap solve in the native host backend under
    MAGI_ATTENTION_CPP_BACKEND=1 where it builds, as the JAX package
    solves it; the same partitions)."""
    if (
        alg == DispatchAlgType.MIN_HEAP
        and not dispatch_config.uneven_shard
        and is_cpp_backend_enable()
    ):
        try:  # csrc/magi_host.cpp magi_minheap_solve
            from ..csrc_backend.ops import minheap_solve_native

            return [
                sorted(p)
                for p in minheap_solve_native(
                    np.asarray(areas, dtype=np.int64), cp_size, num_chunks // cp_size,
                )
            ]
        except ImportError:
            pass
    solver = DispatchSolver(alg=alg, config=dispatch_config)
    affinities = None
    if alg in (
        DispatchAlgType.TOPP_HEAP,
        DispatchAlgType.BATCH_TOPP_HEAP,
    ) and not dispatch_config.uneven_shard:
        # (the uneven solve path balances by pure LPT and does not
        # consume affinities)
        # IOU affinity: each chunk's kv coverage — co-locating
        # overlapping coverage deduplicates GroupCast volume
        from .solver.dispatch_solver import IOUAffinity

        affinities = [
            IOUAffinity.from_ranges(
                AttnRanges(
                    [AttnRange(s.k_range.start, s.k_range.end)
                     for s in chunk.attn_slices]
                )
            )
            for chunk in bucket.q_chunks
        ]
    return solver.solve(areas, cp_size, affinities=affinities).partitions


def _solve_weighted_partitions(
    areas: list[int],
    cp_size: int,
    dispatch_config: DispatchConfig,
    caps: tuple[float, ...],
) -> DispatchSolution | None:
    """Capacity-weighted solve. Always the weighted LPT — it bypasses AUTO,
    which solves the equal-count uniform problem. The ``weighted_solve``
    chaos site covers this path: an injected fault degrades to the uniform
    all-ones solve (returns None) when fallback is enabled, else propagates
    typed."""
    from ..resilience.inject import maybe_inject

    try:
        maybe_inject("weighted_solve")
    except Exception as e:
        from ..resilience.errors import InjectedFault

        if not isinstance(e, InjectedFault):
            raise
        from ..env import resilience as env_resilience

        if not env_resilience.is_fallback_enable():
            raise
        from ..resilience.fallback import record_resilience_event

        record_resilience_event(
            "fallback", "weighted_solve",
            action_detail="uniform_solve", error=type(e).__name__,
        )
        return None
    solver = DispatchSolver(alg=dispatch_config.alg, config=dispatch_config)
    return solver.solve(areas, cp_size, capacities=caps)


def estimate_remote_rows_per_rank(
    bucket: AttnBucket,
    partitions: list[list[int]],
    kv_own_ranges: list[AttnRanges] | None = None,
) -> list[int]:
    """Per-rank remote-KV row estimate for a candidate chunk assignment.

    For each rank: the union of its chunks' band-effective k coverage
    (AttnSlice.needed_k_range), minus the KV rows the rank itself owns.
    Ownership defaults to the rank's own q ranges (self-attention: kv
    follows the q assignment); cross-attention callers pass the sequential
    kv shard ownership via ``kv_own_ranges``. This is the GroupCast payload
    the dist_attn_solver will plan, estimated without running the solver —
    cheap enough to evaluate several candidate dispatches.
    """
    out = []
    for r, part in enumerate(partitions):
        if kv_own_ranges is not None:
            own = kv_own_ranges[r]
        else:
            own = AttnRanges(
                [bucket.q_chunks[c].q_range for c in part]
            ).merge()
        need = AttnRanges(
            [
                s.needed_k_range()
                for c in part
                for s in bucket.q_chunks[c].attn_slices
            ]
        ).merge()
        out.append(need.total_seqlen - need.intersect_size_with(own))
    return out


def _auto_select_partitions(
    bucket: AttnBucket,
    areas: list[int],
    cp_size: int,
    num_chunks: int,
    dispatch_config: DispatchConfig,
    kv_own_ranges: list[AttnRanges] | None = None,
) -> tuple[list[list[int]], DispatchAlgType]:
    """AUTO dispatch: pick the algorithm by a modeled compute/comm cost.

    This build's addition (the reference leaves the algorithm to the user,
    dispatch_solver.py:359). Rationale: the best algorithm depends on the
    mask — MIN_HEAP perfectly balances area but scatters chunks, which on
    *local* masks (sliding-window, block-local video) inflates remote-KV
    volume by an order of magnitude over SEQUENTIAL, whose balance on those
    masks is already near-perfect (see benchmarks/comm_volume_report.py).

    Model: rank busy-time = max(area_r, comm_area_per_row * remote_rows_r)
    (comm overlaps compute in the multi-stage runtime); mesh cost = max over
    ranks. A candidate replaces the incumbent when it is clearly cheaper
    (rel. auto_tol), or stays within tolerance *of the cheapest cost seen*
    and moves fewer total rows (anchoring to the minimum prevents the
    tolerance from ratcheting across candidates).
    """
    candidates = [
        DispatchAlgType.MIN_HEAP,
        DispatchAlgType.TOPP_HEAP,
        DispatchAlgType.SEQUENTIAL_SELECT,
    ]
    lam = dispatch_config.auto_comm_area_per_row
    tol = dispatch_config.auto_tol
    best = None  # (cost, total_rows, partitions, alg)
    min_cost = None
    seen: set[tuple] = set()
    for alg in candidates:
        parts = _solve_partitions_with_alg(
            bucket, areas, cp_size, num_chunks, dispatch_config, alg
        )
        # under uneven_shard several candidates collapse to the same LPT
        # partition — don't estimate (or "select") duplicates
        sig = tuple(tuple(p) for p in parts)
        if sig in seen:
            continue
        seen.add(sig)
        remote = estimate_remote_rows_per_rank(
            bucket, parts, kv_own_ranges=kv_own_ranges
        )
        rank_area = [sum(areas[c] for c in p) for p in parts]
        cost = max(
            max(a, lam * r) for a, r in zip(rank_area, remote)
        )
        rows = sum(remote)
        min_cost = cost if min_cost is None else min(min_cost, cost)
        if (
            best is None
            or cost < best[0] * (1 - tol)
            or (cost <= min_cost * (1 + tol) and rows < best[1])
        ):
            best = (cost, rows, parts, alg)
    assert best is not None  # MIN_HEAP always solves
    _logger.info(
        "AUTO dispatch chose %s (modeled cost %.3g, est. remote rows %d)",
        best[3].value, best[0], best[1],
    )
    return best[2], best[3]


@instrument_host
def make_dispatch_meta_from_qk_ranges(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    attn_mask_type: list[AttnMaskType],
    total_seqlen_q: int,
    total_seqlen_k: int,
    chunk_size: int,
    cp_size: int,
    dispatch_config: DispatchConfig | None = None,
    preset_partitions: list[list[int]] | None = None,
    capacities: list[float] | None = None,
) -> tuple[DispatchMeta, DispatchMeta, AttnBucket]:
    """Build (q_meta, kv_meta, global_bucket) for self-attention.

    For self-attention q and kv share the same chunk assignment (the reference
    dispatches q/o and k/v with the same DispatchMeta for SELF_ATTN).
    """
    if total_seqlen_q % chunk_size != 0:
        raise ValueError(
            f"total_seqlen_q {total_seqlen_q} not divisible by chunk_size "
            f"{chunk_size}; pad the sequence first"
        )
    dispatch_config = dispatch_config or DispatchConfig()
    num_chunks = total_seqlen_q // chunk_size
    if not dispatch_config.uneven_shard and num_chunks % cp_size != 0:
        raise ValueError(
            f"num_chunks {num_chunks} not divisible by cp_size {cp_size} "
            f"(use DispatchConfig(uneven_shard=True) or pad)"
        )
    bucket = make_global_bucket_from_qk_ranges(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, chunk_size
    )
    areas = bucket.areas_per_chunk

    chosen_alg = dispatch_config.alg
    weighted_sol: DispatchSolution | None = None
    caps = normalize_capacities(capacities, cp_size)
    if caps is not None and preset_partitions is None and cp_size > 1:
        weighted_sol = _solve_weighted_partitions(
            areas, cp_size, dispatch_config, caps
        )
        if weighted_sol is None:
            caps = None  # chaos degraded: uniform all-ones plan

    if preset_partitions is not None:
        # re-keying after dispatch: reuse a prior dispatch solution for a
        # new mask (ref api :1172) — no balance guarantee for the new mask
        partitions = [sorted(p) for p in preset_partitions]
        chosen_alg = None
    elif cp_size == 1:
        partitions = [list(range(num_chunks))]
        chosen_alg = None
    elif weighted_sol is not None:
        partitions = weighted_sol.partitions
        chosen_alg = None
    elif dispatch_config.alg == DispatchAlgType.AUTO:
        kv_own = None
        if total_seqlen_k != total_seqlen_q:
            # cross-attn: kv ownership is the sequential even shard in
            # k-space (see meta_kv below), not the rank's q ranges
            if total_seqlen_k % cp_size != 0:
                raise ValueError(
                    f"total_seqlen_k {total_seqlen_k} not divisible by "
                    f"cp_size"
                )
            sz = total_seqlen_k // cp_size
            kv_own = [
                AttnRanges([AttnRange(r * sz, (r + 1) * sz)])
                for r in range(cp_size)
            ]
        partitions, chosen_alg = _auto_select_partitions(
            bucket, areas, cp_size, num_chunks, dispatch_config,
            kv_own_ranges=kv_own,
        )
    else:
        partitions = _solve_partitions_with_alg(
            bucket, areas, cp_size, num_chunks, dispatch_config,
            dispatch_config.alg,
        )

    if telemetry.enabled():
        # the CHOSEN assignment (the dispatch_solve kinds above are per
        # candidate/algorithm; the native minheap path bypasses them)
        per_rank = [sum(areas[c] for c in p) for p in partitions]
        max_area = max(per_rank, default=0)
        lb = max(
            -(-sum(areas) // cp_size), max(areas, default=0)
        ) if areas else 0
        extra = {}
        if weighted_sol is not None:
            extra = {
                "capacities": list(weighted_sol.capacities or ()),
                "weighted_makespan": weighted_sol.weighted_makespan,
                "weighted_lower_bound": weighted_sol.weighted_lower_bound,
            }
        telemetry.record_event(
            "dispatch_meta",
            alg=(
                chosen_alg.value
                if isinstance(chosen_alg, DispatchAlgType)
                else (
                    "weighted" if weighted_sol is not None
                    else "preset" if preset_partitions is not None
                    else "trivial"
                )
            ),
            total_seqlen_q=total_seqlen_q,
            total_seqlen_k=total_seqlen_k,
            chunk_size=chunk_size,
            num_chunks=num_chunks,
            cp_size=cp_size,
            per_rank_area=per_rank,
            max_area=max_area,
            lower_bound=lb,
            balance_ratio=(
                weighted_sol.balance_ratio if weighted_sol is not None
                else (lb / max_area) if max_area else 1.0
            ),
            **extra,
        )

    is_cross = total_seqlen_k != total_seqlen_q
    meta_q = DispatchMeta(
        attn_type=AttnType.CROSS_ATTN if is_cross else AttnType.SELF_ATTN,
        total_seqlen=total_seqlen_q,
        chunk_size=chunk_size,
        cp_size=cp_size,
        partitions=partitions,
    )
    if is_cross:
        # cross-attn: kv has its own (sequential, evenly chunked) dispatch —
        # kv rows carry no per-row workload of their own
        if total_seqlen_k % cp_size != 0:
            raise ValueError(
                f"total_seqlen_k {total_seqlen_k} not divisible by cp_size"
            )
        meta_kv = DispatchMeta(
            attn_type=AttnType.CROSS_ATTN,
            total_seqlen=total_seqlen_k,
            chunk_size=total_seqlen_k // cp_size,
            cp_size=cp_size,
            partitions=[[r] for r in range(cp_size)],
        )
    else:
        # self-attn: kv follows q's assignment
        meta_kv = meta_q
    return meta_q, meta_kv, bucket
