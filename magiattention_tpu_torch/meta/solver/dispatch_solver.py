"""Load-balanced chunk->rank dispatch solver.

The port's copy of ``magiattention_tpu/meta/solver/dispatch_solver.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/solver/dispatch_solver.py:62-357 — assigns
``num_chunks`` sequence chunks (each with an attention-area workload) to
``cp_size`` ranks, **exactly num_chunks/cp_size chunks per rank** (shards must
be equal-sized tensors), minimizing the max per-rank area.

Algorithms (DispatchAlgType):
  LOWER_BOUND          — the theoretical bound only (testing aid)
  MIN_HEAP             — greedy: biggest chunk to least-loaded non-full rank
  BINARY_SEARCH        — makespan binary search + first-fit-decreasing check
  DYNAMIC_PROGRAMMING  — exact search for small instances, else MIN_HEAP
  BACKTRACKING_PRUNING — branch & bound refinement of the MIN_HEAP solution
  TOPP_HEAP / BATCH_TOPP_HEAP — MIN_HEAP with a top-p candidate pool, tie-broken
                         by sample-affinity when provided
  SEQUENTIAL_SELECT    — contiguous blocks (no balancing)
  SORTED_SEQUENTIAL_SELECT — snake deal of area-sorted chunks
  RANDOM_SELECT        — random permutation partition
"""

from __future__ import annotations

import copy
import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Sequence

from ...common.enum import DispatchAlgType
from ...common.range import AttnRange
from ...common.ranges import AttnRanges
from ...config import DispatchConfig  # canonical definition (config.py)
from ... import telemetry


class BaseDispatchAffinity:
    """Chunk/bucket affinity for tie-breaking rank selection
    (ref dispatch_solver.py:373). Smaller distance = stronger pull."""

    def distance_to(self, other: "BaseDispatchAffinity") -> float:
        raise NotImplementedError

    def update(self, other: "BaseDispatchAffinity") -> None:
        """Absorb ``other`` (in-place) after assigning its chunk here."""
        raise NotImplementedError

    def closest_idx(self, others: list["BaseDispatchAffinity"]) -> int:
        return min(range(len(others)), key=lambda i: self.distance_to(others[i]))


class SampleIDAffinity(BaseDispatchAffinity):
    """Counts of sample ids in a chunk/bucket (ref :416): chunks from the
    same packed sample prefer the same rank, so sample-local kv stays
    rank-local."""

    def __init__(self) -> None:
        self.counts: dict[int, int] = {}

    @staticmethod
    def from_list(ids: list[int]) -> "SampleIDAffinity":
        a = SampleIDAffinity()
        for i in ids:
            a.add_sample_id(i)
        return a

    def add_sample_id(self, sample_id: int) -> None:
        assert sample_id >= 0
        self.counts[sample_id] = self.counts.get(sample_id, 0) + 1

    def get_count(self, sample_id: int) -> int:
        return self.counts.get(sample_id, 0)

    def is_empty(self) -> bool:
        return not self.counts

    def distance_to(self, other: "SampleIDAffinity") -> float:
        """Negative count, in ``other``, of self's majority sample id."""
        if self.is_empty() or other.is_empty():
            return 0.0
        major = max(self.counts, key=lambda i: self.counts[i])
        return -float(other.get_count(major))

    def update(self, other: "SampleIDAffinity") -> None:
        for i, c in other.counts.items():
            self.counts[i] = self.counts.get(i, 0) + c

    def __repr__(self) -> str:
        return f"SampleIDAffinity({self.counts})"


class IOUAffinity(BaseDispatchAffinity):
    """KV-coverage overlap affinity (ref :478): chunks whose attention
    touches overlapping k ranges co-locate, deduplicating remote-kv fetches
    (the GroupCast volume shrinks by exactly the intersection)."""

    def __init__(self) -> None:
        self.iou_ranges = AttnRanges()

    @staticmethod
    def from_ranges(ranges: AttnRanges) -> "IOUAffinity":
        a = IOUAffinity()
        a.iou_ranges = ranges.merge()
        return a

    def distance_to(self, other: "IOUAffinity") -> float:
        return -float(self.iou_ranges.intersect_size_with(other.iou_ranges))

    def update(self, other: "IOUAffinity") -> None:
        merged = AttnRanges()
        for r in self.iou_ranges:
            merged.append(AttnRange(r.start, r.end))
        for r in other.iou_ranges:
            merged.append(AttnRange(r.start, r.end))
        self.iou_ranges = merged.merge()

    def __repr__(self) -> str:
        return f"IOUAffinity({self.iou_ranges})"


def normalize_capacities(
    capacities: Sequence[float] | None, cp_size: int
) -> tuple[float, ...] | None:
    """Canonicalize a per-rank capacity vector.

    ``None`` and any all-equal positive vector (e.g. all-ones) mean *uniform*
    and normalize to ``None``, so the uniform path — solver output, plan
    signature, warm plan stores — stays byte-identical to a build without
    capacities. A genuinely non-uniform vector comes back as a float tuple;
    a zero entry drains that rank entirely.
    """
    if capacities is None:
        return None
    caps = tuple(float(c) for c in capacities)
    if len(caps) != cp_size:
        raise ValueError(
            f"capacities has {len(caps)} entries for cp_size {cp_size}"
        )
    if any(not math.isfinite(c) or c < 0.0 for c in caps):
        raise ValueError(f"capacities must be finite and >= 0, got {caps}")
    if all(c == 0.0 for c in caps):
        raise ValueError("all ranks drained: capacities are all zero")
    if all(c == caps[0] for c in caps):
        return None
    return caps


@dataclass
class DispatchSolution:
    partitions: list[list[int]]  # chunk ids per rank, each sorted ascending
    max_area: int
    lower_bound: int
    # weighted solve only (uniform solves leave all three None so the
    # dataclass surface stays identical to the all-ones build)
    capacities: tuple[float, ...] | None = None
    weighted_makespan: float | None = None
    weighted_lower_bound: float | None = None

    @property
    def balance_ratio(self) -> float:
        if self.capacities is not None:
            # weighted form: per-rank completion time is area/capacity and
            # the ratio compares the weighted makespan to its lower bound
            if not self.weighted_makespan:
                return 1.0
            return (self.weighted_lower_bound or 0.0) / self.weighted_makespan
        return self.lower_bound / self.max_area if self.max_area else 1.0


@dataclass
class DispatchSolver:
    """Solves the equal-count, min-makespan chunk partition problem."""

    alg: DispatchAlgType = DispatchAlgType.MIN_HEAP
    config: DispatchConfig = field(default_factory=DispatchConfig)

    def solve(
        self,
        areas: list[int],
        cp_size: int,
        sample_ids: list[int] | None = None,
        seed: int = 0,
        affinities: list[BaseDispatchAffinity] | None = None,
        capacities: Sequence[float] | None = None,
    ) -> DispatchSolution:
        n = len(areas)
        lb = self._lower_bound(areas, cp_size)
        alg = self.alg

        caps = normalize_capacities(capacities, cp_size)
        if caps is not None:
            # weighted makespan: target per-rank area proportional to
            # capacity, zero-capacity ranks drained (empty shard). Chunk
            # counts are inherently unequal, so shards pad like uneven_shard.
            parts = self._weighted_lpt(areas, cp_size, caps)
            parts = [sorted(p) for p in parts]
            per_rank = [sum(areas[i] for i in p) for p in parts]
            makespan = max(
                (per_rank[r] / caps[r] for r in range(cp_size) if caps[r] > 0),
                default=0.0,
            )
            return self._record(
                DispatchSolution(
                    partitions=parts,
                    max_area=max(per_rank, default=0),
                    lower_bound=lb,
                    capacities=caps,
                    weighted_makespan=makespan,
                    weighted_lower_bound=self._weighted_lower_bound(
                        areas, caps
                    ),
                ),
                alg, n, cp_size, areas,
            )

        if self.config.uneven_shard:
            # unequal chunk counts: pure min-makespan (LPT greedy, or exact
            # refinement for the search algorithms); shards pad to the max
            if alg == DispatchAlgType.SEQUENTIAL_SELECT and n % cp_size == 0:
                parts = self._sequential(n, cp_size, n // cp_size)
            elif alg == DispatchAlgType.BINARY_SEARCH:
                parts = self._binary_search_uneven(areas, cp_size)
            else:
                parts = self._min_heap_uneven(areas, cp_size)
            parts = [sorted(p) for p in parts]
            max_area = max(
                (sum(areas[i] for i in p) for p in parts), default=0
            )
            return self._record(
                DispatchSolution(
                    partitions=parts, max_area=max_area, lower_bound=lb
                ),
                alg, len(areas), cp_size, areas,
            )

        if n % cp_size != 0:
            raise ValueError(f"num_chunks {n} not divisible by cp_size {cp_size}")
        k = n // cp_size
        if alg == DispatchAlgType.LOWER_BOUND:
            parts = self._sequential(n, cp_size, k)
        elif alg == DispatchAlgType.SEQUENTIAL_SELECT:
            parts = self._sequential(n, cp_size, k)
        elif alg == DispatchAlgType.RANDOM_SELECT:
            parts = self._random(n, cp_size, k, seed)
        elif alg == DispatchAlgType.SORTED_SEQUENTIAL_SELECT:
            parts = self._snake(areas, cp_size, k)
        elif alg == DispatchAlgType.MIN_HEAP:
            parts = self._min_heap(areas, cp_size, k)
        elif alg in (DispatchAlgType.TOPP_HEAP, DispatchAlgType.BATCH_TOPP_HEAP):
            if affinities is None and sample_ids is not None:
                affinities = [
                    SampleIDAffinity.from_list([i]) for i in sample_ids
                ]
            parts = self._topp_heap(areas, cp_size, k, seed, affinities)
        elif alg == DispatchAlgType.BINARY_SEARCH:
            parts = self._binary_search(areas, cp_size, k)
        elif alg == DispatchAlgType.DYNAMIC_PROGRAMMING:
            parts = self._exact_small(areas, cp_size, k)
        elif alg == DispatchAlgType.BACKTRACKING_PRUNING:
            parts = self._backtrack(areas, cp_size, k)
        else:
            raise ValueError(f"unknown dispatch alg: {alg}")

        parts = [sorted(p) for p in parts]
        max_area = max(sum(areas[i] for i in p) for p in parts)
        return self._record(
            DispatchSolution(
                partitions=parts, max_area=max_area, lower_bound=lb
            ),
            alg, n, cp_size, areas,
        )

    @staticmethod
    def _record(
        sol: DispatchSolution,
        alg: DispatchAlgType,
        num_chunks: int,
        cp_size: int,
        areas: list[int],
    ) -> DispatchSolution:
        """Gated telemetry for one solve (AUTO emits one per candidate;
        the chosen assignment's record is the later ``dispatch_meta`` kind,
        _make_dispatch_meta.py)."""
        if telemetry.enabled():
            extra = {}
            if sol.capacities is not None:
                extra = {
                    "capacities": list(sol.capacities),
                    "weighted_makespan": sol.weighted_makespan,
                    "weighted_lower_bound": sol.weighted_lower_bound,
                }
            telemetry.record_event(
                "dispatch_solve",
                alg=alg.value if hasattr(alg, "value") else str(alg),
                num_chunks=num_chunks,
                cp_size=cp_size,
                per_rank_area=[
                    sum(areas[i] for i in p) for p in sol.partitions
                ],
                max_area=sol.max_area,
                lower_bound=sol.lower_bound,
                balance_ratio=sol.balance_ratio,
                **extra,
            )
        return sol

    # -- capacity-weighted solve ------------------------------------------

    @staticmethod
    def _weighted_lpt(
        areas: list[int], cp: int, caps: tuple[float, ...]
    ) -> list[list[int]]:
        """Weighted LPT: biggest chunk to the rank minimizing the
        *projected completion time* ``(load + area) / capacity`` (ties
        prefer the faster rank — a slow rank must not absorb a large chunk
        just because it is idle). Ranks with zero capacity are never
        candidates, so they come back with empty partitions (drained).
        O(n * cp) scan: projected time depends on the chunk, so a plain
        load heap would misplace large chunks onto slow ranks."""
        active = [r for r in range(cp) if caps[r] > 0.0]
        order = sorted(range(len(areas)), key=lambda i: (-areas[i], i))
        parts: list[list[int]] = [[] for _ in range(cp)]
        loads = [0] * cp
        for i in order:
            r = min(
                active,
                key=lambda r: (
                    (loads[r] + areas[i]) / caps[r], -caps[r], r
                ),
            )
            parts[r].append(i)
            loads[r] += areas[i]
        return parts

    @staticmethod
    def _weighted_lower_bound(
        areas: list[int], caps: tuple[float, ...]
    ) -> float:
        """Weighted analogue of ``_lower_bound``: no schedule can finish
        before the capacity-share bound ``total / sum(w)`` nor before the
        largest single chunk runs on the fastest rank."""
        total = sum(areas)
        wsum = sum(c for c in caps if c > 0.0)
        wmax = max(caps)
        return max(total / wsum, max(areas, default=0) / wmax)

    # -- uneven-shard variants --------------------------------------------

    @staticmethod
    def _min_heap_uneven(areas: list[int], cp: int) -> list[list[int]]:
        """LPT greedy without the equal-count constraint: biggest chunk to
        the least-loaded rank (every rank still gets >= 1 chunk when
        possible, so no shard is empty)."""
        n = len(areas)
        order = sorted(range(n), key=lambda i: areas[i], reverse=True)
        parts: list[list[int]] = [[] for _ in range(cp)]
        # seed each rank with one chunk first (largest chunks spread out)
        for r, i in enumerate(order[: min(cp, n)]):
            parts[r].append(i)
        heap = [(sum(areas[i] for i in parts[r]), r) for r in range(cp)]
        heapq.heapify(heap)
        for i in order[min(cp, n):]:
            load, r = heapq.heappop(heap)
            parts[r].append(i)
            heapq.heappush(heap, (load + areas[i], r))
        return parts

    def _binary_search_uneven(
        self, areas: list[int], cp: int
    ) -> list[list[int]]:
        """Makespan binary search + first-fit-decreasing, no count cap."""
        n = len(areas)
        order = sorted(range(n), key=lambda i: areas[i], reverse=True)
        lo = self._lower_bound(areas, cp)
        hi = sum(areas)
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            loads = [0] * cp
            parts: list[list[int]] = [[] for _ in range(cp)]
            ok = True
            for i in order:
                r = min(range(cp), key=lambda r: loads[r])
                if loads[r] + areas[i] > mid:
                    ok = False
                    break
                parts[r].append(i)
                loads[r] += areas[i]
            if ok:
                best = parts
                hi = mid - 1
            else:
                lo = mid + 1
        return best if best is not None else self._min_heap_uneven(areas, cp)

    # -- bounds ------------------------------------------------------------

    @staticmethod
    def _lower_bound(areas: list[int], cp_size: int) -> int:
        total = sum(areas)
        return max(-(-total // cp_size), max(areas, default=0))

    # -- trivial partitions ------------------------------------------------

    @staticmethod
    def _sequential(n: int, cp: int, k: int) -> list[list[int]]:
        return [list(range(r * k, (r + 1) * k)) for r in range(cp)]

    @staticmethod
    def _random(n: int, cp: int, k: int, seed: int) -> list[list[int]]:
        idx = list(range(n))
        random.Random(seed).shuffle(idx)
        return [idx[r * k : (r + 1) * k] for r in range(cp)]

    @staticmethod
    def _snake(areas: list[int], cp: int, k: int) -> list[list[int]]:
        order = sorted(range(len(areas)), key=lambda i: -areas[i])
        parts: list[list[int]] = [[] for _ in range(cp)]
        for round_idx in range(k):
            ranks = range(cp) if round_idx % 2 == 0 else range(cp - 1, -1, -1)
            for j, r in enumerate(ranks):
                parts[r].append(order[round_idx * cp + j])
        return parts

    # -- greedy heap -------------------------------------------------------

    @staticmethod
    def _min_heap(areas: list[int], cp: int, k: int) -> list[list[int]]:
        order = sorted(range(len(areas)), key=lambda i: -areas[i])
        heap = [(0, r) for r in range(cp)]
        heapq.heapify(heap)
        parts: list[list[int]] = [[] for _ in range(cp)]
        overflow = []
        for i in order:
            while True:
                load, r = heapq.heappop(heap)
                if len(parts[r]) < k:
                    parts[r].append(i)
                    heapq.heappush(heap, (load + areas[i], r))
                    break
                overflow.append((load, r))
            for item in overflow:
                heapq.heappush(heap, item)
            overflow.clear()
        return parts

    def _topp_heap(
        self,
        areas: list[int],
        cp: int,
        k: int,
        seed: int,
        affinities: list[BaseDispatchAffinity] | None = None,
    ) -> list[list[int]]:
        """MIN_HEAP with selection among the top-p least-loaded candidate
        ranks: affinity-closest when chunk affinities are given (the
        reference's IOU / sample-id tie-break), seeded-random otherwise."""
        rng = random.Random(seed)
        order = sorted(range(len(areas)), key=lambda i: -areas[i])
        loads = [0] * cp
        parts: list[list[int]] = [[] for _ in range(cp)]
        pool_size = max(1, int(cp * self.config.top_p))
        rank_aff: list[BaseDispatchAffinity | None] = [None] * cp
        for i in order:
            candidates = sorted(
                (r for r in range(cp) if len(parts[r]) < k),
                key=lambda r: loads[r],
            )[:pool_size]
            if affinities is not None:
                aff = affinities[i]
                best = min(
                    candidates,
                    key=lambda r: (
                        0.0 if rank_aff[r] is None
                        else aff.distance_to(rank_aff[r])
                    ),
                )
                r = best
                if rank_aff[r] is None:
                    rank_aff[r] = copy.deepcopy(aff)
                else:
                    rank_aff[r].update(aff)
            else:
                r = rng.choice(candidates)
            parts[r].append(i)
            loads[r] += areas[i]
        return parts

    # -- binary search on makespan ----------------------------------------

    def _binary_search(self, areas: list[int], cp: int, k: int) -> list[list[int]]:
        order = sorted(range(len(areas)), key=lambda i: -areas[i])
        lo = self._lower_bound(areas, cp)
        hi = sum(areas)

        def try_pack(cap: int) -> list[list[int]] | None:
            loads = [0] * cp
            parts: list[list[int]] = [[] for _ in range(cp)]
            for i in order:
                # best-fit: fullest rank that still fits and has capacity
                best = None
                for r in range(cp):
                    if len(parts[r]) < k and loads[r] + areas[i] <= cap:
                        if best is None or loads[r] > loads[best]:
                            best = r
                if best is None:
                    return None
                parts[best].append(i)
                loads[best] += areas[i]
            return parts

        best_parts = self._min_heap(areas, cp, k)
        while lo < hi:
            mid = (lo + hi) // 2
            packed = try_pack(mid)
            if packed is not None:
                best_parts = packed
                hi = mid
            else:
                lo = mid + 1
        return best_parts

    # -- exact (small) -----------------------------------------------------

    def _exact_small(self, areas: list[int], cp: int, k: int) -> list[list[int]]:
        n = len(areas)
        if n > 16 or cp > 4:
            return self._backtrack(areas, cp, k)
        best = {"max": float("inf"), "parts": None}
        parts: list[list[int]] = [[] for _ in range(cp)]
        loads = [0] * cp

        def rec(i: int):
            if i == n:
                m = max(loads)
                if m < best["max"]:
                    best["max"] = m
                    best["parts"] = [list(p) for p in parts]
                return
            if max(loads) >= best["max"]:
                return
            seen = set()
            for r in range(cp):
                if len(parts[r]) == k or loads[r] in seen:
                    continue
                seen.add(loads[r])
                parts[r].append(i)
                loads[r] += areas[i]
                rec(i + 1)
                parts[r].pop()
                loads[r] -= areas[i]

        rec(0)
        return best["parts"] or self._min_heap(areas, cp, k)

    # -- branch & bound ----------------------------------------------------

    def _backtrack(self, areas: list[int], cp: int, k: int) -> list[list[int]]:
        init = self._min_heap(areas, cp, k)
        best_max = max(sum(areas[i] for i in p) for p in init)
        lb = self._lower_bound(areas, cp)
        if best_max == lb:
            return init
        order = sorted(range(len(areas)), key=lambda i: -areas[i])
        n = len(order)
        best = {"max": best_max, "parts": init}
        parts: list[list[int]] = [[] for _ in range(cp)]
        loads = [0] * cp
        budget = [self.config.max_backtracks]

        def rec(pos: int):
            if budget[0] <= 0:
                return
            if pos == n:
                m = max(loads)
                if m < best["max"]:
                    best["max"] = m
                    best["parts"] = [list(p) for p in parts]
                return
            i = order[pos]
            seen = set()
            for r in sorted(range(cp), key=lambda r: loads[r]):
                if len(parts[r]) == k or loads[r] in seen:
                    continue
                if loads[r] + areas[i] >= best["max"]:
                    continue
                seen.add(loads[r])
                parts[r].append(i)
                loads[r] += areas[i]
                budget[0] -= 1
                rec(pos + 1)
                parts[r].pop()
                loads[r] -= areas[i]
                if best["max"] == lb:
                    return

        rec(0)
        return best["parts"]
