"""Shared machinery for the dynamic (qo-comm) solver algorithms.

The port's copy of ``magiattention_tpu/meta/solver/algorithms/base.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/algorithms/ — the reference ships six rectangle
assignment algorithms (NCQ, GRG, SNF, FastSNF, BinaryGreedy,
BinaryGreedyParallel) that partition the global `AttnRectangles` workload
over CP ranks, allowing q/o rows (not only kv) to move between ranks.

TPU-first re-design: every algorithm here works on *ownership tiles* —
rectangles pre-cut along q-owner and k-owner boundaries so each tile has a
unique (q_owner, k_owner) pair. Assignment cost is then exact marginal
communication: rows a rank must newly fetch (q + returned o/lse, k + v),
dedup-aware (a row already fetched for an earlier tile is free — the same
zero-redundancy property the GroupCast comm layer provides).
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

from ....common.range import AttnRange
from ....common.ranges import AttnRanges
from ....common.rectangle import AttnRectangle, AttnRectangles

# cost weights in "rows": q fetched in + o/lse returned; k + v fetched in
W_QO = 2
W_KV = 2


@dataclass
class Tile:
    """An ownership-uniform piece of the global workload."""

    rect: AttnRectangle
    q_owner: int
    k_owner: int
    area: int


@dataclass
class DynSolveContext:
    """Immutable per-solve inputs shared by all algorithms."""

    host_ranges_q: list[AttnRanges]  # per rank, merged, global coords
    host_ranges_k: list[AttnRanges]
    cp_size: int

    _q_bounds: list[int] = field(default_factory=list, repr=False)
    _q_owner: list[int] = field(default_factory=list, repr=False)
    _k_bounds: list[int] = field(default_factory=list, repr=False)
    _k_owner: list[int] = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        self._q_bounds, self._q_owner = _owner_index(self.host_ranges_q)
        self._k_bounds, self._k_owner = _owner_index(self.host_ranges_k)

    def q_owner_of(self, pos: int) -> int:
        return self._q_owner[bisect_right(self._q_bounds, pos) - 1]

    def k_owner_of(self, pos: int) -> int:
        return self._k_owner[bisect_right(self._k_bounds, pos) - 1]

    @property
    def q_cuts(self) -> list[int]:
        return self._q_bounds

    @property
    def k_cuts(self) -> list[int]:
        return self._k_bounds


def _owner_index(
    host_ranges: list[AttnRanges],
) -> tuple[list[int], list[int]]:
    """Sorted segment starts + owning rank per segment (-1 = unowned gap)."""
    segs: list[tuple[int, int, int]] = []
    for rank, ranges in enumerate(host_ranges):
        for r in ranges:
            segs.append((r.start, r.end, rank))
    segs.sort()
    bounds: list[int] = [0]
    owners: list[int] = [-1]
    for start, end, rank in segs:
        if start > bounds[-1] or owners[-1] != -1:
            if start != bounds[-1]:
                bounds.append(start)
                owners.append(rank)
            else:
                owners[-1] = rank
        else:
            owners[-1] = rank
        bounds.append(end)
        owners.append(-1)
    return bounds, owners


def cut_to_tiles(rects: AttnRectangles, ctx: DynSolveContext) -> list[Tile]:
    """Cut rectangles along ownership boundaries into (q,k)-owner-uniform
    tiles (the dynamic-solver analogue of the static solver's host/remote
    split)."""
    tiles: list[Tile] = []
    for rect in rects:
        q_pieces = _cut_along(rect, ctx.q_cuts, is_q=True)
        for qp in q_pieces:
            for piece in _cut_along(qp, ctx.k_cuts, is_q=False):
                area = piece.area()
                if area <= 0:
                    continue
                tiles.append(
                    Tile(
                        rect=piece,
                        q_owner=ctx.q_owner_of(piece.q_range.start),
                        k_owner=ctx.k_owner_of(piece.k_range.start),
                        area=area,
                    )
                )
    return tiles


def _cut_along(
    rect: AttnRectangle, cuts: list[int], is_q: bool
) -> list[AttnRectangle]:
    rng = rect.q_range if is_q else rect.k_range
    out: list[AttnRectangle] = []
    cur = rect
    lo_i = bisect_right(cuts, rng.start)
    for pos in cuts[lo_i:]:
        cur_rng = cur.q_range if is_q else cur.k_range
        if pos >= cur_rng.end:
            break
        if pos <= cur_rng.start:
            continue
        head, tail = (cur.cut_q(pos) if is_q else cur.cut_k(pos))
        if not head.is_empty():
            out.append(head)
        if tail.is_empty():
            return out
        cur = tail
    if not cur.is_empty():
        out.append(cur)
    return out


@dataclass
class RankState:
    """Mutable per-rank assignment state tracked during greedy solves."""

    load: int = 0  # assigned attention area
    fetched_q: AttnRanges = field(default_factory=AttnRanges)
    fetched_k: AttnRanges = field(default_factory=AttnRanges)


def marginal_comm_cost(
    state: RankState, tile: Tile, rank: int, ctx: DynSolveContext
) -> int:
    """Rows newly communicated if `tile` is assigned to `rank` (dedup-aware)."""
    cost = 0
    if tile.q_owner != rank:
        cost += W_QO * _new_rows(tile.rect.q_range, ctx.host_ranges_q[rank],
                                 state.fetched_q)
    if tile.k_owner != rank:
        cost += W_KV * _new_rows(tile.rect.k_range, ctx.host_ranges_k[rank],
                                 state.fetched_k)
    return cost


def _new_rows(r: AttnRange, own: AttnRanges, fetched: AttnRanges) -> int:
    need = AttnRanges([AttnRange(r.start, r.end)])
    remote = need.find_hole_ranges(own)
    if len(fetched) == 0:
        return remote.total_seqlen
    return remote.total_seqlen - remote.intersect_size_with(fetched)


def commit(state: RankState, tile: Tile, rank: int, ctx: DynSolveContext) -> None:
    """Record an assignment in the rank's dedup state."""
    state.load += tile.area
    if tile.q_owner != rank:
        state.fetched_q.append(
            AttnRange(tile.rect.q_range.start, tile.rect.q_range.end)
        )
        state.fetched_q = state.fetched_q.merge()
    if tile.k_owner != rank:
        state.fetched_k.append(
            AttnRange(tile.rect.k_range.start, tile.rect.k_range.end)
        )
        state.fetched_k = state.fetched_k.merge()


def buckets_from_assignment(
    tiles: list[Tile], assign: list[int], cp_size: int
) -> list[AttnRectangles]:
    buckets = [AttnRectangles() for _ in range(cp_size)]
    for t, r in zip(tiles, assign):
        buckets[r].append(t.rect)
    return buckets


class DynamicAttnAlgorithm:
    """Base interface: partition the rect workload into per-rank buckets."""

    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        raise NotImplementedError
