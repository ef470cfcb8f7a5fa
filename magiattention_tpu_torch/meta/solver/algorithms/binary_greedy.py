"""BinaryGreedy / BinaryGreedyParallel — capacity-bounded greedy with binary
search on the balance cap.

The port's copy of ``magiattention_tpu/meta/solver/algorithms/binary_greedy.py``
(numpy only, imports rewired; no native path).

Ref: magi_attention/meta/algorithms (BinaryGreedy, BinaryGreedyParallel — the
reference's default, with its hot loop in C++
csrc/extensions/dyn_solver_alg.cpp:644). Scheme:

1. sort tiles by area descending (LPT);
2. for a candidate per-rank area cap C, greedily place each tile on the
   feasible rank (load + area <= C) with minimum marginal comm rows,
   tie-broken by load;
3. binary-search the smallest feasible C between the lower bound
   (total/cp, max tile) and the NCQ worst case.

BinaryGreedyParallel is the same algorithm with the inner candidate-rank scan
vectorized (numpy). The JAX package first tries its C++ host backend's
``binary_greedy_solve``; the port has no native host backend (ROADMAP queue
A10), so it runs the numpy path, ``_solve_numpy``, always.
"""

from __future__ import annotations

import numpy as np

from ....common.rectangle import AttnRectangles
from .base import (
    DynamicAttnAlgorithm,
    DynSolveContext,
    RankState,
    buckets_from_assignment,
    commit,
    cut_to_tiles,
    marginal_comm_cost,
)


def _greedy_with_cap(
    tiles_sorted: list[int],
    tiles,
    ctx: DynSolveContext,
    cap: int,
) -> list[int] | None:
    states = [RankState() for _ in range(ctx.cp_size)]
    assign = [0] * len(tiles)
    for i in tiles_sorted:
        t = tiles[i]
        best, best_key = -1, None
        for r in range(ctx.cp_size):
            if states[r].load + t.area > cap:
                continue
            key = (marginal_comm_cost(states[r], t, r, ctx), states[r].load)
            if best_key is None or key < best_key:
                best, best_key = r, key
        if best < 0:
            return None
        assign[i] = best
        commit(states[best], t, best, ctx)
    return assign


class BinaryGreedyAlg(DynamicAttnAlgorithm):
    def __init__(self, slack: float = 0.02, max_iters: int = 16) -> None:
        self.slack = slack
        self.max_iters = max_iters

    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        tiles = cut_to_tiles(rects, ctx)
        if not tiles:
            return [AttnRectangles() for _ in range(ctx.cp_size)]
        order = sorted(
            range(len(tiles)), key=lambda i: tiles[i].area, reverse=True
        )
        total = sum(t.area for t in tiles)
        lo = max(-(-total // ctx.cp_size), max(t.area for t in tiles))
        hi = total
        best = None
        for _ in range(self.max_iters):
            if lo > hi:
                break
            mid = (lo + hi) // 2
            assign = _greedy_with_cap(order, tiles, ctx, mid)
            if assign is not None:
                best = assign
                hi = int(mid * (1 - self.slack)) - 1
            else:
                lo = mid + 1
        if best is None:
            best = _greedy_with_cap(order, tiles, ctx, total)
            assert best is not None
        return buckets_from_assignment(tiles, best, ctx.cp_size)


class BinaryGreedyParallelAlg(DynamicAttnAlgorithm):
    """Vectorized variant: same placement rule, the candidate scan is a
    numpy batch op over ranks."""

    def __init__(self, slack: float = 0.02, max_iters: int = 16) -> None:
        self.slack = slack
        self.max_iters = max_iters

    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        tiles = cut_to_tiles(rects, ctx)
        if not tiles:
            return [AttnRectangles() for _ in range(ctx.cp_size)]
        return self._solve_numpy(tiles, ctx)

    # -- numpy path --------------------------------------------------------

    def _solve_numpy(self, tiles, ctx: DynSolveContext):
        order = sorted(
            range(len(tiles)), key=lambda i: tiles[i].area, reverse=True
        )
        total = sum(t.area for t in tiles)
        lo = max(-(-total // ctx.cp_size), max(t.area for t in tiles))
        hi = total
        best = None
        for _ in range(self.max_iters):
            if lo > hi:
                break
            mid = (lo + hi) // 2
            assign = self._greedy_vec(order, tiles, ctx, mid)
            if assign is not None:
                best = assign
                hi = int(mid * (1 - self.slack)) - 1
            else:
                lo = mid + 1
        if best is None:
            best = self._greedy_vec(order, tiles, ctx, total)
            assert best is not None
        return buckets_from_assignment(tiles, best, ctx.cp_size)

    @staticmethod
    def _greedy_vec(order, tiles, ctx: DynSolveContext, cap: int):
        cp = ctx.cp_size
        states = [RankState() for _ in range(cp)]
        loads = np.zeros(cp, dtype=np.int64)
        assign = [0] * len(tiles)
        for i in order:
            t = tiles[i]
            costs = np.array(
                [marginal_comm_cost(states[r], t, r, ctx) for r in range(cp)],
                dtype=np.int64,
            )
            feasible = loads + t.area <= cap
            if not feasible.any():
                return None
            # lexicographic (comm, load) argmin over feasible ranks
            key = costs * (loads.max() + 1 + t.area) + loads
            key = np.where(feasible, key, np.iinfo(np.int64).max)
            best = int(key.argmin())
            assign[i] = best
            commit(states[best], t, best, ctx)
            loads[best] += t.area
        return assign
