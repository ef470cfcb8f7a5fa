"""GRG — greedy random grid assignment.

The port's copy of ``magiattention_tpu/meta/solver/algorithms/grg.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/algorithms (GRG). Tiles are visited in a seeded
random order; each is assigned to the rank minimizing

    load_penalty + lambda * marginal_comm_rows

where marginal comm is dedup-aware (rows already fetched are free). The
random visit order de-correlates tie-breaking across the grid, which in
practice spreads hotspot diagonals better than area-sorted greedy for very
irregular masks.
"""

from __future__ import annotations

import random

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


class GRGAlg(DynamicAttnAlgorithm):
    """SPMD caveat: ``seed`` (like every alg kwarg) MUST be identical on all
    hosts — the plan is computed redundantly per host and a mismatched seed
    desynchronizes the collective layout. Never derive it from a rank id;
    it is part of the runtime cache key via DistAttnConfig."""

    def __init__(self, seed: int = 0, comm_weight: float = 1.0) -> None:
        self.seed = seed
        self.comm_weight = comm_weight

    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        tiles = cut_to_tiles(rects, ctx)
        order = list(range(len(tiles)))
        random.Random(self.seed).shuffle(order)

        total = sum(t.area for t in tiles)
        target = max(1, total // ctx.cp_size)
        states = [RankState() for _ in range(ctx.cp_size)]
        assign = [0] * len(tiles)

        for i in order:
            t = tiles[i]
            best, best_cost = 0, None
            for r in range(ctx.cp_size):
                # load normalized to the balance target; comm in rows
                cost = (
                    (states[r].load + t.area) / target
                    + self.comm_weight
                    * marginal_comm_cost(states[r], t, r, ctx)
                    / max(1, t.area)
                )
                if best_cost is None or cost < best_cost:
                    best, best_cost = r, cost
            assign[i] = best
            commit(states[best], t, best, ctx)

        return buckets_from_assignment(tiles, assign, ctx.cp_size)
