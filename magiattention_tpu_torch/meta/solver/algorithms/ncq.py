"""NCQ — non-communication-qo assignment.

The port's copy of ``magiattention_tpu/meta/solver/algorithms/ncq.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/algorithms (NCQ). Every tile is assigned to the rank
that owns its q rows, so q/o/do/lse never move (only kv does) — the dynamic
solver's embedding of the static kv-comm strategy. Useful both as the safe
fallback and as the reference point the other algorithms must beat on comm
volume or balance.
"""

from __future__ import annotations

from ....common.rectangle import AttnRectangles
from .base import DynamicAttnAlgorithm, DynSolveContext, buckets_from_assignment, cut_to_tiles


class NCQAlg(DynamicAttnAlgorithm):
    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        tiles = cut_to_tiles(rects, ctx)
        assign = [t.q_owner for t in tiles]
        return buckets_from_assignment(tiles, assign, ctx.cp_size)
