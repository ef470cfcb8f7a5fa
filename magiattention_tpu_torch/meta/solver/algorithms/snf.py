"""SNF / FastSNF — network-flow based assignment.

The port's copy of ``magiattention_tpu/meta/solver/algorithms/snf.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/algorithms (SNF snf.py:32, FastSNF). The workload
assignment is modeled as a transportation problem on a bipartite network:

    source -> tile_t   (capacity = area_t, cost 0)
    tile_t -> rank_r   (capacity = area_t, cost = comm rows/area unit)
    rank_r -> sink     (capacity = balance cap, cost 0)

solved to optimality on the fractional relaxation by successive shortest
paths with node potentials (each augmentation saturates a tile or a rank, so
there are at most T + R augmentations). The integral assignment rounds each
tile to its majority rank, then a repair pass re-places tiles from
over-capacity ranks. FastSNF caps the network size: only the largest
`max_flow_tiles` tiles enter the flow; the long tail is placed by the same
greedy rule the BinaryGreedy family uses.
"""

from __future__ import annotations

import heapq

import numpy as np

from ....common.rectangle import AttnRectangles
from .base import (
    W_KV,
    W_QO,
    DynamicAttnAlgorithm,
    DynSolveContext,
    RankState,
    Tile,
    buckets_from_assignment,
    commit,
    cut_to_tiles,
    marginal_comm_cost,
)


def _static_cost(t: Tile, r: int) -> int:
    """Per-area-unit comm cost of computing tile t on rank r (no dedup)."""
    c = 0
    if t.q_owner != r:
        c += W_QO * t.rect.q_range.seqlen
    if t.k_owner != r:
        c += W_KV * t.rect.k_range.seqlen
    # normalize to per-unit cost so large tiles aren't unfairly cheap
    return (c * 1024) // max(1, t.area)


def _ssp_transport(
    supplies: np.ndarray, caps: np.ndarray, cost: np.ndarray
) -> np.ndarray:
    """Min-cost fractional transport: flow[t, r] via successive shortest
    paths with Dijkstra + Johnson potentials on the bipartite graph."""
    nt, nr = cost.shape
    flow = np.zeros((nt, nr), dtype=np.int64)
    remaining = supplies.copy()
    cap_left = caps.copy()
    pot_t = np.zeros(nt, dtype=np.int64)
    pot_r = np.zeros(nr, dtype=np.int64)

    for t0 in np.argsort(-supplies):
        while remaining[t0] > 0:
            # Dijkstra from t0 over reduced costs; path alternates t -> r
            # (forward, cap_left) and r -> t (backward, flow > 0)
            INF = np.iinfo(np.int64).max
            dist_t = np.full(nt, INF)
            dist_r = np.full(nr, INF)
            par_r = np.full(nr, -1)  # tile feeding rank r on the path
            par_t = np.full(nt, -1)  # rank feeding tile t on the path
            dist_t[t0] = 0
            pq: list[tuple[int, int, int]] = [(0, 0, t0)]  # (d, is_rank, idx)
            while pq:
                d, is_rank, u = heapq.heappop(pq)
                if is_rank:
                    if d > dist_r[u]:
                        continue
                    # backward edges rank u -> tile t (reduce flow[t, u])
                    for t in range(nt):
                        if flow[t, u] <= 0:
                            continue
                        nd = d - (cost[t, u] + pot_t[t] - pot_r[u])
                        if nd < dist_t[t]:
                            dist_t[t] = nd
                            par_t[t] = u
                            heapq.heappush(pq, (nd, 0, t))
                else:
                    if d > dist_t[u]:
                        continue
                    for r in range(nr):
                        if cap_left[r] <= 0 and flow[u, r] >= supplies[u]:
                            continue  # edge saturated in both directions
                        nd = d + cost[u, r] + pot_t[u] - pot_r[r]
                        if nd < dist_r[r]:
                            dist_r[r] = nd
                            par_r[r] = u
                            heapq.heappush(pq, (nd, 1, r))
            # cheapest rank with spare capacity
            cand = [r for r in range(nr) if cap_left[r] > 0 and dist_r[r] < INF]
            if not cand:
                break
            r_end = min(cand, key=lambda r: dist_r[r])
            # walk back to find bottleneck
            path: list[tuple[int, int]] = []  # (tile, rank) forward edges
            r = r_end
            bottleneck = min(remaining[t0], cap_left[r_end])
            while True:
                t = par_r[r]
                path.append((t, r))
                if t == t0:
                    break
                r_prev = par_t[t]
                bottleneck = min(bottleneck, flow[t, r_prev])
                r = r_prev
            for t, r in path:
                flow[t, r] += bottleneck
            r = r_end
            while True:
                t = par_r[r]
                if t == t0:
                    break
                r_prev = par_t[t]
                flow[t, r_prev] -= bottleneck
                r = r_prev
            remaining[t0] -= bottleneck
            cap_left[r_end] -= bottleneck
            # update potentials (finite entries only)
            fin_t = dist_t < INF
            fin_r = dist_r < INF
            pot_t[fin_t] += dist_t[fin_t]
            pot_r[fin_r] += dist_r[fin_r]
    return flow


class SNFAlg(DynamicAttnAlgorithm):
    def __init__(self, slack: float = 0.05) -> None:
        self.slack = slack

    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        tiles = cut_to_tiles(rects, ctx)
        if not tiles:
            return [AttnRectangles() for _ in range(ctx.cp_size)]
        assign = self._flow_assign(tiles, list(range(len(tiles))), ctx)
        return buckets_from_assignment(tiles, assign, ctx.cp_size)

    def _flow_assign(
        self, tiles: list[Tile], idxs: list[int], ctx: DynSolveContext
    ) -> list[int]:
        cp = ctx.cp_size
        supplies = np.array([tiles[i].area for i in idxs], dtype=np.int64)
        total = int(supplies.sum())
        cap = int(-(-total // cp) * (1 + self.slack)) + 1
        caps = np.full(cp, cap, dtype=np.int64)
        cost = np.array(
            [[_static_cost(tiles[i], r) for r in range(cp)] for i in idxs],
            dtype=np.int64,
        )
        flow = _ssp_transport(supplies, caps, cost)

        # round: majority rank per tile, then repair over-capacity ranks
        assign_sub = flow.argmax(axis=1)
        loads = np.zeros(cp, dtype=np.int64)
        for j, i in enumerate(idxs):
            loads[assign_sub[j]] += tiles[i].area
        order = np.argsort(-supplies)
        for j in order:
            r = assign_sub[j]
            if loads[r] <= cap:
                continue
            # move to the cheapest rank with room
            cand = [
                (cost[j, r2], loads[r2], r2)
                for r2 in range(cp)
                if r2 != r and loads[r2] + supplies[j] <= cap
            ]
            if cand:
                _, _, r2 = min(cand)
                loads[r] -= supplies[j]
                loads[r2] += supplies[j]
                assign_sub[j] = r2

        assign = [0] * len(tiles)
        for j, i in enumerate(idxs):
            assign[i] = int(assign_sub[j])
        return assign


class FastSNFAlg(SNFAlg):
    """SNF on the `max_flow_tiles` largest tiles; greedy tail placement."""

    def __init__(self, slack: float = 0.05, max_flow_tiles: int = 128) -> None:
        super().__init__(slack)
        self.max_flow_tiles = max_flow_tiles

    def solve(
        self, rects: AttnRectangles, ctx: DynSolveContext
    ) -> list[AttnRectangles]:
        tiles = cut_to_tiles(rects, ctx)
        if not tiles:
            return [AttnRectangles() for _ in range(ctx.cp_size)]
        order = sorted(
            range(len(tiles)), key=lambda i: tiles[i].area, reverse=True
        )
        head = order[: self.max_flow_tiles]
        tail = order[self.max_flow_tiles:]

        assign = self._flow_assign(tiles, head, ctx)

        # greedy tail with dedup-aware marginal comm (head commits first)
        states = [RankState() for _ in range(ctx.cp_size)]
        for i in head:
            commit(states[assign[i]], tiles[i], assign[i], ctx)
        total = sum(t.area for t in tiles)
        target = max(1, total // ctx.cp_size)
        for i in tail:
            t = tiles[i]
            best, best_cost = 0, None
            for r in range(ctx.cp_size):
                c = (
                    (states[r].load + t.area) / target
                    + marginal_comm_cost(states[r], t, r, ctx) / max(1, t.area)
                )
                if best_cost is None or c < best_cost:
                    best, best_cost = r, c
            assign[i] = best
            commit(states[best], t, best, ctx)
        return buckets_from_assignment(tiles, assign, ctx.cp_size)
