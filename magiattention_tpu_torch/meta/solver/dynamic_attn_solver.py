"""DynamicAttnSolver — the qo-comm CP planner.

The port's copy of ``magiattention_tpu/meta/solver/dynamic_attn_solver.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/solver/dynamic_attn_solver.py:47-608. Unlike the
static solver (q never moves; kv is fetched to the q owner), the dynamic
solver performs a *global* assignment of `AttnRectangle` workload to ranks:
any rank may compute any rectangle, fetching whichever of q / kv it doesn't
own and returning partial (out, lse) rows to the q owners, where they are
lse-merged. This can strictly reduce communication for masks whose workload
is concentrated on few ranks' kv (e.g. shared-prefix / sparse masks).

The assignment itself is delegated to a pluggable algorithm
(meta/solver/algorithms: NCQ / GRG / SNF / FastSNF / BinaryGreedy /
BinaryGreedyParallel). This module turns the per-rank rectangle buckets into
the executable `DynamicAttnPlan`:

- q/kv fetch GroupCollectiveArgs (dedup-merged per src, buffer laid out
  src-asc, range-asc — same zero-redundancy layout as the static solver),
- per-rank `AttnArg` band slices in compute-buffer coordinates,
- the partial-return GroupCollectiveArg + per-row merge-index matrix.

All of it is deterministic host code computed identically on every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ... import telemetry
from ...common.enum import DynamicAttnAlgType
from ...common.range import AttnRange, RangeError
from ...common.ranges import AttnRanges
from ...common.rectangle import AttnRectangle, AttnRectangles
from ...kernels.mask_utils import BAND_INF
from ..collection.calc_meta import AttnArg
from ..collection.comm_meta import GroupCollectiveArg
from ..collection.dispatch_meta import DispatchMeta
from ..collection.dynamic_meta import DynamicAttnPlan
from .algorithms import DynSolveContext, get_dynamic_alg


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _rect_key(rc: AttnRectangle) -> tuple[int, ...]:
    """Exact identity of one input rectangle (the mask-diff unit)."""
    return (
        rc.q_range.start, rc.q_range.end,
        rc.k_range.start, rc.k_range.end,
        rc.d_lo, rc.d_hi,
    )


def _rect_contains(rc: AttnRectangle, tile: AttnRectangle) -> bool:
    """Is ``tile`` an ownership-cut piece of input rectangle ``rc``?

    cut_to_tiles truncates only q/k ranges (never the band), so a tile
    belongs to rc iff both ranges are contained and the band matches."""
    return (
        tile.d_lo == rc.d_lo
        and tile.d_hi == rc.d_hi
        and tile.q_range.start >= rc.q_range.start
        and tile.q_range.end <= rc.q_range.end
        and tile.k_range.start >= rc.k_range.start
        and tile.k_range.end <= rc.k_range.end
    )


@dataclass
class DynSolveState:
    """Carryover from one dynamic solve to the next.

    Holds the solved mask's input rectangles and the per-rank tile buckets
    the algorithm produced, so the next step can diff its mask against this
    one and re-run the assignment algorithm only on rectangles that
    actually changed (the plan-rebuild passes always run in full — they are
    cheap next to the assignment search)."""

    rects: list[AttnRectangle]
    buckets: list[AttnRectangles]


class _BufSeg:
    """One contiguous global range living at a buffer offset."""

    __slots__ = ("grange", "buf_start", "src")

    def __init__(self, grange: AttnRange, buf_start: int, src: int) -> None:
        self.grange = grange
        self.buf_start = buf_start
        self.src = src


class DynamicAttnSolver:
    """Global (all-rank) rectangle planner with q/o movement."""

    def __init__(
        self,
        rects: AttnRectangles,
        dispatch_meta_q: DispatchMeta,
        dispatch_meta_kv: DispatchMeta | None = None,
        alg: DynamicAttnAlgType = DynamicAttnAlgType.BINARY_GREEDY,
        split_alignment: int = 128,
        **alg_kwargs,
    ) -> None:
        self.rects = rects
        self.meta_q = dispatch_meta_q
        self.meta_kv = dispatch_meta_kv or dispatch_meta_q
        self.cp_size = dispatch_meta_q.cp_size
        self.alg = alg
        self.alg_kwargs = alg_kwargs
        self.split_alignment = split_alignment
        self.bucket_per_rank: list[AttnRectangles] | None = None
        # post-solve carryover for the next step's incremental re-solve
        self.state: DynSolveState | None = None

    # ------------------------------------------------------------------

    def _incremental_buckets(
        self, ctx: DynSolveContext, prev: DynSolveState, algorithm
    ) -> tuple[list[AttnRectangles], int] | None:
        """Diff this mask against ``prev`` and reuse its assignment.

        Tiles of unchanged rectangles keep their previous rank; only added
        rectangles run the assignment algorithm. Returns (buckets, rows
        re-solved), or None when attribution is ambiguous (duplicate or
        overlapping rectangles) — the caller then falls back to a cold
        solve, which is always safe."""
        prev_by_key: dict[tuple[int, ...], AttnRectangle] = {}
        for rc in prev.rects:
            k = _rect_key(rc)
            if k in prev_by_key:
                return None
            prev_by_key[k] = rc
        new_keys: set[tuple[int, ...]] = set()
        added: list[AttnRectangle] = []
        for rc in self.rects:
            k = _rect_key(rc)
            if k in new_keys:
                return None
            new_keys.add(k)
            if k not in prev_by_key:
                added.append(rc)
        unchanged = new_keys & prev_by_key.keys()

        # attribute every previously assigned tile to its source rectangle;
        # tiles of unchanged rectangles are kept in place, tiles of removed
        # rectangles are dropped
        kept = [AttnRectangles() for _ in range(ctx.cp_size)]
        for r, bucket in enumerate(prev.buckets):
            for tile in bucket:
                matches = [
                    k for k, rc in prev_by_key.items()
                    if _rect_contains(rc, tile)
                ]
                if len(matches) != 1:
                    return None
                if matches[0] in unchanged:
                    kept[r].append(tile)
        if added:
            add_buckets = algorithm.solve(AttnRectangles(added), ctx)
            for r in range(ctx.cp_size):
                kept[r].extend(add_buckets[r])
        resolved = sum(rc.q_range.seqlen for rc in added)
        return kept, resolved

    def solve(self, prev_state: DynSolveState | None = None) -> DynamicAttnPlan:
        t0 = time.perf_counter()
        cp = self.cp_size
        host_q = [r.merge() for r in self.meta_q.host_ranges_per_rank]
        host_k = [r.merge() for r in self.meta_kv.host_ranges_per_rank]
        ctx = DynSolveContext(
            host_ranges_q=host_q, host_ranges_k=host_k, cp_size=cp
        )
        algorithm = get_dynamic_alg(self.alg, **self.alg_kwargs)
        rows_total = sum(rc.q_range.seqlen for rc in self.rects)
        rows_resolved = rows_total
        incremental = False
        buckets = None
        if prev_state is not None:
            from ...env.general import is_incremental_solve_enable

            if is_incremental_solve_enable():
                got = self._incremental_buckets(ctx, prev_state, algorithm)
                if got is not None:
                    buckets, rows_resolved = got
                    incremental = True
        if buckets is None:
            buckets = algorithm.solve(self.rects, ctx)
        self.bucket_per_rank = buckets
        self.state = DynSolveState(
            rects=list(self.rects), buckets=buckets
        )

        shard = self.meta_q.shard_seqlen
        kv_shard = self.meta_kv.shard_seqlen

        # ---- fetch requests (dedup-merged per (dst, src)) ----------------
        req_q = [[AttnRanges() for _ in range(cp)] for _ in range(cp)]
        req_k = [[AttnRanges() for _ in range(cp)] for _ in range(cp)]
        for r in range(cp):
            need_q = AttnRanges(
                [AttnRange(rc.q_range.start, rc.q_range.end) for rc in buckets[r]]
            ).merge()
            need_k = AttnRanges(
                [AttnRange(rc.k_range.start, rc.k_range.end) for rc in buckets[r]]
            ).merge()
            for src in range(cp):
                if src == r:
                    continue
                for hole in need_q.find_hole_ranges(host_q[r]):
                    for part in AttnRanges([hole]).find_overlap_ranges(
                        host_q[src]
                    ):
                        req_q[r][src].append(part)
                for hole in need_k.find_hole_ranges(host_k[r]):
                    for part in AttnRanges([hole]).find_overlap_ranges(
                        host_k[src]
                    ):
                        req_k[r][src].append(part)
            for src in range(cp):
                req_q[r][src] = req_q[r][src].merge()
                req_k[r][src] = req_k[r][src].merge()

        # ---- buffer layouts ----------------------------------------------
        # q buffer: [own shard rows (local coords) | fetched (src asc,
        # range asc)]; k buffer likewise
        q_segs: list[list[_BufSeg]] = []
        k_segs: list[list[_BufSeg]] = []
        q_recv_rows = [0] * cp
        k_recv_rows = [0] * cp
        for r in range(cp):
            segs = [
                _BufSeg(g, _local_offset(host_q[r], g), r) for g in host_q[r]
            ]
            off = shard
            for src in range(cp):
                for g in req_q[r][src]:
                    segs.append(_BufSeg(g, off, src))
                    off += g.seqlen
            q_recv_rows[r] = off - shard
            q_segs.append(segs)

            segs_k = [
                _BufSeg(g, _local_offset(host_k[r], g), r) for g in host_k[r]
            ]
            off = kv_shard
            for src in range(cp):
                for g in req_k[r][src]:
                    segs_k.append(_BufSeg(g, off, src))
                    off += g.seqlen
            k_recv_rows[r] = off - kv_shard
            k_segs.append(segs_k)

        q_recv_max = _round_up(max(max(q_recv_rows), 1), self.split_alignment)
        k_recv_max = _round_up(max(max(k_recv_rows), 1), self.split_alignment)
        q_buf_len = shard + q_recv_max
        k_buf_len = kv_shard + k_recv_max

        # ---- per-rank AttnArg in buffer coords ---------------------------
        attn_args = []
        for r in range(cp):
            slices = []
            for rect in buckets[r]:
                for qseg in q_segs[r]:
                    qi = rect.q_range.intersect(qseg.grange)
                    if qi.is_empty():
                        continue
                    qb = qseg.buf_start + (qi.start - qseg.grange.start)
                    qoff = qi.start - qb
                    for kseg in k_segs[r]:
                        ki = rect.k_range.intersect(kseg.grange)
                        if ki.is_empty():
                            continue
                        kb = kseg.buf_start + (ki.start - kseg.grange.start)
                        koff = ki.start - kb
                        lo, hi = rect.d_lo, rect.d_hi
                        lo_l = lo if lo <= -BAND_INF else lo + qoff - koff
                        hi_l = hi if hi >= BAND_INF else hi + qoff - koff
                        slices.append(
                            (qb, qb + qi.seqlen, kb, kb + ki.seqlen, lo_l, hi_l)
                        )
            attn_args.append(
                AttnArg.from_slices(slices, q_buf_len, k_buf_len)
            )

        # ---- fetch collective args ---------------------------------------
        q_cast = _make_cast_arg(
            req_q, host_q, cp, self.split_alignment, q_recv_max
        )
        kv_cast = _make_cast_arg(
            req_k, host_k, cp, self.split_alignment, k_recv_max
        )

        # ---- partial return + merge matrix -------------------------------
        # sender side: compute rank r returns out_buf rows of each fetched
        # interval to its q owner; receiver lays contributions out
        # (compute-rank asc, range asc)
        ret_pair_rows = np.zeros((cp, cp), dtype=np.int64)  # [compute][owner]
        ret_send_segs: list[list[tuple[int, int, int]]] = [
            [] for _ in range(cp)
        ]  # [compute] -> (owner, buf_start, n), in buffer order
        ret_recv_parts: list[list[tuple[int, AttnRange, int, int]]] = [
            [] for _ in range(cp)
        ]  # [owner] -> (compute_rank, grange, start_pos_in_pair, n)
        for r in range(cp):
            for seg in q_segs[r]:
                if seg.src == r:
                    continue
                owner = seg.src
                n = seg.grange.seqlen
                start_pos = int(ret_pair_rows[r, owner])
                ret_send_segs[r].append((owner, seg.buf_start, n))
                ret_pair_rows[r, owner] += n
                ret_recv_parts[owner].append(
                    (r, seg.grange, start_pos, n)
                )
        for owner in range(cp):
            ret_recv_parts[owner].sort(key=lambda t: (t[0], t[1].start))

        ret_a_cap = _round_up(
            max(int(ret_pair_rows.max()), 1), self.split_alignment
        )
        ret_rows = [
            sum(n for _, _, _, n in ret_recv_parts[d]) for d in range(cp)
        ]
        ret_len = _round_up(max(max(ret_rows), 1), self.split_alignment)

        ret_send_idx = np.zeros((cp, cp, ret_a_cap), dtype=np.int32)
        ret_counts = ret_pair_rows.astype(np.int32)
        fill = np.zeros((cp, cp), dtype=np.int64)
        for s in range(cp):
            for owner, buf_start, n in ret_send_segs[s]:
                pos = int(fill[s, owner])
                ret_send_idx[s, owner, pos: pos + n] = np.arange(
                    buf_start, buf_start + n, dtype=np.int32
                )
                fill[s, owner] += n
        ret_recv_sel = np.zeros((cp, ret_len), dtype=np.int32)
        ret_recv_len = np.zeros((cp,), dtype=np.int32)
        ret_table = [[AttnRanges() for _ in range(cp)] for _ in range(cp)]
        # owner-side offsets of each returned interval, for the merge matrix
        ret_offsets: list[dict[tuple[int, int, int], int]] = [
            {} for _ in range(cp)
        ]
        for d in range(cp):
            chunks: list[np.ndarray] = []
            off = 0
            for src, grange, start_pos, n in ret_recv_parts[d]:
                ret_table[d][src].append(grange)
                ret_offsets[d][(src, grange.start, grange.end)] = off
                chunks.append(
                    np.arange(
                        src * ret_a_cap + start_pos,
                        src * ret_a_cap + start_pos + n,
                        dtype=np.int32,
                    )
                )
                off += n
            ret_recv_len[d] = off
            if chunks:
                ret_recv_sel[d, :off] = np.concatenate(chunks)

        ret = GroupCollectiveArg(
            transfer_table=ret_table,
            send_idx=ret_send_idx,
            send_counts=ret_counts,
            recv_sel=ret_recv_sel,
            recv_len=ret_recv_len,
            a_cap=ret_a_cap,
            r_max=ret_len,
        )

        # ---- merge matrix ------------------------------------------------
        # own coverage: global q rows rank r computes locally
        own_cov = []
        for r in range(cp):
            cov = AttnRanges(
                [AttnRange(rc.q_range.start, rc.q_range.end) for rc in buckets[r]]
            ).merge()
            own_cov.append(cov.find_overlap_ranges(host_q[r]))

        dummy = q_buf_len + ret_len
        # vectorized: per owner, collect (row, source-index) pairs as arange
        # segments, stable-sort by row (local first, then ret-buffer order),
        # and place each pair in its row's next free column
        pairs: list[tuple[np.ndarray, np.ndarray]] = []
        m_max = 1
        for owner in range(cp):
            rows_chunks: list[np.ndarray] = []
            idx_chunks: list[np.ndarray] = []
            for g in own_cov[owner]:  # local contributions first
                loc = _local_offset(host_q[owner], g)
                rr = np.arange(loc, loc + g.seqlen, dtype=np.int64)
                rows_chunks.append(rr)
                idx_chunks.append(rr.astype(np.int32))
            # returned contributions (buffer order => deterministic merge)
            for src, grange, _, n in ret_recv_parts[owner]:
                base = q_buf_len + ret_offsets[owner][
                    (src, grange.start, grange.end)
                ]
                loc0 = _local_offset(host_q[owner], grange)
                rows_chunks.append(
                    np.arange(loc0, loc0 + n, dtype=np.int64)
                )
                idx_chunks.append(
                    np.arange(base, base + n, dtype=np.int32)
                )
            if rows_chunks:
                rows = np.concatenate(rows_chunks)
                idxs = np.concatenate(idx_chunks)
                order = np.argsort(rows, kind="stable")
                rows, idxs = rows[order], idxs[order]
                # column = position within the row's run (rows are sorted)
                cols = np.arange(len(rows), dtype=np.int64) - np.searchsorted(
                    rows, rows
                )
                if len(cols):
                    m_max = max(m_max, int(cols.max()) + 1)
                pairs.append((rows, cols, idxs))
            else:
                pairs.append(
                    (np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.int32))
                )

        merge_idx = np.full((cp, shard, m_max), dummy, dtype=np.int32)
        for r, (rows, cols, idxs) in enumerate(pairs):
            if len(rows):
                merge_idx[r, rows, cols] = idxs

        if telemetry.enabled():
            telemetry.record_event(
                "plan_solve",
                planner="dynamic",
                event="solve",
                source="cold",
                incremental=incremental,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                rows_total=rows_total,
                rows_resolved=rows_resolved,
                rects_total=len(self.rects),
            )
        return DynamicAttnPlan(
            q_cast=q_cast,
            kv_cast=kv_cast,
            ret=ret,
            attn_args=attn_args,
            merge_idx=merge_idx,
            shard_len=shard,
            kv_shard_len=kv_shard,
            q_buf_len=q_buf_len,
            k_buf_len=k_buf_len,
            ret_len=ret_len,
            solver_state=self.state,
        )


def _local_offset(own: AttnRanges, g: AttnRange) -> int:
    """Local (shard) offset of global position g.start within own ranges."""
    off = 0
    for r in own:
        if g.start >= r.start and g.start < r.end:
            return off + (g.start - r.start)
        off += r.seqlen
    raise RangeError(
        f"global range {g} is not owned by this shard's host ranges "
        f"{list(own)} — the dynamic solver produced an assignment that "
        "references rows outside the rank's dispatch ownership"
    )


def _make_cast_arg(
    requests: list[list[AttnRanges]],
    host_ranges: list[AttnRanges],
    cp: int,
    alignment: int,
    r_max: int,
) -> GroupCollectiveArg:
    """Build the GroupCast lowering arrays from (dst, src) requests.

    Receive-buffer order on dst: (src asc, range asc) — matching the
    compute-buffer segment layout built in solve().
    """
    send_segs: list[list[list[tuple[int, int]]]] = [
        [[] for _ in range(cp)] for _ in range(cp)
    ]  # [src][dst] -> (loc0, n) arange segments
    pair_rows = np.zeros((cp, cp), dtype=np.int64)
    transfer_table = [[AttnRanges() for _ in range(cp)] for _ in range(cp)]
    recv_parts: list[list[tuple[int, int, int]]] = [[] for _ in range(cp)]

    for dst in range(cp):
        for src in range(cp):
            for g in requests[dst][src]:
                transfer_table[dst][src].append(g)
                start_pos = int(pair_rows[src, dst])
                loc0 = _local_offset(host_ranges[src], g)
                send_segs[src][dst].append((loc0, g.seqlen))
                pair_rows[src, dst] += g.seqlen
                recv_parts[dst].append((src, start_pos, g.seqlen))

    a_cap = _round_up(max(int(pair_rows.max()), 1), alignment)

    send_idx = np.zeros((cp, cp, a_cap), dtype=np.int32)
    send_counts = pair_rows.astype(np.int32)
    for s in range(cp):
        for d in range(cp):
            pos = 0
            for loc0, n in send_segs[s][d]:
                send_idx[s, d, pos: pos + n] = np.arange(
                    loc0, loc0 + n, dtype=np.int32
                )
                pos += n

    recv_sel = np.zeros((cp, r_max), dtype=np.int32)
    recv_len = np.zeros((cp,), dtype=np.int32)
    for d in range(cp):
        chunks: list[np.ndarray] = []
        off = 0
        for src, start_pos, n in recv_parts[d]:
            chunks.append(
                np.arange(
                    src * a_cap + start_pos,
                    src * a_cap + start_pos + n,
                    dtype=np.int32,
                )
            )
            off += n
        recv_len[d] = off
        if chunks:
            recv_sel[d, :off] = np.concatenate(chunks)

    # ppermute lowering (shared planner — see comm_meta.build_pp_lowering)
    from ..collection.comm_meta import build_pp_lowering

    def _rows_for(s, d):
        return np.concatenate(
            [np.arange(loc0, loc0 + n, dtype=np.int32)
             for loc0, n in send_segs[s][d]]
        )

    deltas, caps, pp_send_idx, pp_recv_sel = build_pp_lowering(
        pair_rows, _rows_for, recv_parts, r_max, min(alignment, 8)
    )
    arg = GroupCollectiveArg(
        transfer_table=transfer_table,
        send_idx=send_idx,
        send_counts=send_counts,
        recv_sel=recv_sel,
        recv_len=recv_len,
        a_cap=a_cap,
        r_max=r_max,
        pp_deltas=tuple(deltas),
        pp_caps=tuple(caps),
        pp_send_idx=pp_send_idx,
        pp_recv_sel=pp_recv_sel,
    )
    from ..collection.comm_meta import pick_lowering

    arg.lowering = pick_lowering(arg)
    return arg
