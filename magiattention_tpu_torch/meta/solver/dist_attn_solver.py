"""The static CP planner (ref: magi_attention/meta/solver/dist_attn_solver.py:206).

The port's copy of ``magiattention_tpu/meta/solver/dist_attn_solver.py`` (numpy only, imports
rewired).

Per rank, from the dispatched chunk assignment and the global slice metadata:

1. split every owned slice's needed k coverage into host (locally owned) vs
   remote rows (ref :440);
2. deduplicate remote requests per source rank — each remote row is fetched
   exactly once even if many slices touch it (the zero-redundant property);
3. lay out the remote-kv receive buffer (src-rank-major, ascending global
   ranges) and assign overlap stages by balanced row count (ref :944);
4. emit the transfer table + lowering index arrays (CommMeta, ref :1669) and
   the host/remote/merged band-slice lists in local coordinates (CalcMeta,
   ref :1839).

Band encoding makes every clip exact, so no slice-maker type re-derivation
(slice_maker.py) is needed: local bands are global bands shifted by the
(q, k) local-coordinate offsets.

All of this is deterministic host code computed identically on every rank
(no communication), exactly like the reference's transfer-table construction
(ref :1368 — "every rank computes all ranks' entries").
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass

import numpy as np

from ... import telemetry
from ...common.range import AttnRange, RangeError
from ...common.ranges import AttnRanges
from ...config import OverlapConfig
from ...kernels.mask_utils import BAND_INF
from ..collection.calc_meta import AttnArg, CalcMeta
from ..collection.comm_meta import CommMeta, GroupCollectiveArg
from ..collection.dispatch_meta import DispatchMeta
from ..container.bucket import AttnBucket
from ..container.slice import AttnSlice, band_area_batch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class _RemoteInterval:
    """One merged remote k interval in a rank's receive buffer."""

    src: int
    grange: AttnRange  # global coords
    stage: int = 0
    offset: int = 0  # local offset within its stage's receive buffer
    area: int = 0  # attention area computed against these rows


class _OwnerMap:
    """Flat sorted kv-ownership segments for O(log n) owner splits.

    Ownership ranges are disjoint across ranks (each global kv row has one
    owner), so a sorted flat list + bisect replaces the O(cp * ranges)
    per-source overlap scans (the solver hot loop the reference moves to
    C++, csrc/extensions/dyn_solver_alg.cpp)."""

    def __init__(self, kv_ranges: list[AttnRanges]) -> None:
        segs: list[tuple[int, int, int]] = []
        for owner, rs in enumerate(kv_ranges):
            for rg in rs:
                segs.append((rg.start, rg.end, owner))
        segs.sort()
        self.segs = segs
        self.starts = [s for s, _, _ in segs]

    def split(self, a: int, b: int):
        """Yield (start, end, owner) covering [a, b) ∩ segments."""
        i = bisect.bisect_right(self.starts, a) - 1
        if i < 0:
            i = 0
        for s, e, o in self.segs[i:]:
            if s >= b:
                break
            lo, hi = max(s, a), min(e, b)
            if lo < hi:
                yield lo, hi, o


class _IntervalIndex:
    """Sorted-start view over a rank's merged remote intervals.

    Merged intervals are disjoint in global coords (ownership is disjoint
    across sources), so a vectorized np.searchsorted over ``starts``
    resolves every deferred piece's interval at once — replacing the
    per-piece scans the round-1 VERDICT flagged (seconds-to-minutes at 1M
    tokens)."""

    def __init__(self, ivs: list[_RemoteInterval]) -> None:
        order = sorted(ivs, key=lambda iv: iv.grange.start)
        self.starts = [iv.grange.start for iv in order]
        self.ivs = order


class DistAttnSolver:
    """Static (kv-comm) context-parallel planner."""

    def __init__(
        self,
        bucket: AttnBucket,
        dispatch_meta: DispatchMeta,
        overlap_config: OverlapConfig | None = None,
        split_alignment: int = 128,
        dispatch_meta_kv: DispatchMeta | None = None,
        mesh_shape: tuple[int, int] | None = None,
    ) -> None:
        self.bucket = bucket
        self.meta = dispatch_meta
        # cross-attention: kv has its own dispatch (ownership) meta
        self.meta_kv = dispatch_meta_kv or dispatch_meta
        self.cp_size = dispatch_meta.cp_size
        self.overlap_config = overlap_config or OverlapConfig()
        self.split_alignment = split_alignment
        # two-level (dcn, ici) mesh: (n_outer, n_inner), ranks outer-major.
        # When set (and consistent with cp_size), every stage also gets a
        # phase-A/phase-B hier plan and the overlap solver prices the DCN
        # fabric separately.
        if mesh_shape is not None and (
            len(mesh_shape) != 2
            or mesh_shape[0] * mesh_shape[1] != self.cp_size
        ):
            raise ValueError(
                f"mesh_shape {mesh_shape} inconsistent with cp_size "
                f"{self.cp_size}"
            )
        self.mesh_shape = mesh_shape

    # ------------------------------------------------------------------

    def solve(self) -> tuple[CommMeta, CalcMeta]:
        t0 = time.perf_counter()
        cp = self.cp_size
        meta = self.meta
        shard_len = meta.shard_seqlen
        kv_shard_len = self.meta_kv.shard_seqlen
        host_ranges = meta.host_ranges_per_rank
        kv_ranges = self.meta_kv.host_ranges_per_rank
        degree = max(1, self.overlap_config.degree or 1)
        if not self.overlap_config.enable:
            degree = 1

        chunks_by_id = {c.chunk_id: c for c in self.bucket.q_chunks}
        self._owner_map = _OwnerMap(kv_ranges)
        # bisect locators, built once per rank: the per-slice global->local
        # remaps below were the 1M-token planning hot loop (O(n) scans +
        # re-merges inside make_ranges_local)
        self._kv_locators = [kv.locator() for kv in kv_ranges]
        own_locators = (
            self._kv_locators
            if host_ranges is kv_ranges
            else [h.locator() for h in host_ranges]
        )

        # ---- pass 1: per rank, split slice coverage into host/remote -----
        # host slice tuples per rank: (qs,qe,ks,ke,lo,hi) local coords
        host_slices: list[list[tuple[int, ...]]] = [[] for _ in range(cp)]
        # deferred remote pieces per rank: plain-int rows
        # (q_loc_start, q_loc_end, k_glob_start, k_glob_end, lo, hi, qoff) —
        # k local offset resolved after buffer layout; converted to (n, 7)
        # int64 arrays for the vectorized passes below
        deferred: list[list[tuple[int, ...]]] = [[] for _ in range(cp)]
        # remote requests per rank per src: global ranges
        requests: list[list[AttnRanges]] = [
            [AttnRanges() for _ in range(cp)] for _ in range(cp)
        ]

        for r in range(cp):
            for chunk_id in meta.partitions[r]:
                chunk = chunks_by_id[chunk_id]
                for s in chunk.attn_slices:
                    self._split_slice(
                        s, r, own_locators[r], self._kv_locators[r],
                        host_slices[r], deferred[r], requests[r],
                    )

        # ---- pass 2: merge requests, stage them, lay out buffers ---------
        intervals: list[list[_RemoteInterval]] = [[] for _ in range(cp)]
        deferred_np: list[np.ndarray] = []
        # cached per-rank (interval index, per-piece interval id) — pass 3
        # reuses the identical lookup
        deferred_ii: list[tuple[_IntervalIndex, np.ndarray] | None] = []
        for r in range(cp):
            for src in range(cp):
                for g in requests[r][src].merge():
                    intervals[r].append(_RemoteInterval(src=src, grange=g))
            # per-interval calc cost for the overlap solver — vectorized:
            # one searchsorted containment lookup + closed-form band areas
            # per rank (the per-piece Python loop was ~half the 1M-token
            # planning time)
            dm = (
                np.asarray(deferred[r], dtype=np.int64)
                if deferred[r]
                else np.zeros((0, 7), dtype=np.int64)
            )
            deferred_np.append(dm)
            if len(dm) == 0:
                deferred_ii.append(None)
                continue
            idx_r = _IntervalIndex(intervals[r])
            iv_starts = np.asarray(idx_r.starts, dtype=np.int64)
            iv_ends = np.asarray(
                [iv.grange.end for iv in idx_r.ivs], dtype=np.int64
            )
            ii = np.searchsorted(iv_starts, dm[:, 2], side="right") - 1
            if (
                len(iv_starts) == 0
                or (ii < 0).any()
                or (dm[:, 3] > iv_ends[ii]).any()
            ):
                bad = (
                    0
                    if len(iv_starts) == 0
                    else int(
                        np.argmax((ii < 0) | (dm[:, 3] > iv_ends[ii]))
                    )
                )
                raise RangeError(
                    f"deferred remote piece k range [{int(dm[bad, 2])}, "
                    f"{int(dm[bad, 3])}) outside the merged receive "
                    "intervals"
                )
            areas = band_area_batch(
                dm[:, 0] + dm[:, 6], dm[:, 1] + dm[:, 6],
                dm[:, 2], dm[:, 3], dm[:, 4], dm[:, 5],
            )
            acc = np.zeros(len(idx_r.ivs), dtype=np.int64)
            np.add.at(acc, ii, areas)
            for iv, a in zip(idx_r.ivs, acc):
                iv.area += int(a)
            deferred_ii.append((idx_r, ii))

        self._assign_stages(intervals, degree)
        # dynamic mode (degree=None) may pick any degree per rank: size the
        # stage tables to the max assigned stage
        degree = max(
            [degree]
            + [iv.stage + 1 for ivs in intervals for iv in ivs]
        )

        rank_stage_len: list[list[int]] = [[0] * degree for _ in range(cp)]
        for r in range(cp):
            for st in range(degree):
                off = 0
                for iv in intervals[r]:
                    if iv.stage != st:
                        continue
                    iv.offset = off
                    off += iv.grange.seqlen
                rank_stage_len[r][st] = off

        # drop stages empty on every rank (e.g. cp=1: no remote kv at all),
        # then pad each kept stage's receive length to the alignment
        kept = [
            st for st in range(degree)
            if max(rank_stage_len[r][st] for r in range(cp)) > 0
        ]
        remap = {st: i for i, st in enumerate(kept)}
        for r in range(cp):
            for iv in intervals[r]:
                iv.stage = remap[iv.stage]
        stage_recv_len = [
            _round_up(
                max(rank_stage_len[r][st] for r in range(cp)),
                self.split_alignment,
            )
            for st in kept
        ]
        degree = len(kept)

        # ---- pass 3: emit remote slices in buffer-local coords -----------
        # per (stage, rank): (n, 6) slice rows — an int64 array for ranks
        # with remote work, else the empty list (AttnArg.from_slices takes
        # either)
        remote_slices: list[list[np.ndarray | list]] = [
            [[] for _ in range(cp)] for _ in range(degree)
        ]
        merged_slices: list[np.ndarray | list] = [
            list(hs) for hs in host_slices
        ]
        # merged buffer: [kv shard | stage0 | stage1 | ...]
        stage_base = [kv_shard_len]
        for st in range(1, degree):
            stage_base.append(stage_base[-1] + stage_recv_len[st - 1])

        for r in range(cp):
            dm = deferred_np[r]
            if len(dm) == 0:
                continue
            idx_r, ii = deferred_ii[r]
            gstart = np.asarray(
                [iv.grange.start for iv in idx_r.ivs], dtype=np.int64
            )[ii]
            offset = np.asarray(
                [iv.offset for iv in idx_r.ivs], dtype=np.int64
            )[ii]
            stage = np.asarray(
                [iv.stage for iv in idx_r.ivs], dtype=np.int64
            )[ii]
            k0 = offset + (dm[:, 2] - gstart)
            k1 = k0 + (dm[:, 3] - dm[:, 2])
            koff = dm[:, 2] - k0
            inf_lo = dm[:, 4] <= -BAND_INF
            inf_hi = dm[:, 5] >= BAND_INF
            lo_l = np.where(inf_lo, dm[:, 4], dm[:, 4] + dm[:, 6] - koff)
            hi_l = np.where(inf_hi, dm[:, 5], dm[:, 5] + dm[:, 6] - koff)
            rows_rem = np.stack(
                [dm[:, 0], dm[:, 1], k0, k1, lo_l, hi_l], axis=1
            )
            mb = np.asarray(stage_base, dtype=np.int64)[stage]
            koff_m = koff - mb
            lo_m = np.where(inf_lo, dm[:, 4], dm[:, 4] + dm[:, 6] - koff_m)
            hi_m = np.where(inf_hi, dm[:, 5], dm[:, 5] + dm[:, 6] - koff_m)
            rows_mer = np.stack(
                [dm[:, 0], dm[:, 1], k0 + mb, k1 + mb, lo_m, hi_m], axis=1
            )
            for st in range(degree):
                sel = stage == st
                if sel.any():
                    remote_slices[st][r] = rows_rem[sel]
            host_arr = (
                np.asarray(host_slices[r], dtype=np.int64).reshape(-1, 6)
                if host_slices[r]
                else np.zeros((0, 6), dtype=np.int64)
            )
            merged_slices[r] = np.concatenate([host_arr, rows_mer])

        # ---- pass 4: comm args per stage ---------------------------------
        kv_stages = []
        for st in range(degree):
            kv_stages.append(
                self._make_group_collective_arg(
                    intervals, st, stage_recv_len[st]
                )
            )

        # two-level mesh: split each stage by fabric up front — the same
        # phase-A/phase-B plan the runtime would otherwise rebuild per
        # stage from the transfer table (functional/dist_attn.py), built
        # once here so it is cached and verified with the rest of the plan
        if self.mesh_shape is not None:
            from ...comm.hier import make_hier_group_cast_plan

            n_outer, n_inner = self.mesh_shape
            for s_arg in kv_stages:
                s_arg.hier_plan = make_hier_group_cast_plan(
                    s_arg.transfer_table, kv_ranges, n_outer, n_inner,
                    alignment=128, r_max=s_arg.r_max,
                    shard_len=kv_shard_len,
                )

        total_recv = sum(stage_recv_len)
        calc_meta = CalcMeta(
            host_args=[
                AttnArg.from_slices(host_slices[r], shard_len, kv_shard_len)
                for r in range(cp)
            ],
            remote_args_per_stage=[
                [
                    AttnArg.from_slices(
                        remote_slices[st][r], shard_len, stage_recv_len[st]
                    )
                    for r in range(cp)
                ]
                for st in range(degree)
            ],
            merged_args=[
                AttnArg.from_slices(
                    merged_slices[r], shard_len, kv_shard_len + total_recv
                )
                for r in range(cp)
            ],
            shard_len=shard_len,
            recv_len_per_stage=stage_recv_len,
            kv_shard_len=kv_shard_len,
        )
        comm_meta = CommMeta(
            kv_stages=kv_stages, kv_host_ranges=list(kv_ranges)
        )
        from ...env.general import is_sanity_check_enable

        if is_sanity_check_enable():
            _sanity_check_plan(
                comm_meta, calc_meta, kv_ranges, self.bucket, meta
            )
        if telemetry.enabled():
            rows_total = sum(
                iv.grange.seqlen for ivs in intervals for iv in ivs
            )
            telemetry.record_event(
                "plan_solve",
                planner="static",
                event="solve",
                source="cold",
                incremental=False,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                rows_total=rows_total,
                rows_resolved=rows_total,
                two_level=self.mesh_shape is not None,
                stages=degree,
            )
        return comm_meta, calc_meta

    # ------------------------------------------------------------------

    def _split_slice(
        self,
        s: AttnSlice,
        rank: int,
        own_locator,
        kv_locator,
        host_out: list[tuple[int, ...]],
        deferred_out: list[tuple[int, ...]],
        requests_out: list[AttnRanges],
    ) -> None:
        """Split one owned (chunk-clipped) slice into host/remote pieces.

        ``own_locator`` maps this rank's q rows global->local; ``kv_locator``
        maps its kv ownership (== q ownership for self-attn, separate
        dispatch for cross-attn). One locator ``segments`` sweep replaces
        the find_overlap/find_hole/make_ranges_local scans.
        """
        shrunk = s.shrink()
        if shrunk.q_range.is_empty():
            return
        q_glob = shrunk.q_range
        q_pieces = own_locator.to_local(q_glob.start, q_glob.end)
        if len(q_pieces) != 1:
            raise RangeError(
                f"q range {q_glob} spans multiple host pieces"
            )
        q_loc = AttnRange(*q_pieces[0])
        qoff = q_glob.start - q_loc.start
        needed_k = shrunk.needed_k_range()
        if needed_k.is_empty():
            return
        lo, hi = shrunk.d_lo, shrunk.d_hi

        for gs, ge, lstart in kv_locator.segments(
            needed_k.start, needed_k.end
        ):
            if lstart is not None:
                # local part: band offsets shift into local coords
                koff = gs - lstart
                lo_l = lo if lo <= -BAND_INF else lo + qoff - koff
                hi_l = hi if hi >= BAND_INF else hi + qoff - koff
                host_out.append(
                    (q_loc.start, q_loc.end, lstart, lstart + (ge - gs),
                     lo_l, hi_l)
                )
            else:
                # remote hole, split by owner (O(log n) owner-map bisect)
                for ps, pe, src in self._owner_map.split(gs, ge):
                    if src == rank:
                        continue
                    requests_out[src].append(AttnRange(ps, pe))
                    deferred_out.append(
                        (q_loc.start, q_loc.end, ps, pe, lo, hi, qoff)
                    )

    def _assign_stages(
        self, intervals: list[list[_RemoteInterval]], degree: int
    ) -> None:
        """Group each rank's intervals into overlap stages via OverlapSolver
        (uniform / greedy / dynamic-degree per overlap_config)."""
        if degree == 1 and self.overlap_config.degree is not None:
            return
        from .overlap_solver import OverlapItem, OverlapSolver

        solver = OverlapSolver(self.overlap_config)
        # two-level mesh: an interval whose source sits on another node
        # must cross DCN in phase A — price those rows on the slow fabric
        # so the dynamic-degree sweep can pipeline them under ICI stages
        # (post-dedup the true volume is lower; this is the per-rank bound)
        n_inner = self.mesh_shape[1] if self.mesh_shape is not None else 0
        for dst, ivs in enumerate(intervals):
            if not ivs:
                continue
            items = [
                OverlapItem(
                    rows=iv.grange.seqlen,
                    area=iv.area,
                    dcn_rows=(
                        iv.grange.seqlen
                        if n_inner and iv.src // n_inner != dst // n_inner
                        else 0
                    ),
                )
                for iv in ivs
            ]
            assign, _ = solver.solve(items)
            for iv, st in zip(ivs, assign):
                iv.stage = st

    def _make_group_collective_arg(
        self,
        intervals: list[list[_RemoteInterval]],
        stage: int,
        recv_len_padded: int,
    ) -> GroupCollectiveArg:
        cp = self.cp_size
        transfer_table = [[AttnRanges() for _ in range(cp)] for _ in range(cp)]
        # per-(src,dst) local row chunks as np arrays (vectorized — per-row
        # Python loops were the 1M-token planning bottleneck)
        send_chunks: list[list[list[np.ndarray]]] = [
            [[] for _ in range(cp)] for _ in range(cp)
        ]  # [src][dst]
        pair_count = np.zeros((cp, cp), dtype=np.int64)
        recv_parts: list[list[tuple[int, int, int]]] = [
            [] for _ in range(cp)
        ]  # [dst] -> (src, pos_in_pair, n)

        for dst in range(cp):
            # buffer order: interval order (src asc, grange asc) — matches
            # offsets assigned in solve()
            for iv in sorted(
                (iv for iv in intervals[dst] if iv.stage == stage),
                key=lambda iv: iv.offset,
            ):
                transfer_table[dst][iv.src].append(iv.grange)
                local_rows = self._kv_locators[iv.src].to_local(
                    iv.grange.start, iv.grange.end
                )
                start_pos = int(pair_count[iv.src, dst])
                n = 0
                for ls, le in local_rows:
                    send_chunks[iv.src][dst].append(
                        np.arange(ls, le, dtype=np.int32)
                    )
                    n += le - ls
                pair_count[iv.src, dst] += n
                recv_parts[dst].append((iv.src, start_pos, n))

        max_pair = int(pair_count.max()) if cp else 0
        a_cap = _round_up(max(max_pair, 1), self.split_alignment)

        send_idx = np.zeros((cp, cp, a_cap), dtype=np.int32)
        send_counts = np.zeros((cp, cp), dtype=np.int32)
        for s in range(cp):
            for d in range(cp):
                n = int(pair_count[s, d])
                send_counts[s, d] = n
                if n:
                    send_idx[s, d, :n] = np.concatenate(send_chunks[s][d])

        r_max = recv_len_padded
        recv_sel = np.zeros((cp, r_max), dtype=np.int32)
        recv_len = np.zeros((cp,), dtype=np.int32)
        for d in range(cp):
            parts = [
                src * a_cap + start_pos + np.arange(n, dtype=np.int32)
                for src, start_pos, n in recv_parts[d]
                if n
            ]
            flat = (
                np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)
            )
            recv_len[d] = flat.size
            recv_sel[d, : flat.size] = flat

        # ppermute lowering: one ring round per active distance delta, each
        # padded only to that distance's max pair — near zero-redundant for
        # skewed traffic (the TPU analogue of true per-pair a2av splits,
        # ref comm/primitive/grpcoll/utils.py:593)
        from ..collection.comm_meta import build_pp_lowering

        deltas, caps, pp_send_idx, pp_recv_sel = build_pp_lowering(
            pair_count,
            lambda s, d: np.concatenate(send_chunks[s][d]),
            recv_parts, r_max, min(self.split_alignment, 8),
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




def _arg_area(arg) -> int:
    """Total attention area of an AttnArg's band slices."""
    if arg.num_slices == 0:
        return 0
    return int(
        band_area_batch(
            arg.q_ranges[:, 0], arg.q_ranges[:, 1],
            arg.k_ranges[:, 0], arg.k_ranges[:, 1],
            arg.d_lo, arg.d_hi,
        ).sum()
    )


def _sanity_check_plan(
    comm_meta: CommMeta,
    calc_meta: CalcMeta,
    kv_ranges: list[AttnRanges],
    bucket: AttnBucket,
    meta: DispatchMeta,
) -> None:
    """Expensive plan invariants behind MAGI_ATTENTION_SANITY_CHECK=1
    (ref env/general.py:75-84; e.g. grpcoll/utils.py:294 meta-arg checks).

    Validates: transfer-table <-> send-count symmetry and ownership,
    receive-buffer lengths/bounds (both wire lowerings), slice extents, and
    the merged-area identity (merged == host + sum of remote stages).
    """
    cp = len(calc_meta.host_args)

    for st, s in enumerate(comm_meta.kv_stages):
        cp_t = len(s.transfer_table)
        assert cp_t == cp, f"stage {st}: transfer table size {cp_t} != {cp}"
        for dst in range(cp):
            recv_rows = 0
            for src in range(cp):
                rows = s.transfer_table[dst][src].total_seqlen
                recv_rows += rows
                # table <-> send_counts symmetry
                assert rows == int(s.send_counts[src, dst]), (
                    f"stage {st}: transfer_table[{dst}][{src}]={rows} rows "
                    f"!= send_counts[{src},{dst}]={int(s.send_counts[src, dst])}"
                )
                # every transferred range is owned by its source
                for g in s.transfer_table[dst][src]:
                    assert any(
                        g.is_subrange_of(own) for own in kv_ranges[src]
                    ), f"stage {st}: {g} not owned by src {src}"
            assert recv_rows == int(s.recv_len[dst]) <= s.r_max, (
                f"stage {st} dst {dst}: recv rows {recv_rows} != "
                f"recv_len {int(s.recv_len[dst])} (r_max {s.r_max})"
            )
        # lowering index arrays in bounds
        assert s.send_idx.max(initial=0) < max(calc_meta.kv_shard_len, 1), (
            f"stage {st}: send_idx beyond kv shard"
        )
        assert s.recv_sel.max(initial=0) < cp * s.a_cap
        if s.pp_recv_sel is not None:
            assert s.pp_recv_sel.max(initial=0) < sum(s.pp_caps)

    # slice extents + area identity per rank
    for r in range(cp):
        for name, arg in (
            ("host", calc_meta.host_args[r]),
            ("merged", calc_meta.merged_args[r]),
            *(
                (f"remote{st}", calc_meta.remote_args_per_stage[st][r])
                for st in range(len(calc_meta.remote_args_per_stage))
            ),
        ):
            if arg.num_slices:
                assert arg.q_ranges.min() >= 0 and arg.k_ranges.min() >= 0
                assert arg.q_ranges.max() <= arg.total_seqlen_q, (
                    f"rank {r} {name}: q slice beyond extent"
                )
                assert arg.k_ranges.max() <= arg.total_seqlen_k, (
                    f"rank {r} {name}: k slice beyond extent"
                )
        merged = _arg_area(calc_meta.merged_args[r])
        host = _arg_area(calc_meta.host_args[r])
        remote = sum(
            _arg_area(calc_meta.remote_args_per_stage[st][r])
            for st in range(len(calc_meta.remote_args_per_stage))
        )
        assert merged == host + remote, (
            f"rank {r}: merged area {merged} != host {host} + remote {remote}"
        )
