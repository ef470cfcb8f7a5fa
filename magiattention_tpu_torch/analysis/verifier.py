"""Static plan verifier: prove R1-R5 over constructed plan metadata (the
port's copy of ``magiattention_tpu/analysis/verifier.py``).

Every rule takes the *already-built* host metadata objects — nothing here
touches devices or re-runs solvers — and appends structured
:class:`~.violation.Violation` records instead of asserting, so one pass
reports every problem at once (CI) and the runtime hook can decide what is
fatal (error severity) vs. advisory (warning).

The rule bodies deliberately re-derive expectations from first principles
(coverage algebra over ``AttnRanges``, closed-form band areas) rather than
replaying solver code paths: a bug shared by solver and verifier would
otherwise verify itself.

R1-R4 are the JAX package's rules as written: they read only numpy and the
plan objects, which are the JAX package's field for field. R5 is the
port's own. The JAX package's R5 asks the TPU lane quanta (block_q a
multiple of 8, block_k of 128) and sizes VMEM with its kernel checker's
byte model, so it would reject the port's own default 64 x 64 tile. The
port's R5 asks that each pass's tiles be an instance the Hopper kernels
are compiled for (``utils/mem_budget.py:compiled_tiles``, the
``kernels/tile_policy.py:CANDIDATES`` pairs, the 256-wide instances
included), that one CTA's shared memory at those tiles fit the card's
opt-in limit (``mem_budget.SMEM_PER_CTA``, by the formulas of each
kernel's ``Smem``), and, as in the JAX package, that the backward's
per-pass overrides divide the forward-padded geometry.
"""

from __future__ import annotations

import numpy as np

from ..common.range import AttnRange
from ..common.ranges import AttnRanges
from .violation import ERROR, WARNING, VerifyReport


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# R1 — slice well-formedness
# ---------------------------------------------------------------------------


def check_attn_arg(report: VerifyReport, arg, site: str) -> None:
    """R1 over one AttnArg's (N, 2) range arrays in local coordinates."""
    report.mark_run("R1")
    n = arg.num_slices
    if n == 0:
        return
    qr, kr = arg.q_ranges, arg.k_ranges
    d_lo, d_hi = arg.d_lo, arg.d_hi
    if qr.min() < 0 or kr.min() < 0:
        report.add("R1", ERROR, site, "negative range endpoint in slice set")
    bad = np.nonzero((qr[:, 0] > qr[:, 1]) | (kr[:, 0] > kr[:, 1]))[0]
    for i in bad[:4]:
        report.add(
            "R1", ERROR, f"{site} slice {int(i)}",
            f"inverted range q={qr[i].tolist()} k={kr[i].tolist()}",
        )
    if arg.total_seqlen_q and qr.max() > arg.total_seqlen_q:
        report.add(
            "R1", ERROR, site,
            f"q slice reaches {int(qr.max())} > extent {arg.total_seqlen_q}",
        )
    if arg.total_seqlen_k and kr.max() > arg.total_seqlen_k:
        report.add(
            "R1", ERROR, site,
            f"k slice reaches {int(kr.max())} > extent {arg.total_seqlen_k}",
        )
    # an inverted band on a non-empty rectangle attends nothing — a slice
    # that should have been dropped at construction
    nonempty = (qr[:, 0] < qr[:, 1]) & (kr[:, 0] < kr[:, 1])
    inv_band = np.nonzero(nonempty & (d_lo > d_hi))[0]
    for i in inv_band[:4]:
        report.add(
            "R1", WARNING, f"{site} slice {int(i)}",
            f"empty band [{int(d_lo[i])}, {int(d_hi[i])}] on non-empty "
            "rectangle (dead work item)",
        )


def check_global_slices(
    report: VerifyReport,
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    mask_types,
    total_seqlen_q: int,
    total_seqlen_k: int,
) -> None:
    """R1 over the user-level (q_range, k_range, mask_type) triples."""
    from ..common.enum import AttnMaskType

    report.mark_run("R1")
    if not (len(q_ranges) == len(k_ranges) == len(mask_types)):
        report.add(
            "R1", ERROR, "global slices",
            f"count mismatch: {len(q_ranges)} q vs {len(k_ranges)} k vs "
            f"{len(mask_types)} mask types",
        )
        return
    for i, (qr, kr, mt) in enumerate(zip(q_ranges, k_ranges, mask_types)):
        site = f"global slice {i}"
        if not qr.is_valid() or not kr.is_valid():
            report.add("R1", ERROR, site, f"invalid range q={qr} k={kr}")
            continue
        if qr.end > total_seqlen_q:
            report.add(
                "R1", ERROR, site,
                f"q range {qr} exceeds total_seqlen_q {total_seqlen_q}",
            )
        if kr.end > total_seqlen_k:
            report.add(
                "R1", ERROR, site,
                f"k range {kr} exceeds total_seqlen_k {total_seqlen_k}",
            )
        try:
            AttnMaskType.normalize(mt)
        except (KeyError, ValueError):
            report.add("R1", ERROR, site, f"unknown mask type {mt!r}")


def check_bucket(report: VerifyReport, bucket) -> None:
    """R1 over the chunked global bucket's AttnSlices."""
    report.mark_run("R1")
    for chunk in bucket.q_chunks:
        for j, s in enumerate(chunk.attn_slices):
            site = f"chunk {chunk.chunk_id} slice {j}"
            if not s.q_range.is_valid() or not s.k_range.is_valid():
                report.add(
                    "R1", ERROR, site,
                    f"invalid range q={s.q_range} k={s.k_range}",
                )
                continue
            if not s.q_range.is_subrange_of(chunk.q_range):
                report.add(
                    "R1", ERROR, site,
                    f"slice q {s.q_range} escapes chunk q {chunk.q_range}",
                )
            if not s.q_range.is_empty() and s.d_lo > s.d_hi:
                report.add(
                    "R1", WARNING, site,
                    f"empty band [{s.d_lo}, {s.d_hi}] survived chunking",
                )


# ---------------------------------------------------------------------------
# R2 — dispatch partition
# ---------------------------------------------------------------------------


def check_dispatch(
    report: VerifyReport,
    dispatch_meta,
    bucket=None,
    balance_bound: float = 2.0,
    capacities=None,
) -> None:
    """R2: the chunk->rank assignment partitions the sequence exactly once.

    ``balance_bound`` is the declared per-rank area bound relative to the
    balance lower bound ``max(ceil(total/cp), max_chunk_area)`` — exceeding
    it is a warning (the AUTO dispatcher may trade balance for comm volume
    on purpose), never an error.

    ``capacities`` (per-rank weights, see dispatch_solver.solve) switches
    the balance sub-check to its weighted form: per-rank completion time is
    ``area_r / w_r`` and the lower bound is
    ``max(total/sum(w_active), max_chunk/max_w)``. A rank with zero weight
    owning any chunk is an ERROR — a drained rank must receive no work.
    """
    report.mark_run("R2")
    meta = dispatch_meta
    site = "dispatch partitions"
    if meta.total_seqlen % meta.chunk_size:
        report.add(
            "R2", ERROR, site,
            f"total_seqlen {meta.total_seqlen} not divisible by chunk_size "
            f"{meta.chunk_size}",
        )
        return
    num_chunks = meta.total_seqlen // meta.chunk_size
    if len(meta.partitions) != meta.cp_size:
        report.add(
            "R2", ERROR, site,
            f"{len(meta.partitions)} rank partitions != cp_size "
            f"{meta.cp_size}",
        )
    seen: dict[int, int] = {}
    for r, part in enumerate(meta.partitions):
        if list(part) != sorted(part):
            report.add(
                "R2", ERROR, f"rank {r}",
                f"chunk list not ascending: {list(part)}",
            )
        for c in part:
            if not (0 <= c < num_chunks):
                report.add(
                    "R2", ERROR, f"rank {r}",
                    f"chunk id {c} outside [0, {num_chunks})",
                )
            elif c in seen:
                report.add(
                    "R2", ERROR, f"rank {r}",
                    f"chunk {c} already owned by rank {seen[c]} "
                    "(double-dispatched rows)",
                )
            else:
                seen[c] = r
    dropped = [c for c in range(num_chunks) if c not in seen]
    if dropped:
        report.add(
            "R2", ERROR, site,
            f"chunks never dispatched (rows fall out of the attention): "
            f"{dropped[:8]}{'...' if len(dropped) > 8 else ''}",
        )
    caps = None
    if capacities is not None and len(meta.partitions) == meta.cp_size:
        caps = [float(w) for w in capacities]
        if len(caps) != meta.cp_size:
            report.add(
                "R2", ERROR, site,
                f"{len(caps)} capacity weights != cp_size {meta.cp_size}",
            )
            caps = None
        else:
            for r, part in enumerate(meta.partitions):
                if caps[r] <= 0.0 and len(part) > 0:
                    report.add(
                        "R2", ERROR, f"rank {r}",
                        f"drained rank (capacity {caps[r]}) owns "
                        f"{len(part)} chunks — zero-weight ranks must "
                        "receive no work",
                    )
    if bucket is not None and not dropped and meta.cp_size > 0:
        areas = {c.chunk_id: c.area for c in bucket.q_chunks}
        if len(areas) == num_chunks and sum(areas.values()) > 0:
            per_rank = [
                sum(areas[c] for c in part) for part in meta.partitions
            ]
            if caps is not None and any(w > 0 for w in caps):
                active = [w for w in caps if w > 0]
                lb = max(
                    sum(areas.values()) / sum(active),
                    max(areas.values()) / max(active),
                )
                times = [
                    per_rank[r] / caps[r]
                    for r in range(meta.cp_size)
                    if caps[r] > 0
                ]
                if lb and times and max(times) > balance_bound * lb:
                    report.add(
                        "R2", WARNING, site,
                        f"weighted per-rank time {max(times):.1f} exceeds "
                        f"balance bound {balance_bound} x weighted lower "
                        f"bound {lb:.1f} (per_rank={per_rank}, "
                        f"capacities={caps})",
                    )
            else:
                lb = max(
                    -(-sum(areas.values()) // meta.cp_size),
                    max(areas.values()),
                )
                if lb and max(per_rank) > balance_bound * lb:
                    report.add(
                        "R2", WARNING, site,
                        f"per-rank area {max(per_rank)} exceeds balance "
                        f"bound {balance_bound} x lower bound {lb} "
                        f"(per_rank={per_rank})",
                    )


# ---------------------------------------------------------------------------
# R3 — zero-redundancy comms
# ---------------------------------------------------------------------------


def check_group_collective_arg(
    report: VerifyReport,
    arg,
    site: str,
    split_alignment: int = 128,
    src_shard_len: int | None = None,
    src_host_ranges: list[AttnRanges] | None = None,
) -> None:
    """R3 structural checks on one GroupCollectiveArg (any cast stream).

    Verifies the transpose-consistency of the wire program: send counts
    mirror the transfer table, receive selections mirror send positions
    exactly once (the same index algebra whose transpose is the
    GroupReduce — a double-selected row would double-count in the reduce),
    and every padded capacity is the minimal aligned cover of the true
    payload.
    """
    report.mark_run("R3")
    cp = arg.send_counts.shape[0]
    counts = arg.send_counts

    for dst in range(cp):
        for src in range(cp):
            rows = arg.transfer_table[dst][src].total_seqlen
            if rows != int(counts[src, dst]):
                report.add(
                    "R3", ERROR, f"{site} transfer_table[{dst}][{src}]",
                    f"{rows} table rows != send_counts {int(counts[src, dst])}",
                )
        recv = int(counts[:, dst].sum())
        if recv != int(arg.recv_len[dst]):
            report.add(
                "R3", ERROR, f"{site} dst {dst}",
                f"recv_len {int(arg.recv_len[dst])} != summed send counts "
                f"{recv}",
            )
        if int(arg.recv_len[dst]) > arg.r_max:
            report.add(
                "R3", ERROR, f"{site} dst {dst}",
                f"recv_len {int(arg.recv_len[dst])} overflows r_max "
                f"{arg.r_max}",
            )

    # wire rows may exceed payload rows only via declared alignment padding:
    # every capacity must be the minimal aligned cover of its max pair
    max_pair = int(counts.max()) if counts.size else 0
    want_cap = _round_up(max(max_pair, 1), split_alignment)
    if arg.a_cap != want_cap:
        report.add(
            "R3", ERROR if arg.a_cap < max_pair else WARNING, site,
            f"a_cap {arg.a_cap} is not the minimal aligned capacity "
            f"{want_cap} for max pair {max_pair} (alignment "
            f"{split_alignment}): undeclared wire padding",
        )
    want_rmax = _round_up(
        max(int(arg.recv_len.max()) if cp else 0, 1), split_alignment
    )
    if arg.r_max < int(arg.recv_len.max() if cp else 0):
        pass  # already reported as overflow above
    elif arg.r_max > want_rmax:
        report.add(
            "R3", WARNING, site,
            f"r_max {arg.r_max} exceeds minimal aligned receive length "
            f"{want_rmax}: undeclared buffer padding",
        )

    if arg.pp_caps:
        pp_align = min(split_alignment, 8)
        for delta, cap in zip(arg.pp_deltas, arg.pp_caps):
            mx = max(
                int(counts[s, (s + delta) % cp]) for s in range(cp)
            )
            if cap != _round_up(max(mx, 1), pp_align):
                report.add(
                    "R3", ERROR if cap < mx else WARNING,
                    f"{site} ppermute delta {delta}",
                    f"cap {cap} not minimal aligned cover of max pair {mx}",
                )

    # recv_sel: every selected flat slot must point at a filled send
    # position of the (src, dst) pair, each exactly once
    for dst in range(cp):
        n = int(arg.recv_len[dst])
        sel = np.asarray(arg.recv_sel[dst, :n], dtype=np.int64)
        if n == 0:
            continue
        if sel.min() < 0 or sel.max() >= cp * arg.a_cap:
            report.add(
                "R3", ERROR, f"{site} dst {dst}",
                "recv_sel index outside the (cp * a_cap) receive buffer",
            )
            continue
        if len(np.unique(sel)) != n:
            report.add(
                "R3", ERROR, f"{site} dst {dst}",
                "recv_sel selects a wire slot more than once "
                "(rows would double-count in the transpose reduce)",
            )
        srcs, pos = sel // arg.a_cap, sel % arg.a_cap
        over = pos >= counts[srcs, dst]
        if over.any():
            report.add(
                "R3", ERROR, f"{site} dst {dst}",
                f"recv_sel selects {int(over.sum())} padding slot(s) "
                "beyond the pair's send count",
            )

    # send_idx: gathered local rows must be in-bounds and mirror the
    # transfer table exactly (same rows, same order)
    for src in range(cp):
        for dst in range(cp):
            n = int(counts[src, dst])
            if n == 0:
                continue
            idx = np.asarray(arg.send_idx[src, dst, :n], dtype=np.int64)
            if idx.min() < 0 or (
                src_shard_len is not None and idx.max() >= src_shard_len
            ):
                report.add(
                    "R3", ERROR, f"{site} send_idx[{src}][{dst}]",
                    f"local row index outside [0, {src_shard_len})",
                )
                continue
            if src_host_ranges is not None:
                loc = src_host_ranges[src].locator()
                try:
                    want = np.concatenate(
                        [
                            np.arange(ls, le, dtype=np.int64)
                            for g in arg.transfer_table[dst][src]
                            for ls, le in loc.to_local(g.start, g.end)
                        ]
                    )
                except Exception as e:  # RangeError: rows not owned by src
                    report.add(
                        "R3", ERROR, f"{site} transfer_table[{dst}][{src}]",
                        f"cast rows not owned by source rank {src}: {e}",
                    )
                    continue
                if len(want) != n or (idx != want).any():
                    report.add(
                        "R3", ERROR, f"{site} send_idx[{src}][{dst}]",
                        "gathered local rows do not mirror the transfer "
                        "table's cast rows",
                    )


def check_hier_plan(report, plan, arg, host_ranges, site: str) -> None:
    """R3 fabric-split sub-check for a two-level (DCN x ICI) stage plan.

    First-principles simulation with global row ids: run the phase-A
    gather/exchange over the dcn axis, then the phase-B forwarding over the
    ici axis, and require the final receive buffer to reconstruct the flat
    plan's receive buffer row-for-row (the phase-A + phase-B row multisets
    are exactly the flat sends — zero-redundancy preserved across fabrics).
    Additionally, every cross-node (dst node, src) row must cross the DCN
    exactly once, and intra-node rows must never touch it.
    """
    report.mark_run("R3")
    n_outer, n_inner = plan.n_outer, plan.n_inner
    cp = plan.cp_size
    if cp != arg.send_counts.shape[0] or n_outer * n_inner != cp:
        report.add(
            "R3", ERROR, site,
            f"hier plan geometry ({n_outer}x{n_inner}) inconsistent with "
            f"the stage's cp {arg.send_counts.shape[0]}",
        )
        return

    # per-rank global row ids of the kv shard (locator order), -1 padded
    shard_ids = np.full((cp, plan.shard_len), -1, dtype=np.int64)
    for r in range(cp):
        chunks = [
            np.arange(g.start, g.end, dtype=np.int64) for g in host_ranges[r]
        ]
        flat = (
            np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
        )
        if flat.size > plan.shard_len:
            report.add(
                "R3", ERROR, site,
                f"rank {r} owns {flat.size} rows > hier shard_len "
                f"{plan.shard_len}",
            )
            return
        shard_ids[r, : flat.size] = flat

    # phase A over the dcn axis: rank (o_s, i) -> aligned peer (o_d, i)
    a_cap = plan.a_send_idx.shape[2]
    ra = plan.a_recv_sel.shape[1]
    recv_a = np.full((cp, ra), -1, dtype=np.int64)
    crossed: dict[tuple[int, int], np.ndarray] = {}  # (dst_node, src) -> gids
    for r in range(cp):
        o_d, i = divmod(r, n_inner)
        n = int(plan.a_recv_len[r])
        if n == 0:
            continue
        sel = np.asarray(plan.a_recv_sel[r, :n], dtype=np.int64)
        if sel.min() < 0 or sel.max() >= n_outer * a_cap:
            report.add(
                "R3", ERROR, f"{site} hier phase A dst {r}",
                "a_recv_sel index outside the (n_outer * a_cap) buffer",
            )
            return
        o_s, pos = sel // a_cap, sel % a_cap
        src = o_s * n_inner + i
        local = np.asarray(plan.a_send_idx, dtype=np.int64)[src, o_d, pos]
        gids = shard_ids[src, local]
        recv_a[r, :n] = gids
        for s in np.unique(src):
            got = gids[src == s]
            key = (o_d, int(s))
            crossed[key] = (
                np.concatenate([crossed[key], got]) if key in crossed else got
            )

    # exactly-once DCN crossing per (dst node, src): the phase-A rows must
    # be the dedup-merged union of the node's flat requests from that src
    total_dcn = 0
    for o_d in range(n_outer):
        for src in range(cp):
            expect_ranges = AttnRanges()
            for d in range(o_d * n_inner, (o_d + 1) * n_inner):
                for g in arg.transfer_table[d][src]:
                    expect_ranges.append(g)
            expect = (
                np.concatenate(
                    [
                        np.arange(g.start, g.end, dtype=np.int64)
                        for g in expect_ranges.merge()
                    ]
                )
                if len(expect_ranges)
                else np.zeros(0, dtype=np.int64)
            )
            got = np.sort(crossed.get((o_d, src), np.zeros(0, np.int64)))
            if src // n_inner == o_d:
                if got.size:
                    report.add(
                        "R3", ERROR, f"{site} hier node {o_d} src {src}",
                        f"{got.size} intra-node rows crossed the DCN",
                    )
                continue
            total_dcn += got.size
            if got.size != expect.size or (
                got.size and (got != np.sort(expect)).any()
            ):
                report.add(
                    "R3", ERROR, f"{site} hier node {o_d} src {src}",
                    f"phase-A rows ({got.size}) are not the exactly-once "
                    f"dedup of the node's flat requests ({expect.size})",
                )
    if total_dcn != plan.dcn_rows():
        report.add(
            "R3", ERROR, site,
            f"dcn_rows() {plan.dcn_rows()} != simulated DCN crossings "
            f"{total_dcn}",
        )

    # phase B over the ici axis from [shard | recv_a], then byte-identity
    # of the final buffer with the flat plan's receive buffer
    buf_ids = np.concatenate([shard_ids, recv_a], axis=1)
    b_cap = plan.b_send_idx.shape[2]
    b_send = np.asarray(plan.b_send_idx, dtype=np.int64)
    for dst in range(cp):
        o, i_d = divmod(dst, n_inner)
        n = int(arg.recv_len[dst])
        if n == 0:
            continue
        sel = np.asarray(plan.b_recv_sel[dst, :n], dtype=np.int64)
        if sel.min() < 0 or sel.max() >= n_inner * b_cap:
            report.add(
                "R3", ERROR, f"{site} hier phase B dst {dst}",
                "b_recv_sel index outside the (n_inner * b_cap) buffer",
            )
            return
        i_s, pos = sel // b_cap, sel % b_cap
        src = o * n_inner + i_s
        local = b_send[src, i_d, pos]
        if local.size and local.max() >= buf_ids.shape[1]:
            report.add(
                "R3", ERROR, f"{site} hier phase B dst {dst}",
                "b_send_idx beyond the [shard | phase-A recv] buffer",
            )
            return
        final = buf_ids[src, local]
        fsel = np.asarray(arg.recv_sel[dst, :n], dtype=np.int64)
        fsrc, fpos = fsel // arg.a_cap, fsel % arg.a_cap
        flat = shard_ids[
            fsrc, np.asarray(arg.send_idx, dtype=np.int64)[fsrc, dst, fpos]
        ]
        if (final != flat).any():
            report.add(
                "R3", ERROR, f"{site} hier dst {dst}",
                f"{int((final != flat).sum())} rows of the two-phase "
                "receive buffer diverge from the flat plan's buffer",
            )


def _remote_demand(bucket, dispatch_meta, kv_own: AttnRanges, rank: int):
    """Global kv rows rank's slices need but the rank does not own."""
    chunks_by_id = {c.chunk_id: c for c in bucket.q_chunks}
    need = AttnRanges()
    for cid in dispatch_meta.partitions[rank]:
        chunk = chunks_by_id.get(cid)
        if chunk is None:
            continue
        for s in chunk.attn_slices:
            nk = s.shrink().needed_k_range()
            if not nk.is_empty():
                need.append(nk)
    return need.merge().find_hole_ranges(kv_own, is_self_merged=True)


def check_comm_demand(
    report: VerifyReport,
    comm_meta,
    dispatch_meta,
    bucket,
    dispatch_meta_kv=None,
) -> None:
    """R3 coverage: per rank, cast rows across all stages are pairwise
    disjoint (each remote row fetched exactly once — the zero-redundancy
    claim) and exactly equal to the remote KV demand derived independently
    from the slice set."""
    report.mark_run("R3")
    cp = dispatch_meta.cp_size
    kv_meta = dispatch_meta_kv or dispatch_meta
    kv_ranges = comm_meta.kv_host_ranges or kv_meta.host_ranges_per_rank
    for dst in range(cp):
        cast = AttnRanges()
        for st, s in enumerate(comm_meta.kv_stages):
            for src in range(cp):
                if src == dst and s.transfer_table[dst][src].total_seqlen:
                    report.add(
                        "R3", ERROR, f"kv_stage{st} dst {dst}",
                        "self-transfer in the kv cast (locally owned rows "
                        "must not cross the wire)",
                    )
                cast.extend(s.transfer_table[dst][src])
        dup = cast.find_overlap_ranges_with_self()
        if not dup.is_empty():
            report.add(
                "R3", ERROR, f"dst {dst}",
                f"cast rows requested more than once across stages: {dup} "
                "(redundant transfer, double-counted in GroupReduce)",
            )
        demand = _remote_demand(bucket, dispatch_meta, kv_ranges[dst], dst)
        missing = demand.find_hole_ranges(cast)
        extra = cast.find_hole_ranges(demand)
        if not missing.is_empty():
            report.add(
                "R3", ERROR, f"dst {dst}",
                f"remote KV demand not covered by any cast stage: {missing}",
            )
        if not extra.is_empty():
            report.add(
                "R3", ERROR, f"dst {dst}",
                f"cast rows no slice needs: {extra} (redundant transfer)",
            )


# ---------------------------------------------------------------------------
# R4 — overlap staging
# ---------------------------------------------------------------------------


def _arg_areas(arg) -> int:
    from ..meta.container.slice import band_area_batch

    if arg.num_slices == 0:
        return 0
    return int(
        band_area_batch(
            arg.q_ranges[:, 0], arg.q_ranges[:, 1],
            arg.k_ranges[:, 0], arg.k_ranges[:, 1],
            arg.d_lo, arg.d_hi,
        ).sum()
    )


def check_overlap(report: VerifyReport, comm_meta, calc_meta) -> None:
    """R4: the stage partition covers all remote work and CommMeta /
    CalcMeta agree on the overlap degree and per-stage buffer lengths."""
    report.mark_run("R4")
    degree = comm_meta.overlap_degree
    n_remote = len(calc_meta.remote_args_per_stage)
    n_lens = len(calc_meta.recv_len_per_stage)
    if not (degree == n_remote == n_lens):
        report.add(
            "R4", ERROR, "overlap degree",
            f"CommMeta has {degree} stages but CalcMeta has {n_remote} "
            f"remote-arg stages and {n_lens} recv lengths",
        )
    for st in range(min(degree, n_remote, n_lens)):
        s = comm_meta.kv_stages[st]
        if s.r_max != calc_meta.recv_len_per_stage[st]:
            report.add(
                "R4", ERROR, f"stage {st}",
                f"comm r_max {s.r_max} != calc recv_len_per_stage "
                f"{calc_meta.recv_len_per_stage[st]}",
            )
        for r, arg in enumerate(calc_meta.remote_args_per_stage[st]):
            if arg.total_seqlen_k != calc_meta.recv_len_per_stage[st]:
                report.add(
                    "R4", ERROR, f"stage {st} rank {r}",
                    f"remote arg extent {arg.total_seqlen_k} != stage "
                    f"recv length {calc_meta.recv_len_per_stage[st]}",
                )
        if int(np.asarray(s.recv_len).max(initial=0)) == 0:
            report.add(
                "R4", WARNING, f"stage {st}",
                "stage receives zero rows on every rank (dead stage)",
            )
    # merged extent and the area identity: merged == host + sum(remote) —
    # remote work dropped from (or invented by) the staging shows up here
    total_recv = sum(calc_meta.recv_len_per_stage)
    for r in range(len(calc_meta.host_args)):
        merged = calc_meta.merged_args[r]
        want_k = (calc_meta.kv_shard_len or 0) + total_recv
        if merged.total_seqlen_k != want_k:
            report.add(
                "R4", ERROR, f"rank {r}",
                f"merged arg k extent {merged.total_seqlen_k} != kv shard "
                f"+ stage buffers {want_k}",
            )
        host_a = _arg_areas(calc_meta.host_args[r])
        remote_a = sum(
            _arg_areas(stage_args[r])
            for stage_args in calc_meta.remote_args_per_stage
        )
        merged_a = _arg_areas(merged)
        if merged_a != host_a + remote_a:
            report.add(
                "R4", ERROR, f"rank {r}",
                f"stage partition loses work: merged area {merged_a} != "
                f"host {host_a} + remote {remote_a}",
            )


# ---------------------------------------------------------------------------
# R5 — tile legality
# ---------------------------------------------------------------------------


# the kernel of each pass of the FFA path (utils/mem_budget.py); the fused
# backward runs at the dk/dv pass's tiles where it is compiled, else the
# split pair does, so the dk/dv kernel is the one every pair must have
_PASS_KERNELS = (("fwd", "fwd"), ("dq", "dq"), ("dkv", "dkv"))


def check_tiles(
    report: VerifyReport,
    fwd_blocks: tuple[int, int],
    sq: int,
    sk: int,
    dq_blocks: tuple[int, int] | None = None,
    dkv_blocks: tuple[int, int] | None = None,
    head_dim: int = 128,
    head_dim_v: int = 128,
    itemsize: int = 2,
) -> None:
    """R5: each pass's (block_q, block_k) is an instance the Hopper
    kernels are compiled for at this dtype and compiled width, one CTA's
    shared memory there fits the card's opt-in limit, and the backward's
    overrides divide the forward-padded geometry. A backward pass without
    an override runs at the forward's tiles, and is checked there.

    The shared memory is the kernel's ``Smem`` written out on the host
    (``utils/mem_budget.py``, the figures ``chip_smoke.py`` holds equal to
    each library's ``<name>_smem_bytes``); a dk/dv pair is checked for the
    split dk/dv kernel, which every backward mode can fall to. The JAX package also refuses a non-dividing override; here each pass
    has its own plan and masks its ragged edge, so the rule holds the port
    to the JAX package's contract rather than to a limit of its own."""
    from ..kernels.head_dims import kernel_head_dim
    from ..utils import mem_budget

    report.mark_run("R5")
    try:
        width = kernel_head_dim(head_dim, head_dim_v)
    except ValueError as e:
        report.add("R5", ERROR, "head dims", str(e))
        return
    limit = mem_budget.SMEM_PER_CTA
    blocks = {"fwd": fwd_blocks, "dq": dq_blocks or fwd_blocks, "dkv": dkv_blocks or fwd_blocks}
    for name, kernel in _PASS_KERNELS:
        b_q, b_k = blocks[name]
        if b_q <= 0 or b_k <= 0:
            report.add("R5", ERROR, f"{name} blocks", f"({b_q}, {b_k}) not positive")
            continue
        smem = mem_budget.ffa_smem_bytes(kernel, width, b_q, b_k, itemsize)
        if smem > limit:
            report.add(
                "R5", ERROR, f"{name} blocks",
                f"({b_q}, {b_k}) at width {width}, itemsize {itemsize}: one "
                f"{kernel} CTA takes {smem} bytes of shared memory, over the "
                f"opt-in limit {limit}",
            )
        elif not mem_budget.is_compiled(kernel, itemsize, width, b_q, b_k):
            report.add(
                "R5", ERROR, f"{name} blocks",
                f"({b_q}, {b_k}) is no compiled {kernel} instance at width "
                f"{width}, itemsize {itemsize} (compiled: "
                f"{list(mem_budget.compiled_tiles(kernel, itemsize, width))})",
            )
    sqp, skp = _round_up(max(sq, 1), fwd_blocks[0]), _round_up(max(sk, 1), fwd_blocks[1])
    for kind, over in (("dq", dq_blocks), ("dkv", dkv_blocks)):
        if over is None or over[0] <= 0 or over[1] <= 0:
            continue
        if sqp % over[0] or skp % over[1]:
            report.add(
                "R5", ERROR, f"{kind} blocks",
                f"({over[0]}, {over[1]}) does not divide the fwd-padded geometry "
                f"({sqp}, {skp})",
            )


def check_plan_extents(report: VerifyReport, plan, quanta: tuple[int, int] | None = None) -> None:
    """R5, extent half: an FFA plan's live-extent meta columns (EQ0..EK1)
    AND its q-visit flag columns (QVF/QVL — the fused backward's dq
    revisit init/flush guards) must equal the host recomputation from its
    own 9-col band geometry, for BOTH triples (q-major and k-major), and
    the executed-element count they imply must not exceed the padded tile
    work. The kernels read the live extents and the q-visit flags off these
    columns, so a stale or truncated row silently drops attention mass.
    ``quanta`` is the extents' rounding the plan was built at (default the
    port's ``DEFAULT_QUANTA``, exact extents)."""
    from ..kernels.ffa_plan import (
        EQ0,
        META_DIM,
        _extend_meta_extents,
        _extend_meta_visits,
        plan_extent_stats,
    )

    from ..kernels.ffa_plan import DEFAULT_QUANTA

    quanta = DEFAULT_QUANTA if quanta is None else quanta
    report.mark_run("R5")
    triples = (
        ("meta", plan.meta, plan.work_qt, plan.work_kt),
        ("meta_t", plan.meta_t, plan.work_qt_t, plan.work_kt_t),
    )
    for which, meta, wq, wk in triples:
        meta = np.asarray(meta)
        if meta.ndim != 2 or meta.shape[1] != META_DIM:
            report.add(
                "R5", ERROR, which,
                f"plan meta has {meta.shape} columns, expected {META_DIM} "
                "(9 band cols + 4 live-extent cols + 2 q-visit cols)",
            )
            continue
        want = _extend_meta_visits(
            _extend_meta_extents(
                meta[:, :EQ0].astype(np.int32), np.asarray(wq),
                np.asarray(wk), plan.block_q, plan.block_k, quanta,
            ),
            np.asarray(wq),
        )
        bad = np.nonzero((meta != want).any(axis=1))[0]
        for w in bad[:8]:
            report.add(
                "R5", ERROR, f"{which}[{int(w)}]",
                f"extent columns {meta[w, EQ0:].tolist()} != host "
                f"recomputation {want[w, EQ0:].tolist()} from the row's "
                "band geometry",
            )
        if len(bad) > 8:
            report.add(
                "R5", ERROR, which,
                f"... and {len(bad) - 8} more extent rows disagree",
            )
    stats = plan_extent_stats(plan)
    if stats["executed_elems"] > stats["padded_elems"]:
        report.add(
            "R5", ERROR, "extent_stats",
            f"executed elements {stats['executed_elems']} exceed the "
            f"padded tile work {stats['padded_elems']} — extents escape "
            "their tiles",
        )


# ---------------------------------------------------------------------------
# orchestrators
# ---------------------------------------------------------------------------


def verify_plan(
    *,
    dispatch_meta=None,
    bucket=None,
    comm_meta=None,
    calc_meta=None,
    dispatch_meta_kv=None,
    global_slices=None,
    tile_blocks=None,
    tile_geom=None,
    split_alignment: int = 128,
    balance_bound: float = 2.0,
    capacities=None,
) -> VerifyReport:
    """Run every rule the supplied metadata allows; returns a VerifyReport.

    Args:
        dispatch_meta / bucket: enable R2 (+ R1 over bucket slices).
        comm_meta / calc_meta: enable R3 / R4 (+ R1 over AttnArgs).
        dispatch_meta_kv: kv ownership for cross-attention plans.
        global_slices: (q_ranges, k_ranges, mask_types, seq_q, seq_k) for
            user-level R1.
        tile_blocks: (fwd, dq | None, dkv | None) block choices for R5.
        tile_geom: (sq, sk, head_dim, head_dim_v, itemsize) for R5; the
            seqlens default to the calc_meta merged geometry.
        split_alignment: the declared wire alignment (GrpCollConfig).
        balance_bound: declared R2 per-rank area bound (x lower bound).
        capacities: per-rank weight vector; switches the R2 balance
            sub-check to its weighted form (see check_dispatch).
    """
    report = VerifyReport()
    if global_slices is not None:
        check_global_slices(report, *global_slices)
    if bucket is not None:
        check_bucket(report, bucket)
    if dispatch_meta is not None:
        check_dispatch(
            report, dispatch_meta, bucket=bucket,
            balance_bound=balance_bound, capacities=capacities,
        )
    if calc_meta is not None:
        for r, arg in enumerate(calc_meta.host_args):
            check_attn_arg(report, arg, f"host_args[{r}]")
        for st, stage_args in enumerate(calc_meta.remote_args_per_stage):
            for r, arg in enumerate(stage_args):
                check_attn_arg(report, arg, f"remote_args[{st}][{r}]")
        for r, arg in enumerate(calc_meta.merged_args):
            check_attn_arg(report, arg, f"merged_args[{r}]")
    if comm_meta is not None:
        kv_meta = dispatch_meta_kv or dispatch_meta
        kv_ranges = comm_meta.kv_host_ranges or (
            kv_meta.host_ranges_per_rank if kv_meta is not None else None
        )
        for st, s in enumerate(comm_meta.kv_stages):
            check_group_collective_arg(
                report, s, f"kv_stage{st}",
                split_alignment=split_alignment,
                src_shard_len=(
                    calc_meta.kv_shard_len if calc_meta is not None else None
                ),
                src_host_ranges=kv_ranges,
            )
            if getattr(s, "hier_plan", None) is not None and (
                kv_ranges is not None
            ):
                check_hier_plan(
                    report, s.hier_plan, s, kv_ranges, f"kv_stage{st}"
                )
        if dispatch_meta is not None and bucket is not None:
            check_comm_demand(
                report, comm_meta, dispatch_meta, bucket,
                dispatch_meta_kv=dispatch_meta_kv,
            )
        if calc_meta is not None:
            check_overlap(report, comm_meta, calc_meta)
    if tile_blocks is not None:
        fwd, dq, dkv = tile_blocks
        if tile_geom is not None:
            sq, sk, d, dv, itemsize = tile_geom
        elif calc_meta is not None:
            sq = calc_meta.shard_len
            sk = (calc_meta.kv_shard_len or 0) + sum(
                calc_meta.recv_len_per_stage
            )
            d, dv, itemsize = 128, 128, 2
        else:
            raise ValueError("tile_blocks needs tile_geom or calc_meta")
        check_tiles(
            report, fwd, sq, sk, dq_blocks=dq, dkv_blocks=dkv,
            head_dim=d, head_dim_v=dv, itemsize=itemsize,
        )
    return report


def verify_dynamic_plan(
    plan, split_alignment: int = 128
) -> VerifyReport:
    """Verify a DynamicAttnPlan: R1 over its per-rank AttnArgs, R3
    structural checks over the three casts, R4 buffer-length consistency
    between the casts and the execution contract."""
    report = VerifyReport()
    for r, arg in enumerate(plan.attn_args):
        check_attn_arg(report, arg, f"dyn attn_args[{r}]")
    for name, cast in (
        ("q_cast", plan.q_cast), ("kv_cast", plan.kv_cast), ("ret", plan.ret)
    ):
        check_group_collective_arg(
            report, cast, name, split_alignment=split_alignment
        )
    report.mark_run("R4")
    relations = (
        ("q_buf_len", plan.q_buf_len, plan.shard_len + plan.q_cast.r_max),
        ("k_buf_len", plan.k_buf_len,
         plan.kv_shard_len + plan.kv_cast.r_max),
        ("ret_len", plan.ret_len, plan.ret.r_max),
    )
    for name, got, want in relations:
        if got != want:
            report.add(
                "R4", ERROR, f"dynamic plan {name}",
                f"{name} {got} inconsistent with cast buffers ({want})",
            )
    mi = np.asarray(plan.merge_idx)
    if mi.size and (mi.min() < 0 or mi.max() > plan.dummy_index):
        report.add(
            "R4", ERROR, "dynamic plan merge_idx",
            f"merge index outside [0, dummy={plan.dummy_index}]",
        )
    return report


def verify_runtime_mgr(mgr, balance_bound: float = 2.0) -> VerifyReport:
    """Verify everything a DistAttnRuntimeMgr planned (static or dynamic),
    including the tile choice the kernels will resolve for its geometry."""
    align = mgr.key.config.grpcoll_config.split_alignment
    if mgr.dynamic_plan is not None:
        return verify_dynamic_plan(mgr.dynamic_plan, split_alignment=align)
    report = verify_plan(
        dispatch_meta=mgr.dispatch_meta_q,
        bucket=mgr.bucket,
        comm_meta=mgr.comm_meta,
        calc_meta=mgr.calc_meta,
        dispatch_meta_kv=(
            mgr.dispatch_meta_kv
            if mgr.dispatch_meta_kv is not mgr.dispatch_meta_q
            else None
        ),
        split_alignment=align,
        balance_bound=balance_bound,
        capacities=getattr(mgr.key, "capacities", None),
    )
    # R5 over the blocks the kernels will resolve for the merged geometry:
    # the port's default (env) tiles and its gated per-pass overrides, at
    # the bf16 d 128 of the JAX package's plan-time default
    from ..kernels.ffa import default_blocks, resolve_bwd_overrides

    sq = mgr.calc_meta.shard_len
    sk = (mgr.calc_meta.kv_shard_len or 0) + sum(
        mgr.calc_meta.recv_len_per_stage
    )
    bq, bk = default_blocks(sq, sk)
    dq, dkv = resolve_bwd_overrides(bq, bk, 128, 2)
    check_tiles(report, (bq, bk), sq, sk, dq_blocks=dq, dkv_blocks=dkv)
    return report


def maybe_verify_runtime(mgr) -> VerifyReport | None:
    """The opt-in plan-build hook (MAGI_ATTENTION_VERIFY_PLANS=1): verify
    at plan time, emit a ``plan_verify`` telemetry record, raise
    :class:`PlanVerificationError` on error-severity violations. Returns
    the report, None with the flag unset."""
    from .. import telemetry
    from ..env import general as env_general

    if not env_general.is_verify_plans_enable():
        return None
    import time

    t0 = time.perf_counter()
    report = verify_runtime_mgr(mgr)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if telemetry.enabled():
        telemetry.record_event(
            "plan_verify",
            planner="dynamic" if mgr.dynamic_plan is not None else "static",
            cp_size=mgr.key.cp_size,
            rules_run=list(report.rules_run),
            violations=len(report.violations),
            errors=len(report.errors()),
            warnings=len(report.warnings()),
            fired_rules=sorted(report.fired_rules()),
            wall_ms=wall_ms,
        )
    report.raise_if_errors()
    return report
