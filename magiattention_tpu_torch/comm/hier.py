"""Two-level (outer x inner) GroupCast: the plan and its executor.

The port's counterpart of ``magiattention_tpu/comm/hier.py``. On a cp
group laid out as ``(n_outer, n_inner)`` ranks, outer-major (nodes x the
ranks of a node, e.g. inter-node x NVLink), one stage's GroupCast runs in
two phases:

  phase A (over the outer axis): rank (o_s, i) sends each row that some
      rank of node o_d needs ONCE to its aligned peer (o_d, i), the rank of
      node o_d with the same inner index;
  phase B (over the inner axis): each rank forwards rows of
      ``[shard | phase-A receive buffer]`` to their final receivers in
      its node.

So a row crosses the outer fabric once per destination *node*, not once
per destination rank (``dcn_rows``), and the final receive buffer is laid
out as the flat GroupCast's, (global source rank asc, range asc), bit for
bit: the calc plans do not change.

:func:`make_hier_group_cast_plan` is the JAX package's host planner,
copied (its index arrays padded to the alignment, array-equal to JAX's);
it also keeps the true per-pair row counts (``a_pair_rows``,
``b_pair_rows``), which the executor sends as ``all_to_all_single``
splits, with no padding on the wire. :class:`HierCastPlan` is one rank's
view of a stage and runs it over two ``torch.distributed`` groups (the
rank's outer and inner lines). XLA gives the JAX package the reverse
(GroupReduce) as the transpose; here it is written out: phase B reversed,
scatter-adding into ``[shard | recvA]``, then phase A reversed,
scatter-adding recvA's part into the shard, every sum in float32.

Each phase is issued when the one before it lands, off the compute
stream: on CUDA, phase B (and, in the reverse, phase A after phase B's
reverse) runs on a side stream of the plan's that waits for the earlier
phase's NCCL work, and the compute stream waits for the side stream's
event only where the buffer (or the summed shard) is read. On the CPU
(gloo) there is no stream: the same code runs each phase in place.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import telemetry
from ..common.range import AttnRange, RangeError
from ..common.ranges import AttnRanges
from .primitives import _all_to_all, scatter_add_rows


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class HierGroupCastPlan:
    """Index arrays for the two-phase hierarchical group-cast.

    Shapes (cp = n_outer * n_inner, ranks outer-major):
        a_send_idx: (cp, n_outer, Aa)  — phase A per-destination-node rows
        a_recv_sel: (cp, Ra)           — phase A receive assembly
        b_send_idx: (cp, n_inner, Ab)  — phase B rows in [shard | recvA]
        b_recv_sel: (cp, R)            — final assembly (flat-equivalent)
        a_pair_rows: (cp, n_outer)     — true rows of each phase-A pair
        b_pair_rows: (cp, n_inner)     — true rows of each phase-B pair
    """

    n_outer: int
    n_inner: int
    a_send_idx: np.ndarray
    a_recv_sel: np.ndarray
    b_send_idx: np.ndarray
    b_recv_sel: np.ndarray
    shard_len: int
    r_max: int
    a_recv_len: np.ndarray  # (cp,) valid phase-A rows
    a_pair_rows: np.ndarray
    b_pair_rows: np.ndarray

    @property
    def cp_size(self) -> int:
        return self.n_outer * self.n_inner

    def dcn_rows(self) -> int:
        """Rows crossing the inter-node fabric (the dedup metric): every
        phase-A received row crossed DCN exactly once."""
        return int(self.a_recv_len.sum())


def pair_rows_from_indices(
    plan: HierGroupCastPlan, recv_len: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The true per-pair row counts ``(a_pair_rows, b_pair_rows)`` of a
    plan read back from its receive selections: rank ``(o_s, i)`` sent node
    ``o`` as many phase-A rows as rank ``(o, i)`` selects from buffer block
    ``o_s``, and holder ``(o, h)`` sent rank ``(o, i_d)`` as many phase-B
    rows as that rank's first ``recv_len[(o, i_d)]`` selections (the flat
    stage's receive lengths) take from block ``h``. A plan decoded from
    the wire (``meta/plan_io.py``, whose format is the JAX package's nine
    fields) gets its counts back this way."""
    n_outer, n_inner = plan.n_outer, plan.n_inner
    cp = n_outer * n_inner
    a_cap, b_cap = plan.a_send_idx.shape[2], plan.b_send_idx.shape[2]
    a_pair_rows = np.zeros((cp, n_outer), dtype=np.int64)
    b_pair_rows = np.zeros((cp, n_inner), dtype=np.int64)
    for r in range(cp):
        o, i = divmod(r, n_inner)
        a_src = np.asarray(plan.a_recv_sel[r, : int(plan.a_recv_len[r])]) // a_cap
        for o_s, n in zip(*np.unique(a_src, return_counts=True)):
            a_pair_rows[int(o_s) * n_inner + i, o] = n
        b_src = np.asarray(plan.b_recv_sel[r, : int(recv_len[r])]) // b_cap
        for h, n in zip(*np.unique(b_src, return_counts=True)):
            b_pair_rows[o * n_inner + int(h), i] = n
    return a_pair_rows, b_pair_rows


def make_hier_group_cast_plan(
    requests: list[list[AttnRanges]],
    host_ranges: list[AttnRanges],
    n_outer: int,
    n_inner: int,
    alignment: int = 128,
    r_max: int | None = None,
    shard_len: int | None = None,
) -> HierGroupCastPlan:
    """Plan the 2-phase cast for (dst, src) global-range requests.

    Args:
        requests: ``requests[dst][src]`` global ranges dst needs from src
            (src-merged, each range within one contiguous host piece — the
            same contract as the flat ``_make_cast_arg``).
        host_ranges: per-rank merged global ownership.
        n_outer/n_inner: dcn x ici mesh shape (ranks outer-major).
    """
    cp = n_outer * n_inner
    node = [r // n_inner for r in range(cp)]
    inner = [r % n_inner for r in range(cp)]
    if shard_len is None:
        # on-device rows per rank (padded shard when uneven)
        shard_len = max(h.total_seqlen for h in host_ranges)

    # ---- phase A: union of cross-node requests per (dst_node, src) -------
    a_req: list[list[AttnRanges]] = [
        [AttnRanges() for _ in range(cp)] for _ in range(n_outer)
    ]
    for d in range(cp):
        for s in range(cp):
            if node[s] == node[d]:
                continue
            for g in requests[d][s]:
                a_req[node[d]][s].append(AttnRange(g.start, g.end))
    for o in range(n_outer):
        for s in range(cp):
            a_req[o][s] = a_req[o][s].merge()

    # phase A send lists: src s -> dst node o (s's aligned peer there)
    a_pair_rows = np.zeros((cp, n_outer), dtype=np.int64)
    for s in range(cp):
        for o in range(n_outer):
            if o == node[s]:
                continue
            a_pair_rows[s, o] = a_req[o][s].total_seqlen
    a_cap = _round_up(max(int(a_pair_rows.max()), 1), alignment)

    a_send_idx = np.zeros((cp, n_outer, a_cap), dtype=np.int32)
    for s in range(cp):
        for o in range(n_outer):
            if o == node[s]:
                continue
            pos = 0
            for g in a_req[o][s]:
                loc0 = _local_offset(host_ranges[s], g)
                a_send_idx[s, o, pos: pos + g.seqlen] = np.arange(
                    loc0, loc0 + g.seqlen, dtype=np.int32
                )
                pos += g.seqlen

    # phase A receive layout at rank (o, i): rows from srcs with inner i in
    # other nodes, ordered (src node asc, range asc); record buffer offsets
    # a_offset[r][(s, g.start)] -> offset within [shard | recvA]
    a_rows = np.zeros(cp, dtype=np.int64)
    a_offset: list[dict[tuple[int, int], int]] = [{} for _ in range(cp)]
    a_recv_parts: list[list[tuple[int, int, int]]] = [[] for _ in range(cp)]
    for r in range(cp):
        o, i = node[r], inner[r]
        off = 0
        for o_s in range(n_outer):
            if o_s == o:
                continue
            s = o_s * n_inner + i
            # position of each range within s's send list for node o
            send_pos = 0
            for g in a_req[o][s]:
                a_offset[r][(s, g.start)] = shard_len + off
                a_recv_parts[r].append((o_s, send_pos, g.seqlen))
                send_pos += g.seqlen
                off += g.seqlen
        a_rows[r] = off
    ra_max = _round_up(max(int(a_rows.max()), 1), alignment)
    a_recv_sel = np.zeros((cp, ra_max), dtype=np.int32)
    for r in range(cp):
        chunks = []
        off = 0
        for o_s, send_pos, n in a_recv_parts[r]:
            chunks.append(
                np.arange(
                    o_s * a_cap + send_pos, o_s * a_cap + send_pos + n,
                    dtype=np.int32,
                )
            )
            off += n
        if chunks:
            cat = np.concatenate(chunks)
            a_recv_sel[r, : len(cat)] = cat

    # ---- phase B: forward to final destinations over ici -----------------
    # final layout at dst d: (global src asc, range asc) == flat group_cast
    b_pair_segs: list[list[list[tuple[int, int]]]] = [
        [[] for _ in range(n_inner)] for _ in range(cp)
    ]  # [holder][dst_inner] -> (buf_pos, n)
    b_pair_rows = np.zeros((cp, n_inner), dtype=np.int64)
    # recv assembly per dst: (holder_inner, pos_in_pair, n) in final order
    b_recv_parts: list[list[tuple[int, int, int]]] = [[] for _ in range(cp)]
    final_rows = np.zeros(cp, dtype=np.int64)

    for d in range(cp):
        o_d, i_d = node[d], inner[d]
        for s in range(cp):
            for g in requests[d][s]:
                holder_inner = inner[s]
                holder = o_d * n_inner + holder_inner
                if node[s] == o_d:
                    # same node: holder IS s; rows from its shard
                    buf_pos = _local_offset(host_ranges[s], g)
                else:
                    # arrived in phase A at the aligned peer: find the merged
                    # interval containing g
                    buf_pos = _lookup_merged(
                        a_offset[holder], s, a_req[o_d][s], g
                    )
                pos = int(b_pair_rows[holder, i_d])
                b_pair_segs[holder][i_d].append((buf_pos, g.seqlen))
                b_pair_rows[holder, i_d] += g.seqlen
                b_recv_parts[d].append((holder_inner, pos, g.seqlen))
                final_rows[d] += g.seqlen

    b_cap = _round_up(max(int(b_pair_rows.max()), 1), alignment)
    b_send_idx = np.zeros((cp, n_inner, b_cap), dtype=np.int32)
    for h in range(cp):
        for i_d in range(n_inner):
            pos = 0
            for buf_pos, n in b_pair_segs[h][i_d]:
                b_send_idx[h, i_d, pos: pos + n] = np.arange(
                    buf_pos, buf_pos + n, dtype=np.int32
                )
                pos += n

    if r_max is None:
        r_max = _round_up(max(int(final_rows.max()), 1), alignment)
    b_recv_sel = np.zeros((cp, r_max), dtype=np.int32)
    for d in range(cp):
        chunks = []
        off = 0
        for h_inner, pos, n in b_recv_parts[d]:
            chunks.append(
                np.arange(
                    h_inner * b_cap + pos, h_inner * b_cap + pos + n,
                    dtype=np.int32,
                )
            )
            off += n
        if chunks:
            cat = np.concatenate(chunks)
            b_recv_sel[d, : len(cat)] = cat

    plan = HierGroupCastPlan(
        n_outer=n_outer,
        n_inner=n_inner,
        a_send_idx=a_send_idx,
        a_recv_sel=a_recv_sel,
        b_send_idx=b_send_idx,
        b_recv_sel=b_recv_sel,
        shard_len=shard_len,
        r_max=r_max,
        a_recv_len=a_rows,
        a_pair_rows=a_pair_rows,
        b_pair_rows=b_pair_rows,
    )
    if telemetry.enabled():
        # flat baseline: every cross-node (dst, src) request row crosses DCN
        # once per destination RANK; dcn_rows dedups to once per node
        flat_dcn = sum(
            requests[d][s].total_seqlen
            for d in range(cp)
            for s in range(cp)
            if node[s] != node[d]
        )
        telemetry.record_event(
            "hier_plan",
            n_outer=n_outer,
            n_inner=n_inner,
            cp_size=cp,
            a_cap=int(a_cap),
            b_cap=int(b_cap),
            r_max=int(r_max),
            dcn_rows=plan.dcn_rows(),
            flat_dcn_rows=int(flat_dcn),
            dcn_dedup_ratio=(
                flat_dcn / plan.dcn_rows() if plan.dcn_rows() else 1.0
            ),
            a_wire_rows=cp * n_outer * int(a_cap),
            b_wire_rows=cp * n_inner * int(b_cap),
            final_rows=int(final_rows.sum()),
        )
    return plan


def _local_offset(own: AttnRanges, g: AttnRange) -> int:
    off = 0
    for r in own:
        if r.start <= g.start < r.end:
            return off + (g.start - r.start)
        off += r.seqlen
    raise RangeError(
        f"global range {g} is not owned by this rank's host ranges "
        f"{list(own)} — the hierarchical transfer table references rows "
        "outside the rank's ownership"
    )


def _lookup_merged(
    offsets: dict[tuple[int, int], int],
    src: int,
    merged: AttnRanges,
    g: AttnRange,
) -> int:
    """Buffer position of g inside src's merged phase-A intervals."""
    for iv in merged:
        if iv.start <= g.start and g.end <= iv.end:
            return offsets[(src, iv.start)] + (g.start - iv.start)
    raise RangeError(
        f"global range {g} not found in phase-A merged intervals "
        f"{list(merged)} of src {src} — phase-B indexing would read the "
        "wrong rows from the inter-host receive buffer"
    )


# ---------------------------------------------------------------------------
# the executor: one rank's view of a stage over torch.distributed
# ---------------------------------------------------------------------------


def _exchange(out, inp, out_splits, in_splits, group, async_op):
    """``all_to_all_single`` over ``group``; a group of one (None) is the
    local copy its single split describes."""
    if group is None:
        out.copy_(inp)
        return None
    return _all_to_all(out, inp, out_splits, in_splits, group, async_op)


def _wait(work) -> None:
    if work is not None:
        work.wait()


@contextlib.contextmanager
def _issued_on(side):
    """Run the block on the ``side`` stream, after all the current stream
    has issued (nothing to do for None: the CPU)."""
    if side is None:
        yield
        return
    side.wait_stream(torch.cuda.current_stream(side.device))
    with torch.cuda.stream(side):
        yield


def _landed(side, used: tuple):
    """The event the compute stream waits on for what ``side`` issued
    (None on the CPU); ``used`` are tensors of the compute stream that
    ``side`` reads or writes, kept from early reuse."""
    if side is None:
        return None
    for t in used:
        t.record_stream(side)
    return side.record_event()


def _await(done, device) -> None:
    if done is not None:
        torch.cuda.current_stream(device).wait_event(done)


@dataclass(frozen=True, eq=False)
class HierCastPlan:
    """One two-level GroupCast stage as one rank sees it: the rows it
    sends in each phase and the per-peer splits (true counts), and the
    order that turns phase B's arrivals (peer by peer) into the flat
    layout. Used as :class:`~.primitives.CastPlan` is, with the pair of
    groups ``(outer line, inner line)`` in place of the cp group."""

    lowering = "hier"  # names the group_reduce_hier profiler scope

    a_send_rows: np.ndarray  # local rows, grouped by destination node
    a_send_splits: tuple[int, ...]  # rows to each node's aligned peer
    a_recv_splits: tuple[int, ...]  # rows from each node's aligned peer
    b_send_rows: np.ndarray  # rows of [shard | recvA], grouped by destination
    b_send_splits: tuple[int, ...]  # rows to each rank of the node
    b_recv_splits: tuple[int, ...]  # rows from each rank of the node
    b_order: np.ndarray  # final row j is phase B's arrival b_order[j]
    shard_len: int
    buf_len: int  # receive-buffer rows (the stage's padded length)
    _rows: dict = field(default_factory=dict, init=False, repr=False)
    _sides: dict = field(default_factory=dict, init=False, repr=False)

    @property
    def recv_len(self) -> int:
        return len(self.b_order)

    @property
    def recv_a_len(self) -> int:
        return sum(self.a_recv_splits)

    @classmethod
    def from_plan(cls, plan: HierGroupCastPlan, rank: int) -> "HierCastPlan":
        """Rank ``rank``'s (group rank ``o * n_inner + i``) view of a
        stage's plan; checks that phase A's receive layout is what
        ``all_to_all_single`` delivers (source node by source node)."""
        n_outer, n_inner = plan.n_outer, plan.n_inner
        o, i = divmod(rank, n_inner)
        a_rows, b_rows = plan.a_pair_rows, plan.b_pair_rows
        a_cap, b_cap = plan.a_send_idx.shape[2], plan.b_send_idx.shape[2]
        a_send = np.concatenate(
            [plan.a_send_idx[rank, od, : a_rows[rank, od]] for od in range(n_outer)]
        ).astype(np.int64)
        a_recv = [int(a_rows[os_ * n_inner + i, o]) for os_ in range(n_outer)]
        n_a = int(plan.a_recv_len[rank])
        want = np.concatenate(
            [np.arange(os_ * a_cap, os_ * a_cap + a_recv[os_]) for os_ in range(n_outer)]
        )
        if n_a != sum(a_recv) or not np.array_equal(plan.a_recv_sel[rank, :n_a], want):
            raise ValueError(
                f"rank {rank}: phase A's receive layout is not source-major "
                "in send order; all_to_all_single cannot deliver it"
            )
        b_send = np.concatenate(
            [plan.b_send_idx[rank, id_, : b_rows[rank, id_]] for id_ in range(n_inner)]
        ).astype(np.int64)
        b_recv = np.array([b_rows[o * n_inner + h, i] for h in range(n_inner)], np.int64)
        n = int(b_recv.sum())
        sel = plan.b_recv_sel[rank, :n].astype(np.int64)
        order = (np.cumsum(b_recv) - b_recv)[sel // b_cap] + sel % b_cap
        if not np.array_equal(np.sort(order), np.arange(n)):
            raise ValueError(f"rank {rank}: phase B's final order is not a permutation")
        return cls(
            a_send_rows=a_send,
            a_send_splits=tuple(int(c) for c in a_rows[rank]),
            a_recv_splits=tuple(a_recv),
            b_send_rows=b_send,
            b_send_splits=tuple(int(c) for c in b_rows[rank]),
            b_recv_splits=tuple(int(c) for c in b_recv),
            b_order=order,
            shard_len=plan.shard_len,
            buf_len=int(plan.r_max),
        )

    def _index(self, name: str, device: torch.device) -> torch.Tensor:
        t = self._rows.get((name, device))
        if t is None:
            t = torch.from_numpy(getattr(self, name)).to(device)
            self._rows[(name, device)] = t
        return t

    def _side(self, device: torch.device):
        """This plan's side stream on a CUDA ``device`` (None on the CPU)."""
        if device.type != "cuda":
            return None
        s = self._sides.get(device)
        if s is None:
            s = self._sides[device] = torch.cuda.Stream(device)
        return s

    def rows(self, device: torch.device) -> torch.Tensor:
        """Phase A's send rows (the shard rows this rank sends out of its
        node) as an int64 tensor on ``device`` (cached)."""
        return self._index("a_send_rows", device)

    def exchanges(self, groups) -> list[tuple]:
        """Phases A and B in issue order (a group of one is a local copy,
        no exchange), as :meth:`~.primitives.CastPlan.exchanges`."""
        outer, inner = groups
        phases = (
            (self.recv_a_len, len(self.a_send_rows), self.a_recv_splits, self.a_send_splits, outer),
            (self.recv_len, len(self.b_send_rows), self.b_recv_splits, self.b_send_splits, inner),
        )
        return [p for p in phases if p[-1] is not None]

    def cast_start(self, x: torch.Tensor, groups, out_dtype: torch.dtype):
        """Issue phase A of ``x``'s rows (in x's dtype) and, when it lands,
        phase B, off the compute stream; returns the ``[buf_len, ...]``
        receive buffer in ``out_dtype`` (zero past ``recv_len``) and the
        wait, after which the buffer may be read."""
        outer, inner = groups
        dev = x.device
        send_a = x.index_select(0, self.rows(dev))
        recv_a = x.new_empty((self.recv_a_len, *x.shape[1:]))
        work_a = _exchange(recv_a, send_a, self.a_recv_splits, self.a_send_splits, outer, True)
        buf = x.new_zeros((self.buf_len, *x.shape[1:]), dtype=out_dtype)
        side = self._side(dev)
        with _issued_on(side):
            _wait(work_a)
            held = torch.cat([x, recv_a])
            send_b = held.index_select(0, self._index("b_send_rows", dev))
            recv_b = x.new_empty((self.recv_len, *x.shape[1:]))
            work_b = _exchange(recv_b, send_b, self.b_recv_splits, self.b_send_splits, inner, True)
            _wait(work_b)
            with torch.no_grad():  # the buffer is an autograd output: fill it in place
                buf[: self.recv_len] = recv_b.index_select(0, self._index("b_order", dev))
        done = _landed(side, (x, recv_a, buf))

        def wait(send_a=send_a, held=held, send_b=send_b, recv_b=recv_b):
            _await(done, dev)  # the transfers' buffers live until here

        return buf, wait

    def reduce_start(self, y: torch.Tensor, groups, dtype: torch.dtype):
        """Issue phase B's reverse of the partials ``y`` (against the
        receive buffer) in ``dtype`` and, when it lands, its sum into
        ``[shard | recvA]`` and phase A's reverse of recvA's part (in
        ``dtype``), off the compute stream; returns the handle for
        :meth:`reduce_finish`."""
        outer, inner = groups
        dev = y.device
        arrived = y.new_zeros((self.recv_len, *y.shape[1:]), dtype=dtype)
        arrived.index_copy_(0, self._index("b_order", dev), y[: self.recv_len].to(dtype))
        back = arrived.new_empty((len(self.b_send_rows), *y.shape[1:]))
        work_b = _exchange(back, arrived, self.b_send_splits, self.b_recv_splits, inner, True)
        held = back.new_zeros((self.shard_len + self.recv_a_len, *back.shape[1:]),
                              dtype=torch.float32)
        back_a = back.new_empty((len(self.a_send_rows), *back.shape[1:]))
        side = self._side(dev)
        with _issued_on(side):
            _wait(work_b)
            scatter_add_rows(held, self._index("b_send_rows", dev), back.float(),
                             self.b_send_splits)
            send_a = held[self.shard_len:].to(back.dtype)
            work_a = _exchange(back_a, send_a, self.a_send_splits, self.a_recv_splits, outer, True)
            _wait(work_a)
        done = _landed(side, (arrived, back, held, back_a))
        return held, back_a, done, send_a

    def reduce_finish(self, total, handle, groups, shard_len: int) -> torch.Tensor:
        """Finish one stage's GroupReduce: the shard part of phase B's sum
        and phase A's returned rows (float32) summed into ``total``
        (float32 ``[shard_len, ...]``; made on first use, when None)."""
        held, back_a, done, _ = handle
        _await(done, held.device)
        local = held[:shard_len]
        total = local if total is None else total.add_(local)
        return scatter_add_rows(total, self.rows(held.device), back_a.float(), self.a_send_splits)
