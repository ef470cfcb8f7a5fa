"""A global roll of dispatched rows.

The port's counterpart of ``magiattention_tpu/functional/roll.py`` (ref:
magi_attention/functional/roll.py): ``torch.roll`` of the global sequence
while the tensor lives in the dispatched (chunk-permuted, cp-sharded)
layout, e.g. for the label shift of multi-token prediction.

The host plan, :func:`make_roll_plan`, is the JAX package's, field for
field: the rows each rank sends, grouped by ring distance, and the
assembly gather over ``[local shard | received rows]``. The JAX package
runs one ``ppermute`` round per ring distance; here one
``all_to_all_single`` with the true per-pair counts moves every cross row
(the GroupCast of :mod:`..comm.primitives`, whose backward, the reverse
exchange, makes the roll differentiable), and the assembly gather is
re-indexed to that receive layout (:func:`roll_exchange`). Rows that stay
on their rank are a local gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm.primitives import CastPlan, group_cast_rows
from ..meta.collection.dispatch_meta import DispatchMeta


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def roll_index(meta: DispatchMeta, shifts: int) -> np.ndarray:
    """Gather index implementing a global roll on dispatched tensors.

    out_disp[flat_pos] = in_disp[idx[flat_pos]] where out corresponds to the
    globally-rolled sequence re-dispatched with the same permutation (flat
    over every rank's rows; the dense oracle, and the cp = 1 path).
    """
    pos = meta.position_ids.reshape(-1)  # local row -> global row
    unperm = meta.unpermute_index  # global row -> local row
    src_global = (pos - shifts) % meta.total_seqlen
    return unperm[src_global].astype(np.int32)


def _sources(meta: DispatchMeta, shifts: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src_rank, src_local) ``(cp, shard)`` of every output row, and the
    ``[src][dst]`` row counts."""
    cp, shard = meta.cp_size, meta.shard_seqlen
    pos = np.asarray(meta.position_ids)  # (cp, shard)
    u = np.asarray(meta.unpermute_index)[(pos - shifts) % meta.total_seqlen]
    src_rank = (u // shard).astype(np.int32)
    src_local = (u % shard).astype(np.int32)
    counts = np.zeros((cp, cp), dtype=np.int64)
    for r in range(cp):
        for s, c in zip(*np.unique(src_rank[r], return_counts=True)):
            counts[int(s), r] = int(c)
    return src_rank, src_local, counts


def make_roll_plan(
    meta: DispatchMeta, shifts: int, align: int = 8
) -> tuple[np.ndarray, np.ndarray, tuple[int, ...], tuple[int, ...]]:
    """Host plan for the segment-wise roll (the JAX package's).

    Returns:
        send_idx: (cp, sum_caps) — local rows each rank sends, concatenated
            per ring distance (rows for dst = (rank + delta) % cp, in the
            destination's output order).
        asm_idx: (cp, shard) — assembly gather over [local shard | recv
            buffer] producing the rolled local shard.
        deltas, caps: active ring distances and their padded capacities.
    """
    return _roll_plan(meta, shifts, align)[:4]


def _roll_plan(meta: DispatchMeta, shifts: int, align: int = 8):
    """:func:`make_roll_plan`'s four arrays, and the ``[src][dst]`` row
    counts."""
    cp, shard = meta.cp_size, meta.shard_seqlen
    src_rank, src_local, counts = _sources(meta, shifts)
    deltas, caps = [], []
    for delta in range(1, cp):
        mx = max(int(counts[(r - delta) % cp, r]) for r in range(cp))
        if mx > 0:
            deltas.append(delta)
            caps.append(_round_up(mx, align))
    cum = {}
    off = 0
    for delta, c in zip(deltas, caps):
        cum[delta] = off
        off += c
    sum_caps = off

    send_idx = np.zeros((cp, max(sum_caps, 1)), dtype=np.int32)
    asm_idx = np.zeros((cp, shard), dtype=np.int32)
    for r in range(cp):
        self_m = src_rank[r] == r
        asm_idx[r][self_m] = src_local[r][self_m]
        for s in range(cp):
            if s == r or counts[s, r] == 0:
                continue
            delta = (r - s) % cp
            m = src_rank[r] == s
            rows = src_local[r][m]  # in dst output order
            base = cum[delta]
            send_idx[s, base: base + rows.size] = rows
            asm_idx[r][m] = shard + base + np.arange(rows.size, dtype=np.int32)
    return send_idx, asm_idx, tuple(deltas), tuple(caps), counts


def roll_exchange(meta: DispatchMeta, shifts: int, rank: int) -> tuple[CastPlan, np.ndarray]:
    """Rank ``rank``'s part of :func:`make_roll_plan` as one exchange: the
    GroupCast plan of its cross rows (to each destination, in rank order)
    and the assembly gather over ``[local shard | received rows]``, whose
    received rows come source by source, as ``all_to_all_single``
    delivers them."""
    cp, shard = meta.cp_size, meta.shard_seqlen
    send_idx, asm_idx, deltas, caps, counts = _roll_plan(meta, shifts)
    cum = dict(zip(deltas, np.cumsum((0, *caps))[:-1].tolist()))
    send_rows = [
        send_idx[rank, cum[(d - rank) % cp]: cum[(d - rank) % cp] + counts[rank, d]]
        for d in range(cp) if d != rank and counts[rank, d]
    ]
    recv = [int(counts[s, rank]) if s != rank else 0 for s in range(cp)]
    recv_off = np.cumsum([0, *recv])[:-1]
    orig = asm_idx[rank].astype(np.int64)
    asm = orig.copy()
    for s in range(cp):
        if s == rank or not recv[s]:
            continue
        base = shard + cum[(rank - s) % cp]
        m = (orig >= base) & (orig < base + recv[s])
        asm[m] += shard + recv_off[s] - base
    plan = CastPlan(
        send_rows=(np.concatenate(send_rows) if send_rows else np.zeros(0)).astype(np.int64),
        send_splits=tuple(int(counts[rank, d]) if d != rank else 0 for d in range(cp)),
        recv_splits=tuple(recv),
        buf_len=sum(recv),
    )
    return plan, asm


def roll_func(x: torch.Tensor, meta: DispatchMeta, shifts: int, rank: int = 0, group=None) -> torch.Tensor:
    """Roll this rank's dispatched rows ``x`` by ``shifts`` global
    positions: the rank's rows of the rolled global sequence, in the same
    dispatch. Differentiable (the backward moves the rows back)."""
    cp = meta.cp_size
    if cp == 1 or shifts % meta.total_seqlen == 0:
        idx = roll_index(meta, shifts).reshape(cp, -1)[rank] - rank * meta.shard_seqlen
        return x.index_select(0, torch.from_numpy(idx.astype(np.int64)).to(x.device))
    plan, asm = roll_exchange(meta, shifts, rank)
    buf = torch.cat([x, group_cast_rows(x, plan, group)])
    return buf.index_select(0, torch.from_numpy(asm).to(x.device))
