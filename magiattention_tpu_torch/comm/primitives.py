"""Group collectives over ``torch.distributed``, per rank.

The port's counterpart of ``magiattention_tpu/comm/primitives.py``.

- **GroupCast**: every rank sends chosen rows of its kv shard to the ranks
  that need them; each receiver's buffer holds its sources' rows source by
  source. One ``all_to_all_single`` per stage with the plan's true
  per-pair row counts as uneven splits (so no wire padding), over NCCL on
  CUDA tensors and gloo on CPU tensors.
- **GroupReduce**: the reverse: partial gradients against a receive buffer
  go back to the rows' owners (the reverse ``all_to_all_single``) and are
  summed into their shards (``index_add_``). JAX gets it as the transpose
  of GroupCast from XLA; here it is written out as the backward of
  :class:`_GroupCast`.

The JAX package plans three wire lowerings per stage (padded all_to_all,
ppermute rounds, ragged all_to_all) because XLA's collectives want static
shapes; ``all_to_all_single`` takes true splits, so the port runs every
stage one way and reads only the plan's send indices and counts. The
JAX package's ``cast_rows``/``reduce_rows`` lowering dispatchers and the
ppermute and ragged lowerings have no counterpart here. The two-level
cast (:mod:`.hier`) runs through the same :class:`_GroupCast`: a stage's
plan carries ``cast_start`` / ``reduce_start`` / ``reduce_finish``, and
the CP runtime's overlapped path calls them itself, issuing each stage's
GroupReduce as soon as its partials exist
(:class:`~..functional.dist_attn._StagedAttn`).

A row sent to several ranks comes back from each; the GroupReduce sums
them into its owner in destination order (:func:`scatter_add_rows`), so
the sum has the same bits on every run, on the card too.

Every exchange issued is counted per thread (:func:`exchanges_issued`): the
step watchdog reads how far a failed forward got, and
:func:`issue_placeholders` issues the exchanges it did not reach, so that
no peer is left waiting inside one (ROADMAP C9).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..meta.collection.comm_meta import GroupCollectiveArg
from ..utils.profiling import profile_scope


@dataclass(frozen=True, eq=False)
class CastPlan:
    """One GroupCast stage as one rank sees it."""

    send_rows: np.ndarray  # (n_send,) int64 local rows, grouped by destination
    send_splits: tuple[int, ...]  # rows sent to each rank
    recv_splits: tuple[int, ...]  # rows received from each rank
    buf_len: int  # receive-buffer rows (the stage's padded length)
    _rows: dict = field(default_factory=dict, init=False, repr=False)

    @property
    def recv_len(self) -> int:
        return sum(self.recv_splits)

    @classmethod
    def from_stage(cls, stage: GroupCollectiveArg, rank: int) -> "CastPlan":
        """Rank ``rank``'s view of a solver stage. The solver lays out each
        receive buffer source by source, each source's rows in its send
        order (``recv_sel``): exactly what ``all_to_all_single`` delivers,
        which is checked here."""
        counts = stage.send_counts.astype(np.int64)  # [src][dst]
        cp = counts.shape[0]
        send_rows = np.concatenate(
            [stage.send_idx[rank, d, : counts[rank, d]] for d in range(cp)]
        ).astype(np.int64)
        recv_splits = counts[:, rank]
        n = int(stage.recv_len[rank])
        sel = stage.recv_sel[rank, :n].astype(np.int64)
        offsets = np.cumsum(recv_splits) - recv_splits
        if n != int(recv_splits.sum()) or not np.array_equal(
            offsets[sel // stage.a_cap] + sel % stage.a_cap, np.arange(n)
        ):
            raise ValueError(
                f"rank {rank}: the stage's receive layout is not source-major "
                "in send order; all_to_all_single cannot deliver it"
            )
        return cls(
            send_rows=send_rows,
            send_splits=tuple(int(c) for c in counts[rank]),
            recv_splits=tuple(int(c) for c in recv_splits),
            buf_len=int(stage.r_max),
        )

    def rows(self, device: torch.device) -> torch.Tensor:
        """``send_rows`` as an int64 tensor on ``device`` (cached)."""
        t = self._rows.get(device)
        if t is None:
            t = torch.from_numpy(self.send_rows).to(device)
            self._rows[device] = t
        return t

    # the lowering a stage runs (the JAX package's ``kind[0]``, which names
    # the ``group_reduce_<lowering>`` profiler scope)
    lowering = "a2a"

    def exchanges(self, group) -> list[tuple]:
        """The cast's exchanges in issue order, each ``(rows out, rows in,
        out splits, in splits, group)`` (see :func:`issue_placeholders`)."""
        return [(self.recv_len, len(self.send_rows), self.recv_splits, self.send_splits, group)]

    def cast_start(self, x: torch.Tensor, group, out_dtype: torch.dtype):
        """Issue the GroupCast of ``x``'s rows, sent in x's dtype; returns
        the receive buffer in ``out_dtype`` and the wait (see
        :func:`_cast_start`). A wider ``out_dtype`` is filled from the
        arrived rows by the wait."""
        arrived, work, send = _cast_start(x, self, group)
        if out_dtype == x.dtype:
            return arrived, lambda work=work, send=send: work.wait()  # send lives until done
        buf = x.new_zeros((self.buf_len, *x.shape[1:]), dtype=out_dtype)

        def wait(work=work, send=send):
            work.wait()
            with torch.no_grad():  # the buffer is an autograd output: fill it in place
                buf[: self.recv_len] = arrived[: self.recv_len]

        return buf, wait

    def reduce_start(self, y: torch.Tensor, group, dtype: torch.dtype):
        return _reduce_start(y, self, group, dtype)

    def reduce_finish(self, total, handle, group, shard_len: int) -> torch.Tensor:
        back, work, _ = handle
        return _reduce_finish(total, self, back, work, shard_len)


_issued = threading.local()


def exchanges_issued() -> int:
    """How many row exchanges (``all_to_all_single``) this thread has
    issued so far."""
    return getattr(_issued, "n", 0)


def _all_to_all(out, inp, out_splits, in_splits, group, async_op):
    work = dist.all_to_all_single(
        out, inp, list(out_splits), list(in_splits), group=group,
        async_op=async_op,
    )
    _issued.n = exchanges_issued() + 1
    return work


def _held_bytes(nbytes: int, device: torch.device, held) -> torch.Tensor | None:
    """The first ``nbytes`` bytes of a contiguous tensor of ``held`` on
    ``device`` that has them, as a uint8 view (None where none has)."""
    for t in held:
        if t is not None and t.device == device and t.is_contiguous() \
                and t.numel() * t.element_size() >= nbytes:
            return t.detach().reshape(-1).view(torch.uint8)[:nbytes]
    return None


def _typed(raw: torch.Tensor, n: int, row_shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """``raw``'s first bytes as an ``[n, *row_shape]`` tensor of ``dtype``."""
    nbytes = n * math.prod(row_shape) * dtype.itemsize
    return raw[:nbytes].view(dtype).view(n, *row_shape)


def issue_placeholders(exchanges, device: torch.device, held=()) -> None:
    """Issue ``exchanges`` with placeholder buffers, in order, each waited
    for: ``(exchange, row_shape, dtype)`` with ``exchange`` as a plan's
    :meth:`CastPlan.exchanges` gives it. The peers receive whatever the
    placeholders hold. One receive buffer serves every exchange; the sends
    read the bytes of a tensor of ``held`` (storage the caller already
    holds, never written) where one is large enough, else one zeroed
    buffer."""
    if not exchanges:
        return

    def nbytes(n, row_shape, dtype):
        return n * math.prod(row_shape) * dtype.itemsize

    recv = torch.empty(max(nbytes(e[0], r, t) for e, r, t in exchanges),
                       dtype=torch.uint8, device=device)
    n_send = max(nbytes(e[1], r, t) for e, r, t in exchanges)
    send = _held_bytes(n_send, device, held)
    for (n_out, n_in, out_splits, in_splits, group), row_shape, dtype in exchanges:
        try:
            inp = _typed(send, n_in, row_shape, dtype)
        except (RuntimeError, TypeError):  # no held storage, or misaligned for dtype
            send = torch.zeros(n_send, dtype=torch.uint8, device=device)
            inp = _typed(send, n_in, row_shape, dtype)
        _all_to_all(_typed(recv, n_out, row_shape, dtype), inp, out_splits, in_splits,
                    group, False)


def _cast_start(x: torch.Tensor, plan: CastPlan, group):
    """Issue one stage's GroupCast of ``x``'s rows; returns the receive
    buffer (``plan.buf_len`` rows, those past ``recv_len`` zero) and the
    async work. Read the buffer only after ``work.wait()``. On CUDA, NCCL
    runs the collective on its own stream; ``wait`` makes the current
    stream wait for it."""
    send = x.index_select(0, plan.rows(x.device))
    buf = send.new_zeros((plan.buf_len, *x.shape[1:]))
    work = _all_to_all(
        buf[: plan.recv_len], send, plan.recv_splits, plan.send_splits,
        group, True,
    )
    return buf, work, send


def _reduce_start(y: torch.Tensor, plan: CastPlan, group, dtype: torch.dtype):
    """Issue one stage's GroupReduce transfer of ``y``'s first ``recv_len``
    rows, in ``dtype``; returns (rows back in send order, work)."""
    back = y.new_empty((len(plan.send_rows), *y.shape[1:]), dtype=dtype)
    inp = y[: plan.recv_len].to(dtype).contiguous()
    work = _all_to_all(
        back, inp, plan.send_splits, plan.recv_splits, group, True
    )
    return back, work, inp


def scatter_add_rows(total: torch.Tensor, rows: torch.Tensor, src: torch.Tensor,
                     splits) -> torch.Tensor:
    """``total[rows] += src`` for ``rows`` grouped by destination
    (``splits`` rows each, no row twice within one), one destination at a
    time: a row that went to several ranks is summed in destination
    order. That is the order a single ``index_add_`` takes on the CPU; on
    CUDA a single call adds repeated rows atomically, in no fixed order.
    Returns ``total``."""
    start = 0
    for n in splits:
        if n:
            total.index_add_(0, rows[start:start + n], src[start:start + n])
        start += n
    return total


def _reduce_finish(total, plan: CastPlan, back, work, shard_len: int) -> torch.Tensor:
    """Wait for one stage's GroupReduce transfer and sum its rows into
    ``total`` (float32 ``[shard_len, ...]``; made on first use, when
    None). Returns ``total``."""
    work.wait()
    if total is None:
        total = back.new_zeros((shard_len, *back.shape[1:]), dtype=torch.float32)
    return scatter_add_rows(total, plan.rows(back.device), back.float(), plan.send_splits)


def group_reduce_rows(
    y: torch.Tensor,
    plan: CastPlan,
    group,
    shard_len: int,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """GroupReduce (op = sum) of partials ``y`` (``[buf_len, ...]``,
    against this rank's receive buffer) into ``[shard_len, ...]`` float32:
    the rows of every rank's partials that this rank owns, summed. The
    transfer runs in ``dtype`` (default y's)."""
    with profile_scope(f"group_reduce_{plan.lowering}"):
        back, work, _ = _reduce_start(y, plan, group, dtype or y.dtype)
        return _reduce_finish(None, plan, back, work, shard_len)


class _GroupCast(torch.autograd.Function):
    """GroupCast of ``x`` over one or more stages; the backward is the
    GroupReduce of every stage, summed in float32 and cast to ``x``'s dtype
    once. The forward only issues the transfers: ``waits`` (a list the
    caller passes) receives one ``wait`` per stage, to call before the
    stage's buffer is read. The rows travel in x's dtype. With ``hp`` the
    buffers are float32 (each upcast from the arrived rows), the backward's
    transfers float32, and a float32 copy of ``x`` comes first among the
    outputs, so that the local part's gradient joins the float32 sum too
    (the high-precision reduce, MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE).
    ``plans`` are :class:`CastPlan` over the cp group or
    :class:`~.hier.HierCastPlan` over the pair of its lines."""

    @staticmethod
    def forward(ctx, x, plans, group, hp, waits):
        out_dtype = torch.float32 if hp else x.dtype
        bufs = []
        for i, plan in enumerate(plans):
            with profile_scope(f"group_cast_stage{i}"):
                buf, wait = plan.cast_start(x, group, out_dtype)
            bufs.append(buf)
            waits.append(wait)
        ctx.plans, ctx.group, ctx.hp = plans, group, hp
        ctx.shard_len, ctx.x_dtype = x.shape[0], x.dtype
        return (x.float(), *bufs) if hp else tuple(bufs)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].float() if ctx.hp else None
        stage_grads = grads[1:] if ctx.hp else grads
        wire = torch.float32 if ctx.hp else ctx.x_dtype
        pending = []
        for plan, g in zip(ctx.plans, stage_grads):
            with profile_scope(f"group_reduce_{plan.lowering}"):
                pending.append((plan, plan.reduce_start(g, ctx.group, wire)))
        for plan, handle in pending:
            with profile_scope(f"group_reduce_{plan.lowering}"):
                total = plan.reduce_finish(total, handle, ctx.group, ctx.shard_len)
        return total.to(ctx.x_dtype), None, None, None, None


def group_cast_all(
    x: torch.Tensor, plans: list[CastPlan], group, hp: bool = False
) -> tuple[list[torch.Tensor], list]:
    """Issue the GroupCast of every stage at once. Returns (parts, waits):
    ``parts`` is ``[local, buf_0, ...]`` (local is ``x``, or its float32
    copy under ``hp``), differentiable, and ``waits[i]`` must be called
    before ``buf_i`` is read."""
    if not plans:
        return [x], []
    waits: list = []
    outs = _GroupCast.apply(x, tuple(plans), group, hp, waits)
    return (list(outs) if hp else [x, *outs]), waits


def group_cast_rows(x: torch.Tensor, plan: CastPlan, group) -> torch.Tensor:
    """GroupCast of one stage, waited for: the ``[buf_len, ...]`` receive
    buffer. Differentiable: its backward is :func:`group_reduce_rows`."""
    (_, buf), waits = group_cast_all(x, [plan], group)
    waits[0]()
    return buf


def all_gather_v(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along dim 0 (the
    shards are padded to one length, as the dispatch pads them)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
