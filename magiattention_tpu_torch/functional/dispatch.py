"""Dispatch / undispatch, per rank.

The port's counterpart of ``magiattention_tpu/functional/dispatch.py``.
The JAX functions map one global array to another (a permuting gather
with a sharding constraint); here each rank holds its own shard, and the
functions keep the global arrays' semantics:

- :func:`dispatch_func`: the natural-order tensor (the same on every rank)
  -> this rank's rows ``x[position_ids[rank]]``. Its backward all-gathers
  the shards' gradients and un-permutes them, so every rank gets the whole
  input gradient, as JAX's transpose gives the global one.
- :func:`undispatch_func`: this rank's shard -> the natural-order tensor,
  by all-gathering the shards (``all_gather_v``) and un-permuting. Its
  backward takes this rank's rows of the (identical on every rank)
  output gradient; pad rows of an uneven shard get 0.

At cp = 1 (no group) there are no collectives: both are one gather.
"""

from __future__ import annotations

import torch

from ..comm.primitives import all_gather_v
from ..utils.profiling import instrument_scope


def _gather_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else all_gather_v(x, group)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, unpermute, group):
        ctx.unpermute, ctx.group = unpermute, group
        return x.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        full = _gather_all(g, ctx.group).index_select(0, ctx.unpermute)
        return full, None, None, None


class _Undispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, rows, n_valid, unpermute, group):
        ctx.rows, ctx.n_valid = rows, n_valid
        return _gather_all(y, group).index_select(0, unpermute)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros((ctx.rows.shape[0], *g.shape[1:]))
        n = ctx.n_valid
        out[:n] = g.index_select(0, ctx.rows[:n])
        return out, None, None, None, None


@instrument_scope
def dispatch_func(
    x: torch.Tensor, rows: torch.Tensor, unpermute: torch.Tensor, group
) -> torch.Tensor:
    """Natural order -> this rank's dispatched rows.

    Args:
        x: ``(total_seqlen, ...)`` natural order, the same on every rank.
        rows: ``(shard,)`` int64, the global row of each local row
            (``DispatchMeta.position_ids[rank]``).
        unpermute: ``(total_seqlen,)`` int64, each global row's index in
            the rank-major concatenation of the shards.
        group: the cp process group; None at cp = 1.
    """
    return _Dispatch.apply(x, rows, unpermute, group)


@instrument_scope
def undispatch_func(
    y: torch.Tensor,
    rows: torch.Tensor,
    n_valid: int,
    unpermute: torch.Tensor,
    group,
) -> torch.Tensor:
    """This rank's dispatched rows -> the natural-order tensor (the same on
    every rank). ``rows``/``unpermute`` as in :func:`dispatch_func`;
    ``n_valid`` is the rank's number of real (unpadded) rows."""
    return _Undispatch.apply(y, rows, n_valid, unpermute, group)
