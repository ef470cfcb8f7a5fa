"""Differentiable collectives over a subgroup, for the CP baselines and the
sharded trainers.

The JAX baselines get these from XLA inside ``shard_map`` and their
backward from AD; here each is a ``torch.autograd.Function`` whose
backward is the forward's adjoint, written out:

- :func:`all_to_all` is ``jax.lax.all_to_all(x, axis, split_axis,
  concat_axis, tiled=True)``: chunk j of the split dim goes to group rank
  j, and the chunks received concatenate along the concat dim in source
  order (Ulysses: sequence shards to head shards is ``(1, 0)``, and back
  ``(0, 1)``). One ``all_to_all_single`` over a contiguous copy laid out
  chunk-major; the adjoint is the inverse all-to-all.
- :func:`ring_pass` is the ``jax.lax.ppermute`` chain of the ring
  baselines: buffers that each arrive one hop after another, every hop a
  ``batch_isend_irecv`` to the next rank of a subgroup and from the
  previous one. The caller gets every buffer and a ``wait`` per buffer;
  waiting for hop s starts hop s + 1, so hop s + 1 runs while part s is
  computed (``multi_ffa``'s waits). The adjoint sends each buffer's
  gradient back along its hop, last hop first, adding it to its source's:
  one reverse hop per forward hop.
- :func:`all_gather` along dim 0 (``all_gather_into_tensor``), whose
  adjoint is the reduce-scatter (``reduce_scatter_tensor``, sum): the
  group's ranks each hold a share of the gradient (their own rows'), as
  a ZeRO-3 parameter gather over the data (cp) line needs.
- Megatron's region primitives over a group whose ranks compute the same
  rows (a tensor-parallel line): :func:`copy_to_region` (identity; the
  adjoint all-reduces), :func:`reduce_from_region` (all-reduce; the
  adjoint is the identity), :func:`scatter_to_region` (this rank's chunk
  of dim 0; the adjoint all-gathers) and :func:`gather_from_region`
  (all-gather along dim 0; the adjoint takes this rank's chunk). A value
  outside a region is equal on every rank of the group and so is its
  gradient, which the adjoints keep.

Each collective issued here adds one to :func:`collective_counts`
(``all_gather``, ``reduce_scatter``, ``all_reduce``): the trainers' count
of a step's collectives. The CP runtime's GroupCast and GroupReduce and
the trainers' own ``all_reduce`` calls are not counted here.

Each takes the subgroup and, where peers are named, the global ranks of
the subgroup in group-rank order (``ProcessMesh.line``): point-to-point
peers are global ranks even inside a subgroup. A group of None is a
subgroup of one rank: every collective is then the identity.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

_COUNTS: Counter = Counter()


def collective_counts() -> dict[str, int]:
    """The collectives issued here since the last reset, by kind."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _a2a(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = _group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split in {n}")
    chunks = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    send = chunks.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] came from group rank j: concatenate in source order
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, ctx.group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all over ``group`` (see the module docstring),
    differentiable; the identity on a group of one rank."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


@dataclass(frozen=True)
class Hop:
    """One hop of a ring pass: buffer ``src`` (an earlier buffer's index)
    goes to global rank ``to`` and the new buffer comes from global rank
    ``frm``, both of ``group``."""

    src: int
    group: object
    to: int
    frm: int


def ring_hops(n: int, line: list[int], coord: int, group, src: int = 0) -> list[Hop]:
    """The ``n - 1`` hops of a ring over ``line`` (the subgroup's global
    ranks) from buffer ``src``, each forwarding the previous buffer to
    the next coordinate: after s hops this rank holds the buffer of the
    rank ``s`` coordinates before it (``jax.lax.ppermute`` with perm
    ``[(i, (i + 1) % n)]``, s times)."""
    to, frm = line[(coord + 1) % n], line[(coord - 1) % n]
    return [Hop(src + s, group, to, frm) for s in range(n - 1)]


def _hop_start(hop: Hop, xs: tuple, out: tuple, reverse: bool = False):
    """Post one hop's sends and receives of the tensors ``xs`` into
    ``out``; returns the requests. ``reverse`` swaps the peers."""
    to, frm = (hop.frm, hop.to) if reverse else (hop.to, hop.frm)
    ops = []
    for x, o in zip(xs, out):
        ops.append(dist.P2POp(dist.isend, x, to, hop.group))
        ops.append(dist.P2POp(dist.irecv, o, frm, hop.group))
    return dist.batch_isend_irecv(ops)


class _RingPass(torch.autograd.Function):
    """``xs`` (tensors that travel together, e.g. k and v) and their
    buffers after each hop. Returns, per tensor, the buffers ``[x, after
    hop 1, ...]`` flattened tensor-major. The forward posts hop 1 only;
    ``waits[s]`` (s >= 1, appended to the caller's list) completes hop s
    and posts hop s + 1."""

    @staticmethod
    def forward(ctx, hops, waits, *xs):
        bufs = [[x] for x in xs]
        for _ in hops:
            for b, x in zip(bufs, xs):
                b.append(torch.empty_like(x))
        pending: dict[int, list] = {}

        def start(t):  # hop t fills buffer t + 1
            hop = hops[t]
            pending[t] = _hop_start(
                hop, tuple(b[hop.src].contiguous() for b in bufs), tuple(b[t + 1] for b in bufs)
            )

        def wait(t):
            for req in pending.pop(t):
                req.wait()
            if t + 1 < len(hops):
                start(t + 1)

        if hops:
            start(0)
        waits.append(None)  # buffer 0 is x itself
        waits.extend(lambda t=t: wait(t) for t in range(len(hops)))
        ctx.hops, ctx.n_tensors = hops, len(xs)
        return tuple(b_i for b in bufs for b_i in b)

    @staticmethod
    def backward(ctx, *grads):
        hops, n_bufs = ctx.hops, len(ctx.hops) + 1
        acc = [list(grads[i * n_bufs:(i + 1) * n_bufs]) for i in range(ctx.n_tensors)]
        for t in reversed(range(len(hops))):  # buffer t + 1 goes back to hop.src
            hop = hops[t]
            back = tuple(torch.empty_like(a[t + 1]) for a in acc)
            reqs = _hop_start(hop, tuple(a[t + 1].contiguous() for a in acc), back, reverse=True)
            for req in reqs:
                req.wait()
            for a, b in zip(acc, back):
                a[hop.src] = a[hop.src] + b
        return (None, None, *(a[0] for a in acc))


def ring_pass(xs: tuple, hops: list[Hop]) -> tuple[list[list[torch.Tensor]], list]:
    """Pass the tensors ``xs`` along ``hops`` (see :func:`ring_hops`).

    Returns (buffers, waits): ``buffers[i]`` is tensor i's ``[x_i, after
    hop 1, ..., after hop n-1]``, differentiable; ``waits[s]`` must be
    called before buffer s is read (None for buffer 0), in order, and
    calling it starts the next hop. Every wait must be called."""
    waits: list = []
    if not hops:
        return [[x] for x in xs], [None]
    flat = _RingPass.apply(hops, waits, *xs)
    n = len(hops) + 1
    return [list(flat[i * n:(i + 1) * n]) for i in range(len(xs))], waits


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty((_group_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    _COUNTS["all_gather"] += 1
    return out


def _chunk(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of dim 0 of ``x`` (group-rank order)."""
    n = _group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split in {n}")
    rows = x.shape[0] // n
    return x.narrow(0, dist.get_rank(group) * rows, rows)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    _COUNTS["all_reduce"] += 1
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // _group_size(ctx.group), *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        _COUNTS["reduce_scatter"] += 1
        return out, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``x`` concatenated along dim 0 in group-rank
    order, differentiable (the backward reduce-scatters, summing); the
    identity on a group of one rank."""
    if _group_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk(x, group).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group).contiguous(), None


def _region(fn, x: torch.Tensor, group) -> torch.Tensor:
    return x if _group_size(group) == 1 else fn.apply(x, group)


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a region of ``group`` (Megatron's copy): the
    identity; the backward all-reduces the gradient over the group."""
    return _region(_CopyToRegion, x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's partial ``x`` leaving a region (Megatron's
    reduce): ``all_reduce``; the backward is the identity."""
    return _region(_ReduceFromRegion, x, group)


def scatter_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of dim 0 of a value equal on every rank of
    ``group`` (Megatron's scatter); the backward all-gathers the chunks'
    gradients."""
    return _region(_ScatterToRegion, x, group)


def gather_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's ``x`` along dim 0 in group-rank order, for a
    computation that each rank of ``group`` then runs alike (Megatron's
    gather); the backward takes this rank's chunk of the gradient, which
    every rank holds whole."""
    return _region(_GatherFromRegion, x, group)
