"""LoongTrain (2D attention + double ring) context-parallel baseline.

The port's counterpart of ``magiattention_tpu/parallel/loongtrain.py``
(ref exps/dist_attn/baselines/loongtrain.py). On ``U * O * I`` ranks:

- **2D attention** (head x context): a Ulysses group of ``U`` turns
  sequence shards into head shards with an all-to-all, and the remaining
  ``R = O * I`` ranks form the context ring.
- **Double ring**: the ring splits into inner windows of ``I`` (intra
  node) and an outer ring of ``O`` windows: ``I - 1`` inner hops for each
  outer hop. The kv visiting ring rank ``(io, ii)`` at step ``(o, s)``
  comes from ring rank ``((io - o) % O) * I + (ii - s) % I`` (ref :148
  window_offset; :func:`src_of`).
- **Zigzag sharding** on the ring dim (ring rank r owns chunks r and
  2R-1-r), or contiguous blocks.

Head-first and context-first placement (the paper's two process-group
constructions) is which role varies fastest over the global ranks: the
mesh's construction (:func:`make_loongtrain_mesh`), not the attention.
Under either, a process holds shard ``io * I * U + ii * U + u`` of the
dispatched sequence, its mesh coordinate read over ``(rp_out, rp_in,
sp)`` (``local_shard(x, mesh, (outer, inner, ulysses))``), whatever its
global rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..comm.functional import Hop, all_to_all, ring_hops, ring_pass
from ..functional.dist_attn import multi_ffa
from ..kernels.ffa import default_blocks
from ..kernels.ffa_plan import FFAPlan
from ._mesh import ProcessMesh
from ._utils import band_meta, baseline_params, ring_step_plans, softmax_scale_of, zigzag_ring_step_plans
from .ring import _check_sharding
from .ulysses import check_heads

AXES = ("rp_out", "rp_in", "sp")


def make_loongtrain_mesh(
    ranks, ulysses: int, outer: int, inner: int, placement: str = "head_first",
) -> ProcessMesh:
    """The LoongTrain mesh over axes ``("rp_out", "rp_in", "sp")`` from
    the first ``ulysses * outer * inner`` of ``ranks`` (None: the world's).

    head_first (ref default): the Ulysses group takes adjacent ranks, so
    the head all-to-all rides the cheapest links; the inner ring is next.
    context_first: the inner-window ring takes adjacent ranks, so ring hops
    ride the cheapest links. Collective: every process calls it."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    r = np.asarray(list(ranks), dtype=np.int64).reshape(-1)[: ulysses * outer * inner]
    if placement == "head_first":
        return ProcessMesh(r.reshape(outer, inner, ulysses), AXES)
    if placement == "context_first":
        return ProcessMesh(r.reshape(ulysses, outer, inner).transpose(1, 2, 0), AXES)
    raise ValueError(f"unknown placement: {placement!r}")


def src_of(outer: int, inner: int):
    """``src(b, t)``: the ring rank whose kv visits ring rank ``b`` at
    step ``t`` of the double ring (outer round ``t // I``, inner hop
    ``t % I``)."""

    def src(b: int, t: int) -> int:
        io, ii = divmod(b, inner)
        o, s = divmod(t, inner)
        return ((io - o) % outer) * inner + (ii - s) % inner

    return src


def loongtrain_rank_plans(
    q_ranges, k_ranges, attn_type_map, S: int, outer: int, inner: int, rank: int,
    sharding: str = "zigzag",
) -> list[FFAPlan]:
    """Ring rank ``rank``'s plan per double-ring step."""
    _check_sharding(sharding)
    qr, kr, lo, hi = band_meta(q_ranges, k_ranges, attn_type_map)
    R = outer * inner
    shard = S // R
    bq, bk = default_blocks(shard, shard)
    steps = zigzag_ring_step_plans if sharding == "zigzag" else ring_step_plans
    return steps(qr, kr, lo, hi, shard, R, bq, bk, rank, ring_rank_of=src_of(outer, inner))


def double_ring_hops(mesh: ProcessMesh, outer_axis: str, inner_axis: str) -> list[Hop]:
    """The hops of the double ring: for each outer round o, an outer hop of
    round o - 1's first buffer (o > 0), then ``I - 1`` inner hops; buffer
    ``o * I + s`` is the kv of step ``(o, s)``."""
    O, I = mesh.shape[outer_axis], mesh.shape[inner_axis]
    io, out_line = mesh.coord(outer_axis), mesh.line(outer_axis)
    hops = []
    for o in range(O):
        if o > 0:
            hops.append(Hop((o - 1) * I, mesh.group(outer_axis),
                            out_line[(io + 1) % O], out_line[(io - 1) % O]))
        hops += ring_hops(I, mesh.line(inner_axis), mesh.coord(inner_axis),
                          mesh.group(inner_axis), src=o * I)
    return hops


def loongtrain_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    mesh: ProcessMesh,
    outer_axis: str = "rp_out",
    inner_axis: str = "rp_in",
    ulysses_axis: str | None = None,
    softmax_scale: float | None = None,
    sharding: str = "zigzag",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence-sharded in/out over the (outer, inner[, ulysses]) axes.

    Args:
        q/k/v: this process's shard ``mesh.index((outer, inner[,
            ulysses]))`` of the sequence, in ``ring_dispatch(x, O * I)``
            layout under ``sharding='zigzag'`` (ring rank ``io * I + ii``
            owns zigzag chunks ``r`` and ``2R-1-r``).
        ulysses_axis: when set, 2D attention: heads split over this axis
            with an all-to-all, so only heads divisible by ``U`` are
            required.

    Returns:
        (out, lse float32) of this process's rows; differentiable in q,
        k and v.
    """
    O, I = mesh.shape[outer_axis], mesh.shape[inner_axis]
    ug = mesh.group(ulysses_axis) if ulysses_axis else None
    if ulysses_axis:
        check_heads(q.shape[1], k.shape[1], mesh.shape[ulysses_axis], "loongtrain 2D attention")
        q, k, v = (all_to_all(t, ug, 1, 0) for t in (q, k, v))
    rank = mesh.index((outer_axis, inner_axis))
    plans = loongtrain_rank_plans(
        q_ranges, k_ranges, attn_type_map, q.shape[0] * O * I, O, I, rank, sharding
    )
    scale = softmax_scale_of(q.shape[-1], softmax_scale)
    (ks, vs), waits = ring_pass((k, v), double_ring_hops(mesh, outer_axis, inner_axis))
    out, lse = multi_ffa(q, ks, vs, plans, [baseline_params(p, scale) for p in plans], waits)
    if ulysses_axis:
        out, lse = all_to_all(out, ug, 0, 1), all_to_all(lse, ug, 0, 1)
    return out, lse
