"""Megatron HybridCP and the all-gather baseline.

The port's counterpart of ``magiattention_tpu/parallel/hybrid.py`` (ref
exps/dist_attn/baselines/hybrid_dcp.py and the all-gather variants of
ring_attn.py), two kv-replication strategies:

- :func:`allgather_attn`: every rank all-gathers the whole k/v over the
  cp axis and computes its q block against the sequence with the clipped
  global metadata: one collective, the most memory ("Ring AllGather"
  over contiguous blocks: :func:`.ring.ring_attn_allgather`'s contiguous
  case).
- :func:`hybrid_cp_attn`: two levels. k/v are all-gathered over the
  *intra* axis (one super-block per intra group), and the super-blocks
  ring over the *inter* axis, so the expensive links carry ring traffic
  while the cheap ones pay one gather.
"""

from __future__ import annotations

import torch

from ..comm.functional import all_gather, ring_hops, ring_pass
from ..functional.dist_attn import multi_ffa
from ..kernels.ffa import default_blocks
from ..kernels.ffa_plan import FFAPlan
from ._mesh import ProcessMesh
from ._utils import band_meta, baseline_params, block_plan, hybrid_step_slices, softmax_scale_of
from .ring import allgather_rank_plan, gathered_attn


def allgather_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    mesh: ProcessMesh,
    cp_axis: str = "cp",
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-gather-kv attention, sequence-sharded in/out over ``P(cp_axis)``
    (natural order, contiguous shards): (out, lse float32) of this rank's
    rows, differentiable in q, k and v."""
    cp, rank = mesh.shape[cp_axis], mesh.coord(cp_axis)
    plan = allgather_rank_plan(q_ranges, k_ranges, attn_type_map, q.shape[0] * cp, cp, rank, "contig")
    return gathered_attn(q, k, v, plan, mesh.group(cp_axis), None, softmax_scale)


def hybrid_rank_plans(
    q_ranges, k_ranges, attn_type_map, S: int, outer: int, inner: int, rank: int,
) -> list[FFAPlan]:
    """``rank``'s plan per inter-ring step (:func:`._utils.hybrid_step_slices`)."""
    qr, kr, lo, hi = band_meta(q_ranges, k_ranges, attn_type_map)
    shard, sup = S // (outer * inner), S // outer
    bq, bk = default_blocks(shard, sup)
    return [
        block_plan(sl, shard, sup, bq, bk)
        for sl in hybrid_step_slices(qr, kr, lo, hi, S, outer, inner, rank)
    ]


def hybrid_cp_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    mesh: ProcessMesh,
    inter_axis: str = "cp_inter",
    intra_axis: str = "cp_intra",
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level CP: all-gather kv intra, ring inter.

    q/k/v: this process's ``(S / (O * I), h, d)`` shard of the natural
    order under ``P((inter_axis, intra_axis))``: the process at (io, ii)
    owns contiguous block ``io * I + ii``, and the intra group of ``io``
    super-block ``[io * S / O, (io + 1) * S / O)``. Returns (out, lse
    float32) of its rows, differentiable in q, k and v.
    """
    O, I = mesh.shape[inter_axis], mesh.shape[intra_axis]
    io = mesh.coord(inter_axis)
    rank = mesh.index((inter_axis, intra_axis))
    plans = hybrid_rank_plans(q_ranges, k_ranges, attn_type_map, q.shape[0] * O * I, O, I, rank)
    scale = softmax_scale_of(q.shape[-1], softmax_scale)
    intra = mesh.group(intra_axis)
    (ks, vs), waits = ring_pass(
        (all_gather(k, intra), all_gather(v, intra)),
        ring_hops(O, mesh.line(inter_axis), io, mesh.group(inter_axis)),
    )
    return multi_ffa(q, ks, vs, plans, [baseline_params(p, scale) for p in plans], waits)
