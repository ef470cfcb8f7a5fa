"""Ring attention baselines: P2P rotation and AllGather.

The port's counterpart of ``magiattention_tpu/parallel/ring.py`` (ref
exps/dist_attn/baselines/ring_attn.py: RingAttnP2P :1668,
RingAttnAllGather :1460), over *zigzag* sequence sharding (shard.py:486:
the sequence splits into 2*cp chunks and rank r owns chunks r and
2cp-1-r, so a causal mask's area balances) or contiguous blocks.

- P2P (:func:`ring_attn`): k and v rotate one hop a step
  (:func:`..comm.functional.ring_pass`); each rank computes its q block
  against every visiting kv block, one FFA part per step, and the parts
  merge by lse (:func:`..functional.dist_attn.multi_ffa`). Hop s + 1
  runs while part s is computed. Arbitrary band-slice masks work by
  clipping the global metadata to every (q owner, kv owner) pair on the
  host; a pair with nothing to compute is a part with no work item (out 0,
  lse -inf), and its buffer still travels on.
- AllGather (:func:`ring_attn_allgather`): k and v are all-gathered up
  front, reordered zigzag -> natural by an index, and each rank runs one
  FFA of its q block against the whole sequence. The backward
  reduce-scatters dk and dv (the all-gather's adjoint; the reorder's is an
  ``index_add_``).

Inputs and outputs are this rank's shard; :func:`ring_dispatch` /
:func:`ring_undispatch` permute a whole sequence into and out of the
layout, and ``local_shard(x, mesh, (cp_axis,))`` cuts a rank's rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm.functional import all_gather, ring_hops, ring_pass
from ..functional.dist_attn import multi_ffa
from ..kernels.ffa import default_blocks
from ..kernels.ffa_plan import FFAPlan
from ._mesh import ProcessMesh
from ._utils import (
    band_meta,
    baseline_params,
    block_plan,
    check_zigzag_geometry,
    clip_to_segs,
    ring_step_plans,
    softmax_scale_of,
    zigzag_inv_perm,
    zigzag_perm,
    zigzag_ring_step_plans,
    zigzag_segs,
)

SHARDINGS = ("zigzag", "contig")


def _check_sharding(sharding: str) -> None:
    if sharding not in SHARDINGS:
        raise ValueError(f"unknown ring sharding: {sharding!r}")


def _permute(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    return x.index_select(0, torch.from_numpy(perm).to(x.device))


def ring_dispatch(x: torch.Tensor, cp: int, sharding: str = "zigzag") -> torch.Tensor:
    """Natural global order -> the layout ``ring_attn`` shards (ref
    shard.py zigzag_dispatch). Identity for contiguous."""
    _check_sharding(sharding)
    return x if sharding == "contig" else _permute(x, zigzag_perm(x.shape[0], cp))


def ring_undispatch(x: torch.Tensor, cp: int, sharding: str = "zigzag") -> torch.Tensor:
    """Inverse of :func:`ring_dispatch` (ref shard.py zigzag_undispatch)."""
    _check_sharding(sharding)
    return x if sharding == "contig" else _permute(x, zigzag_inv_perm(x.shape[0], cp))


def ring_rank_plans(
    q_ranges, k_ranges, attn_type_map, S: int, cp: int, rank: int, sharding: str = "zigzag",
) -> list[FFAPlan]:
    """``rank``'s plan per ring step: its q shard against the kv shard of
    rank ``(rank - s) % cp`` at step s."""
    _check_sharding(sharding)
    qr, kr, lo, hi = band_meta(q_ranges, k_ranges, attn_type_map)
    shard = S // cp
    bq, bk = default_blocks(shard, shard)
    steps = zigzag_ring_step_plans if sharding == "zigzag" else ring_step_plans
    return steps(qr, kr, lo, hi, shard, cp, bq, bk, rank)


def allgather_rank_plan(
    q_ranges, k_ranges, attn_type_map, S: int, cp: int, rank: int, sharding: str = "zigzag",
) -> FFAPlan:
    """``rank``'s one plan in the AllGather variant: its q shard against
    the whole sequence in natural order."""
    _check_sharding(sharding)
    qr, kr, lo, hi = band_meta(q_ranges, k_ranges, attn_type_map)
    shard = S // cp
    if sharding == "zigzag":
        check_zigzag_geometry(shard, cp)
        q_segs = zigzag_segs(rank, cp, shard // 2)
    else:
        q_segs = [(rank * shard, (rank + 1) * shard, 0)]
    bq, bk = default_blocks(shard, S)
    return block_plan(clip_to_segs(qr, kr, lo, hi, q_segs, [(0, S, 0)]), shard, S, bq, bk)


def ring_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    mesh: ProcessMesh,
    cp_axis: str = "cp",
    softmax_scale: float | None = None,
    sharding: str = "zigzag",
) -> tuple[torch.Tensor, torch.Tensor]:
    """P2P ring attention (ref RingAttnP2P).

    Args:
        q/k/v: this rank's ``(S / cp, h, d)`` shard of the
            ``ring_dispatch(x, cp, sharding)`` layout (shard
            ``mesh.coord(cp_axis)``).
        q_ranges/k_ranges/attn_type_map: the global slice metadata (host).
        sharding: ``zigzag`` (the reference's layout, causal balanced) or
            ``contig`` (contiguous blocks).

    Returns:
        (out ``(S / cp, hq, dv)``, lse ``(S / cp, hq)`` float32), this
        rank's rows in the same layout; differentiable in q, k and v.
    """
    cp, rank = mesh.shape[cp_axis], mesh.coord(cp_axis)
    plans = ring_rank_plans(q_ranges, k_ranges, attn_type_map, q.shape[0] * cp, cp, rank, sharding)
    scale = softmax_scale_of(q.shape[-1], softmax_scale)
    (ks, vs), waits = ring_pass(
        (k, v), ring_hops(cp, mesh.line(cp_axis), rank, mesh.group(cp_axis))
    )
    return multi_ffa(q, ks, vs, plans, [baseline_params(p, scale) for p in plans], waits)


def gathered_attn(q, k, v, plan: FFAPlan, group, reorder, softmax_scale):
    """One FFA of q against k/v all-gathered over ``group`` and, where
    ``reorder`` is given, permuted to natural order by it."""
    k_all, v_all = all_gather(k, group), all_gather(v, group)
    if reorder is not None:
        k_all, v_all = _permute(k_all, reorder), _permute(v_all, reorder)
    params = baseline_params(plan, softmax_scale_of(q.shape[-1], softmax_scale))
    return multi_ffa(q, [k_all], [v_all], [plan], [params])


def ring_attn_allgather(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    mesh: ProcessMesh,
    cp_axis: str = "cp",
    softmax_scale: float | None = None,
    sharding: str = "zigzag",
) -> tuple[torch.Tensor, torch.Tensor]:
    """AllGather ring attention (ref RingAttnAllGather): one up-front kv
    all-gather and one FFA per rank; dk/dv reduce-scatter in the backward.
    Same layout contract as :func:`ring_attn`."""
    cp, rank = mesh.shape[cp_axis], mesh.coord(cp_axis)
    S = q.shape[0] * cp
    plan = allgather_rank_plan(q_ranges, k_ranges, attn_type_map, S, cp, rank, sharding)
    reorder = zigzag_inv_perm(S, cp) if sharding == "zigzag" else None
    return gathered_attn(q, k, v, plan, mesh.group(cp_axis), reorder, softmax_scale)
