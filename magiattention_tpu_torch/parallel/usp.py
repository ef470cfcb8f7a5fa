"""USP (Ulysses x Ring) sequence-parallel baseline.

The port's counterpart of ``magiattention_tpu/parallel/usp.py`` (ref
exps/dist_attn/baselines/usp.py): the ``ulysses`` axis turns sequence
shards into head shards with an all-to-all, and the ``ring`` axis rotates
kv blocks (the contiguous ring of :mod:`.ring`, as the JAX package runs
it). q/k/v are sharded over both axes, ``P((ring, ulysses))``: the process
at (r, u) holds shard ``r * U + u``, so after the all-to-all each ring
rank holds the contiguous block ``[r * S / R, (r + 1) * S / R)`` for its
head subset. Requires heads divisible by the ulysses size only.
"""

from __future__ import annotations

import torch

from ..comm.functional import all_to_all, ring_hops, ring_pass
from ..functional.dist_attn import multi_ffa
from ._mesh import ProcessMesh
from ._utils import baseline_params, softmax_scale_of
from .ring import ring_rank_plans
from .ulysses import check_heads


def usp_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map,
    mesh: ProcessMesh,
    ring_axis: str = "rp",
    ulysses_axis: str = "sp",
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence-sharded in/out over ``P((ring_axis, ulysses_axis))``.

    Args:
        q/k/v: this process's ``(S / (R * U), h, d)`` shard of the
            natural order (shard ``mesh.index((ring_axis, ulysses_axis))``).

    Returns:
        (out ``(S / (R * U), hq, dv)``, lse ``(S / (R * U), hq)``
        float32), this process's rows; differentiable in q, k and v.
    """
    R, r = mesh.shape[ring_axis], mesh.coord(ring_axis)
    ug = mesh.group(ulysses_axis)
    check_heads(q.shape[1], k.shape[1], mesh.shape[ulysses_axis], "usp")
    qg, kg, vg = (all_to_all(t, ug, 1, 0) for t in (q, k, v))
    plans = ring_rank_plans(q_ranges, k_ranges, attn_type_map, qg.shape[0] * R, R, r, "contig")
    scale = softmax_scale_of(q.shape[-1], softmax_scale)
    (ks, vs), waits = ring_pass(
        (kg, vg), ring_hops(R, mesh.line(ring_axis), r, mesh.group(ring_axis))
    )
    out, lse = multi_ffa(qg, ks, vs, plans, [baseline_params(p, scale) for p in plans], waits)
    return all_to_all(out, ug, 0, 1), all_to_all(lse, ug, 0, 1)
