"""Ulysses (head-sharded) sequence parallelism baseline.

The port's counterpart of ``magiattention_tpu/parallel/ulysses.py`` (ref
exps/dist_attn/baselines/ulysess.py, DeepSpeed-SP): an all-to-all turns
sequence shards into head shards, every rank computes whole-sequence
attention for its heads with the *global* slice metadata (one FFA), and
the inverse all-to-all restores sequence shards. q heads and kv heads
split into contiguous chunks, so q head ``i`` and its kv head ``i // g``
land on one rank: each GQA group stays whole. Requires ``hq % cp == 0``
and ``hk % cp == 0``.
"""

from __future__ import annotations

import torch

from ..comm.functional import all_to_all
from ..kernels.ffa import ffa_attn
from ._mesh import ProcessMesh


def check_heads(hq: int, hk: int, n: int, what: str) -> None:
    if hq % n or hk % n:
        raise ValueError(f"{what} requires heads divisible by {n} ({hq}, {hk})")


def ulysses_attn(
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
    """Sequence-sharded in, sequence-sharded out.

    Args:
        q/k/v: this rank's ``(S / cp, h, d)`` shard of the natural order
            (shard ``mesh.coord(cp_axis)``).
        q_ranges/k_ranges/attn_type_map: the global slice metadata (host).

    Returns:
        (out ``(S / cp, hq, dv)``, lse ``(S / cp, hq)`` float32), this
        rank's rows; differentiable in q, k and v.
    """
    group = mesh.group(cp_axis)
    check_heads(q.shape[1], k.shape[1], mesh.shape[cp_axis], "ulysses")
    # (S / cp, h, d) -> (S, h / cp, d): split heads, gather the sequence
    qg, kg, vg = (all_to_all(t, group, 1, 0) for t in (q, k, v))
    out, lse = ffa_attn(qg, kg, vg, q_ranges, k_ranges, attn_type_map, softmax_scale=softmax_scale)
    return all_to_all(out, group, 0, 1), all_to_all(lse, group, 0, 1)
