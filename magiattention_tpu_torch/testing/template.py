"""Overlap-safety assertion: the port's counterpart of
``magiattention_tpu/testing/template.py`` (ref:
magi_attention/testing/template.py:77).

The overlapped CP program reads each stage's receive buffer as soon as
that stage's transfer lands, and (in the backward) issues each stage's
GroupReduce while the next part computes. A part read before its
transfer landed, or a reduce summed before its rows arrived, shows as a
mismatch between the overlapped program and the blocking one (every
stage waited for, one FFA over the merged buffer), which is what
:func:`assert_overlap_safe` checks, forward and backward. On CUDA the
transfers run on NCCL's streams, so this guards the stream ordering; on
the CPU it runs over gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..functional.dist_attn import DistAttnRuntime
from ..parallel._mesh import ProcessMesh
from .precision import assert_close

NAMES = ("out", "lse", "dq", "dk", "dv")


def _fwd_bwd(runtime: DistAttnRuntime, q, k, v, do) -> list[torch.Tensor]:
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out, lse = runtime.calc_attn(*leaves)
    return [out.detach(), lse, *torch.autograd.grad(out, leaves, do)]


def assert_overlap_safe(
    comm_meta,
    calc_meta,
    group,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cp_axis: str = "cp",
    do: torch.Tensor | None = None,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    iters: int = 3,
) -> None:
    """Assert the overlapped CP program matches the blocking one.

    Every rank of the cp group calls this with its own rows.

    Args:
        comm_meta/calc_meta: a solved plan with at least one remote stage
            (the manager's ``comm_meta`` and ``calc_meta``).
        group: the cp process group, or a ``ProcessMesh`` whose
            ``cp_axis`` line (an axis or a pair of axes) is the cp group.
        q/k/v: this rank's dispatched rows.
        do: the cotangent of out (default: seeded normal values).
        atol/rtol: the tolerance of out, lse (-inf rows zeroed on both
            sides), dq, dk and dv; ``rtol`` also bounds the relative norm.
        iters: overlapped runs, each held against the blocking run (the
            reference stress-loops: a race need not show every time).

    Raises:
        AssertionError: naming the iteration and the tensor that differ.
    """
    if not comm_meta.kv_stages:
        raise ValueError("assert_overlap_safe needs a plan with at least one remote stage")
    if isinstance(group, ProcessMesh):
        axes = (cp_axis,) if isinstance(cp_axis, str) else tuple(cp_axis)
        rank, group = group.index(axes), group.group(cp_axis)
    else:
        rank = dist.get_rank(group)
    overlapped, blocking = (
        DistAttnRuntime(comm_meta, calc_meta, rank, group, use_overlap=overlap)
        for overlap in (True, False)
    )
    if do is None:
        gen = torch.Generator(device=q.device).manual_seed(0)
        do = torch.randn((*q.shape[:2], v.shape[-1]), generator=gen, device=q.device).to(q.dtype)
    want = _fwd_bwd(blocking, q, k, v, do)
    want[1] = torch.where(torch.isneginf(want[1]), 0.0, want[1])
    for i in range(iters):
        got = _fwd_bwd(overlapped, q, k, v, do)
        got[1] = torch.where(torch.isneginf(got[1]), 0.0, got[1])
        for name, a, b in zip(NAMES, got, want):
            assert_close(
                a, b, atol=atol, rtol=rtol, norm_rtol=rtol,
                msg=f"overlap-safety iter {i}: {name} mismatch",
            )
