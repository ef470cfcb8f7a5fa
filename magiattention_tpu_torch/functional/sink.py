"""Attention-sink support (the port's copy of
``magiattention_tpu/functional/sink.py``).

Sink tokens contribute learnable logits to every query row's softmax
normalization but no value vectors. Layouts:

    sh:  ``(s_sink, h)``     one shared sink strip for every query row
    ssh: ``(sq, s_sink, h)`` per-query-row sink logits
    shd: ``(s_sink, h, d)``  NotImplementedError, as in the JAX package

With per-row sink lse ``L_i = logsumexp_j sink[(i,)j,h]``:

    lse' = logaddexp(lse, L)                         (per row, per head)
    out' = out * exp(lse - lse')

The kernel backward runs against lse', which renormalizes dq/dk/dv
exactly, and
    sh:  dsink[j, h]    = -sum_i exp(sink[j,h] - lse'[i,h]) * delta[i,h]
    ssh: dsink[i, j, h] = -exp(sink[i,j,h] - lse'[i,h]) * delta[i,h]
with delta = rowsum(do * out').
"""

from __future__ import annotations

import torch


def check_sink_layout(sink_layout: str) -> None:
    """The one place the supported layouts are decided."""
    if sink_layout == "shd":
        raise NotImplementedError(
            "sink_layout='shd' is not supported (nor is it in the JAX package)"
        )
    if sink_layout not in ("sh", "ssh"):
        raise ValueError(f"invalid sink_layout: {sink_layout!r}")


def _sink_lse(sink: torch.Tensor, sink_layout: str, seqlen_q: int) -> torch.Tensor:
    """Per-row sink normalizer ``(s, h)`` float32."""
    check_sink_layout(sink_layout)
    s32 = sink.float()
    if sink_layout == "sh":
        if sink.dim() != 2:
            raise ValueError(f"'sh' sink must be (s_sink, h), got {tuple(sink.shape)}")
        return torch.logsumexp(s32, dim=0)[None, :].expand(seqlen_q, sink.shape[1])
    if sink.dim() != 3 or sink.shape[0] != seqlen_q:
        raise ValueError(
            f"'ssh' sink must be (seqlen_q={seqlen_q}, s_sink, h), "
            f"got {tuple(sink.shape)}"
        )
    return torch.logsumexp(s32, dim=1)


def apply_sink_fwd(
    out: torch.Tensor,
    lse: torch.Tensor,
    sink: torch.Tensor,
    sink_layout: str = "sh",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) without sink -> (out', lse') with the sink folded in.
    Plain torch ops, so autograd differentiates it (the sdpa backends).

    Args:
        out: ``(s, h, dv)``; lse: ``(s, h)`` float32; sink: see module doc.
    """
    sink_lse = _sink_lse(sink, sink_layout, lse.shape[0])  # (s, h)
    neg = torch.isneginf(lse)
    lse_new = torch.logaddexp(lse, sink_lse)
    lse_safe = torch.where(torch.isneginf(lse_new), 0.0, lse_new)
    w = torch.exp(torch.where(neg, float("-inf"), lse - lse_safe))
    out_new = (out.float() * w[..., None]).to(out.dtype)
    return out_new, lse_new


def sink_bwd(
    sink: torch.Tensor,
    lse_final: torch.Tensor,
    delta: torch.Tensor,
    sink_layout: str = "sh",
) -> torch.Tensor:
    """dsink from the final lse and delta.

    Args:
        sink: layout per module doc; lse_final: ``(s, h)``; delta: ``(s, h)``
            = rowsum(do * out_final), float32.
    """
    check_sink_layout(sink_layout)
    # rows with -inf lse' have no mass anywhere -> w = 0
    lse_safe = torch.where(torch.isneginf(lse_final), float("inf"), lse_final)
    if sink_layout == "sh":
        w = torch.exp(sink.float()[None, :, :] - lse_safe[:, None, :])
        return (-torch.einsum("ijh,ih->jh", w, delta)).to(sink.dtype)
    w = torch.exp(sink.float() - lse_safe[:, None, :])
    return (-w * delta[:, None, :]).to(sink.dtype)
