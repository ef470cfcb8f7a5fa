"""Ground-truth attention (the port's counterpart of
``magiattention_tpu/testing/ref_attn.py``, rewritten in torch).

A dense masked SDPA over an *explicit* boolean mask, float64 by default:
independent of the slice-metadata machinery, so it cross-checks both the
mask construction and the kernels. Differentiable by autograd in q, k, v
and the sink.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def _logits(q, k, mask, softmax_scale, softcap, compute_dtype):
    """``[hq, sq, sk]`` scaled, softcapped logits, -inf where masked out."""
    hq, d = q.shape[1], q.shape[-1]
    g = hq // k.shape[1]
    scale = d ** -0.5 if softmax_scale is None else softmax_scale
    qc = q.to(compute_dtype)
    kc = k.to(compute_dtype).repeat_interleave(g, dim=1)
    logits = torch.einsum("qhd,khd->hqk", qc, kc) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    m = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=q.device)
    return logits.masked_fill(~m[None], NEG_INF), m


def ref_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: np.ndarray,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.float64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense reference attention.

    Args:
        q/k/v: ``[sq,hq,d] / [sk,hk,d] / [sk,hk,dv]`` (varlen packed layout).
        mask: ``[sq, sk]`` boolean array (True = attend).
        sink: optional ``(s_sink, hq)`` learnable sink logits: extra softmax
            columns with no value contribution.
        compute_dtype: the arithmetic's dtype (float64 by default, as the
            JAX package's with x64 on).

    Returns:
        (out ``[sq,hq,dv]`` in q's dtype, lse ``[sq,hq]`` float32, natural
        log, -inf on rows nothing is attended).
    """
    sq, hq = q.shape[:2]
    g = hq // k.shape[1]
    logits, m = _logits(q, k, mask, softmax_scale, softcap, compute_dtype)
    vc = v.to(compute_dtype).repeat_interleave(g, dim=1)
    keep = m[None].expand_as(logits)
    if sink is not None:
        # sink columns take part in the softmax and contribute no value
        s_sink = sink.shape[0]
        cols = sink.to(compute_dtype).T[:, None, :].expand(hq, sq, s_sink)
        logits = torch.cat([logits, cols], dim=-1)
        keep = torch.cat([keep, torch.ones((hq, sq, s_sink), dtype=torch.bool, device=q.device)], -1)
        vc = torch.cat([vc, vc.new_zeros((s_sink, hq, vc.shape[-1]))], dim=0)
    lse = torch.logsumexp(logits, dim=-1)  # [hq, sq]
    p = torch.exp(logits - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    p = torch.where(keep, p, 0.0)
    out = torch.einsum("hqk,khd->qhd", p, vc)
    return out.to(q.dtype), lse.T.to(torch.float32)


def ref_max_logits(
    q: torch.Tensor,
    k: torch.Tensor,
    mask: np.ndarray,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    compute_dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Per-head max of the (scaled, softcapped) masked logits ``[hq]``
    float32: the golden model of ``AttnForwardMeta.max_logits``."""
    logits, _ = _logits(q, k, mask, softmax_scale, softcap, compute_dtype)
    return logits.amax(dim=(1, 2)).to(torch.float32)
