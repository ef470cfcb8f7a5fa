"""Blockwise-online softmax attention: the second plain backend.

The port's copy of ``magiattention_tpu/kernels/sdpa_online.py``: the same
contract as :func:`~.sdpa.sdpa_attn`, computed with an online softmax over
blocks of ``block_k`` keys, so the logits of only one block exist at a
time. It is plain PyTorch, differentiable by autograd, and runs on any
device; it is a reference, no kernel. ``sdpa_online_attn.calls`` counts
its calls so a run can show that the card's path never took it.
"""

from __future__ import annotations

import numpy as np
import torch

from .mask_utils import build_dense_mask_band, types_to_bands


def sdpa_online_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map=None,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    d_lo=None,
    d_hi=None,
    block_k: int = 512,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`~.sdpa.sdpa_attn`, O(sq * block_k) logits.

    The running max is a stabilizer only (out and lse do not depend on it),
    so it is taken without autograd: the gradients stay exact, and no
    ``-inf - -inf`` enters the backward on rows no slice covers.
    """
    sdpa_online_attn.calls += 1
    sq, hq, d = q.shape
    sk, hk, dv = v.shape
    g = hq // hk
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if d_lo is None or d_hi is None:
        if attn_type_map is None:
            attn_type_map = np.zeros(len(np.asarray(q_ranges)), np.int32)
        d_lo, d_hi = types_to_bands(q_ranges, k_ranges, attn_type_map)
    mask = build_dense_mask_band(
        q_ranges, k_ranges, d_lo, d_hi, sq, sk, device=q.device
    )

    qc = q.to(compute_dtype)
    kc = k.to(compute_dtype).repeat_interleave(g, dim=1)
    vc = v.to(compute_dtype).repeat_interleave(g, dim=1)

    m = torch.full((hq, sq), float("-inf"), dtype=compute_dtype, device=q.device)
    l = torch.zeros((hq, sq), dtype=compute_dtype, device=q.device)
    acc = torch.zeros((sq, hq, dv), dtype=compute_dtype, device=q.device)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        blk = mask[:, k0:k1]
        logits = torch.einsum("qhd,khd->hqk", qc, kc[k0:k1]) * softmax_scale
        if softcap > 0.0:
            logits = softcap * torch.tanh(logits / softcap)
        logits = logits.masked_fill(~blk, float("-inf"))
        with torch.no_grad():
            m_new = torch.maximum(m, logits.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            alpha = torch.exp(m - m_safe)  # 0 where m was -inf
        p = torch.exp(logits - m_safe[..., None]).masked_fill(~blk, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.T[..., None] + torch.einsum("hqk,khd->qhd", p, vc[k0:k1])
        m = m_new

    empty = l == 0.0
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    l_safe = torch.where(empty, 1.0, l)
    lse = torch.where(empty, float("-inf"), m_safe + torch.log(l_safe))
    out = (acc / l_safe.T[..., None]).masked_fill(empty.T[..., None], 0.0)
    return out.to(q.dtype), lse.T.contiguous().float()


sdpa_online_attn.calls = 0
