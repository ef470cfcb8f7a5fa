"""DSA: per-token, per-kv-head top-k sparse attention.

The port's counterpart of ``magiattention_tpu/extensions/dsa_interface.py``:
q attends, per kv head, only the ``topk`` key tokens that ``index_map``
selects. Two backends, both plain PyTorch, differentiated by autograd, as
the JAX package's are plain ``jnp``:

  "gather" — gather the selected K/V tokens per (kv head, q row) into a
      dense ``(sq, topk)`` tile and run a softmax over it;
  "sdpa" — the dense masked oracle (O(sq * skv) memory).
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def gather_sparse_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    index_map: torch.Tensor,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-based top-k sparse attention.

    Args:
        q: ``(sq, hq, d)``; k/v: ``(skv, hk, d)``; ``hq % hk == 0``.
        index_map: ``(hk, sq, topk)`` selected key indices per kv head
            (duplicates count once: the first occurrence is kept).

    Returns:
        (out ``(sq, hq, dv)``, lse ``(sq, hq)`` float32).
    """
    sq, hq, dh = q.shape
    skv, hk, dv = v.shape
    g = hq // hk
    scale = dh ** -0.5 if softmax_scale is None else softmax_scale
    idx = index_map.to(device=q.device, dtype=torch.int64)  # (hk, sq, topk)
    topk = idx.shape[-1]
    pos = torch.arange(topk, device=q.device)
    same = idx[..., None, :] == idx[..., :, None]  # [h, s, i, j]: idx_i == idx_j
    first = torch.where(same, pos[:, None], topk).amin(dim=-2)  # first j' with idx_j' == idx_j
    keep = first == pos

    k_sel = torch.stack([k[idx[h], h] for h in range(hk)])  # (hk, sq, topk, d)
    v_sel = torch.stack([v[idx[h], h] for h in range(hk)])
    qg = q.reshape(sq, hk, g, dh)
    logits = torch.einsum("shgd,hstd->hgst", qg, k_sel).float() * scale
    logits = logits.masked_fill(~keep[:, None], NEG_INF)
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom))[..., 0]  # (hk, g, sq)
    out = torch.einsum("hgst,hstd->shgd", (p / denom).to(q.dtype), v_sel).reshape(sq, hq, dv)
    return out, lse.permute(2, 0, 1).reshape(sq, hq)


def sdpa_sparse_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    index_map: torch.Tensor,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense masked oracle."""
    sq, hq, dh = q.shape
    skv, hk, dv = v.shape
    g = hq // hk
    scale = dh ** -0.5 if softmax_scale is None else softmax_scale
    idx = index_map.to(device=q.device, dtype=torch.int64)
    mask = torch.zeros((hk, sq, skv), dtype=torch.bool, device=q.device)
    mask.scatter_(2, idx, True)
    qg = q.reshape(sq, hk, g, dh)
    logits = torch.einsum("shgd,thd->hgst", qg, k.to(q.dtype)).float() * scale
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)  # (hk, g, sq)
    p = torch.exp(logits - lse[..., None]).masked_fill(~mask[:, None], 0.0)
    out = torch.einsum("hgst,thd->shgd", p.to(q.dtype), v).reshape(sq, hq, dv)
    return out, lse.permute(2, 0, 1).reshape(sq, hq)


def dsa_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    index_map: torch.Tensor,
    softmax_scale: float | None = None,
    backend: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparse attention: backend "gather" or "sdpa" (the oracle)."""
    if backend == "gather":
        return gather_sparse_fwd(q, k, v, index_map, softmax_scale)
    if backend == "sdpa":
        return sdpa_sparse_fwd(q, k, v, index_map, softmax_scale)
    raise ValueError(f"Invalid backend: {backend}")
