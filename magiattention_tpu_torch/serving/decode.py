"""Batched decode attention for the serving engine.

The port's counterpart of ``magiattention_tpu/serving/decode.py``. The TPU
package descends a registry ladder (sharded / spec / int8 / base Pallas
kernels -> gather+FFA -> dense) with fault injection and fallback. The port
has no ladder: :func:`decode_attn_step` calls
:func:`~..kernels.paged_decode.paged_decode_attn`, which launches the CUDA
kernel for CUDA tensors and raises if it cannot.

:func:`_gather_ffa_decode` and :func:`_dense_decode` stay as plain
functions for the tests and the oracle; the engine never calls them.
"""

from __future__ import annotations

import torch

from ..kernels.paged_decode import paged_decode_attn
from ..kernels.paged_kv import PagedKVCache, gather_kv, paged_attn


def decode_attn_step(
    q_batch: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every slot.

    Args:
        q_batch: ``(max_seqs, hq, d)`` — one query row per slot (zeros on
            inactive slots, whose length is 0).
        cache: the paged cache AFTER this step's k/v rows were appended.

    Returns (out ``(max_seqs, hq, dv)``, lse ``(max_seqs, hq)``).
    """
    return paged_decode_attn(q_batch, cache, softmax_scale=softmax_scale)


def _gather_ffa_decode(q_batch, cache, host_lengths, softmax_scale=None):
    """Per-slot gather+FFA decode. The new token sits at position
    ``length - 1`` (appended before attending), so the causal band covers
    exactly the stored rows."""
    S, hq, d = q_batch.shape
    dv = cache.v_pages.shape[-1]
    max_pages = cache.page_table.shape[1]
    outs, lses = [], []
    for s, length in enumerate(host_lengths):
        if length <= 0:
            outs.append(q_batch.new_zeros((hq, dv)))
            lses.append(
                torch.full((hq,), float("-inf"), device=q_batch.device)
            )
            continue
        out, lse = paged_attn(
            q_batch[s : s + 1], cache, s,
            q_start=int(length) - 1,
            max_pages=max_pages,
            softmax_scale=softmax_scale,
        )
        outs.append(out[0])
        lses.append(lse[0])
    return torch.stack(outs), torch.stack(lses)


def _dense_decode(q_batch, cache, host_lengths, softmax_scale=None):
    """Masked dense softmax over each slot's gathered pages, slot by slot."""
    S, hq, d = q_batch.shape
    dv = cache.v_pages.shape[-1]
    hk = cache.k_pages.shape[2]
    g = hq // hk
    if softmax_scale is None:
        softmax_scale = float(d) ** -0.5
    outs, lses = [], []
    for s, length in enumerate(host_lengths):
        if length <= 0:
            outs.append(q_batch.new_zeros((hq, dv)))
            lses.append(
                torch.full((hq,), float("-inf"), device=q_batch.device)
            )
            continue
        k, v = gather_kv(cache, s)  # (cap, hk, d)
        k = k[:length].float().repeat_interleave(g, dim=1)  # (length, hq, d)
        v = v[:length].float().repeat_interleave(g, dim=1)
        q = q_batch[s].float()  # (hq, d)
        scores = torch.einsum("hd,lhd->hl", q, k) * softmax_scale
        m = scores.amax(dim=1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=1, keepdim=True)
        out = torch.einsum("hl,lhd->hd", p / l, v)
        outs.append(out.to(q_batch.dtype))
        lses.append((m[:, 0] + torch.log(l[:, 0])).float())
    return torch.stack(outs), torch.stack(lses)
