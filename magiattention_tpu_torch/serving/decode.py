"""Batched decode and speculative-verify attention for the serving engine.

The port's counterpart of ``magiattention_tpu/serving/decode.py``. The TPU
package descends a registry ladder (sharded / spec / int8 / base Pallas
kernels -> gather+FFA -> dense) with fault injection and fallback. The port
has no ladder: the cache's configuration alone picks one route, as JAX's
``_feasibility`` does for its first rung, and that route launches its CUDA
kernel for CUDA tensors or raises.

- :func:`decode_attn_step`: a float cache takes the paged-decode kernel
  (B10), an int8 cache the int8 kernel (B12).
- :func:`verify_attn_step`: a float cache takes the spec kernel (B11); an
  int8 cache never does (JAX's spec rung is infeasible there) and verifies
  through :func:`_gather_ffa_verify`, the dequantized gather + FFA (B1).

:func:`_gather_ffa_decode`, :func:`_dense_decode` and :func:`_dense_verify`
stay as plain functions for the tests and the oracle.
"""

from __future__ import annotations

import torch

from ..kernels.paged_decode import (
    paged_decode_attn,
    paged_decode_attn_int8,
    paged_decode_attn_spec,
)
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
    if cache.quantized:
        return paged_decode_attn_int8(q_batch, cache, softmax_scale=softmax_scale)
    return paged_decode_attn(q_batch, cache, softmax_scale=softmax_scale)


def verify_attn_step(
    q_spec: torch.Tensor,
    cache: PagedKVCache,
    host_lengths: tuple[int, ...],
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify: ``spec_k`` draft-token query rows per slot in
    one call, each row attending its own causal prefix.

    Args:
        q_spec: ``(max_seqs, spec_k, hq, d)`` — draft token ``t`` of a slot
            sits at absolute position ``lengths - spec_k + t`` (the draft
            rows are already appended, so lengths include them).
        host_lengths: per-slot counts AFTER the append (0 = inactive); the
            int8 route needs them on the host.

    Returns (out ``(max_seqs, spec_k, hq, dv)``,
    lse ``(max_seqs, spec_k, hq)``).
    """
    if cache.quantized:
        return _gather_ffa_verify(q_spec, cache, host_lengths, softmax_scale)
    return paged_decode_attn_spec(q_spec, cache, softmax_scale=softmax_scale)


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


def _gather_ffa_verify(q_spec, cache, host_lengths, softmax_scale=None):
    """Per-slot gather+FFA over the ``spec_k`` draft rows at once: row 0
    sits at ``length - spec_k``, the causal band puts row ``t`` at
    ``length - spec_k + t``, the spec kernel's geometry (rows before the
    slot's first token have nothing live: (0, -inf))."""
    S, spec_k, hq, d = q_spec.shape
    dv = cache.v_pages.shape[-1]
    max_pages = cache.page_table.shape[1]
    outs, lses = [], []
    for s, length in enumerate(host_lengths):
        if length <= 0:
            outs.append(q_spec.new_zeros((spec_k, hq, dv)))
            lses.append(
                torch.full((spec_k, hq), float("-inf"), device=q_spec.device)
            )
            continue
        out, lse = paged_attn(
            q_spec[s], cache, s,
            q_start=int(length) - spec_k,
            max_pages=max_pages,
            softmax_scale=softmax_scale,
        )
        outs.append(out)
        lses.append(lse)
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


def _dense_verify(q_spec, cache, host_lengths, softmax_scale=None):
    """Dense softmax over the draft rows, one per-row causal horizon: row
    ``t`` of every slot is a plain decode step over the prefix that ends at
    its own position."""
    S, spec_k, hq, d = q_spec.shape
    outs, lses = [], []
    for t in range(spec_k):
        t_lengths = tuple(
            max(0, length - (spec_k - 1 - t)) if length > 0 else 0
            for length in host_lengths
        )
        out, lse = _dense_decode(q_spec[:, t], cache, t_lengths, softmax_scale)
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs, dim=1), torch.stack(lses, dim=1)
