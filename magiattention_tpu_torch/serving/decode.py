"""Batched decode and speculative-verify attention for the serving engine.

The port's counterpart of ``magiattention_tpu/serving/decode.py``. The TPU
package descends a registry ladder (sharded / spec / int8 / base Pallas
kernels -> gather+FFA -> dense) with fault injection and fallback. The port
has no fallback: one route per call, the first rung of the backend
registry's ``serve_decode`` ladder (``kernels/registry.py``: JAX's rungs
below the sharded one) that is feasible for the cache (JAX's
``_feasibility``), starting at the registry's start rung (the caller's pin,
:func:`..env.backend.serve_decode_pin`, or, unpinned, the top). That route launches its CUDA kernel for CUDA tensors
or raises.

- :func:`decode_attn_step`: unpinned, a float cache takes the paged-decode
  kernel (B10), an int8 cache the int8 kernel (B12).
- :func:`verify_attn_step`: unpinned, a float cache takes the spec kernel
  (B11); an int8 cache never does (JAX's spec rung is infeasible there) and
  verifies through :func:`_gather_ffa_verify`, the dequantized gather + FFA
  (B1).
- ``gather_ffa`` pinned: :func:`_gather_ffa_decode` /
  :func:`_gather_ffa_verify`, the replay oracle's own call (one query row
  per FFA call); ``dense`` pinned: :func:`_dense_decode` /
  :func:`_dense_verify`. ``paged_decode_sharded`` raises (ROADMAP queue A
  item 8), as ``decode_shards > 1`` does.
"""

from __future__ import annotations

import torch

from ..env import backend as env_backend
from ..kernels import registry as _registry
from ..kernels.paged_decode import (
    paged_decode_attn,
    paged_decode_attn_int8,
    paged_decode_attn_spec,
)
from ..kernels.paged_kv import PagedKVCache, gather_kv, paged_attn


# JAX's serve_decode ladder below the sharded rung, in rank order
RUNGS = ("paged_decode_spec", "paged_decode_int8", "paged_decode", "gather_ffa", "dense")


def decode_route(cache: PagedKVCache, multi_row: bool) -> str:
    """The rung a decode (``multi_row`` False) or verify step runs: the
    first rung at or below the pin (unpinned: the top) that is feasible
    for the cache, JAX's ``_feasibility`` rules. A ``paged_decode_sharded``
    pin raises: the head-sharded rung is not ported."""
    pin = env_backend.serve_decode_pin()
    if pin == "paged_decode_sharded":
        raise NotImplementedError(
            "MAGI_ATTENTION_BACKEND_SERVE_DECODE=paged_decode_sharded needs "
            "the head-sharded decode rung (ROADMAP queue A item 8), not ported yet"
        )
    quantized = cache.quantized
    feasible = {
        "paged_decode_spec": multi_row and not quantized,
        "paged_decode_int8": not multi_row and quantized,
        "paged_decode": not multi_row and not quantized,
        "gather_ffa": True,
        "dense": True,
    }
    start = _registry.resolve("serve_decode", (), lambda: RUNGS[0], pin=pin).name
    return next(r for r in _registry.ladder("serve_decode", start) if feasible[r])


def _host_lengths(cache: PagedKVCache, host_lengths) -> tuple[int, ...]:
    return tuple(cache.lengths.tolist()) if host_lengths is None else tuple(host_lengths)


def decode_attn_step(
    q_batch: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
    host_lengths: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every slot, on :func:`decode_route`'s rung.

    Args:
        q_batch: ``(max_seqs, hq, d)`` — one query row per slot (zeros on
            inactive slots, whose length is 0).
        cache: the paged cache AFTER this step's k/v rows were appended.
        host_lengths: per-slot counts as host ints (0 = inactive), which
            the gather and dense rungs need; None reads ``cache.lengths``
            (a device-to-host copy) when they do.

    Returns (out ``(max_seqs, hq, dv)``, lse ``(max_seqs, hq)``).
    """
    route = decode_route(cache, multi_row=False)
    if route == "paged_decode_int8":
        return paged_decode_attn_int8(q_batch, cache, softmax_scale=softmax_scale)
    if route == "paged_decode":
        return paged_decode_attn(q_batch, cache, softmax_scale=softmax_scale)
    lengths = _host_lengths(cache, host_lengths)
    if route == "gather_ffa":
        return _gather_ffa_decode(q_batch, cache, lengths, softmax_scale)
    return _dense_decode(q_batch, cache, lengths, softmax_scale)


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
            gather and dense rungs need them on the host.

    Returns (out ``(max_seqs, spec_k, hq, dv)``,
    lse ``(max_seqs, spec_k, hq)``), on :func:`decode_route`'s rung.
    """
    route = decode_route(cache, multi_row=True)
    if route == "paged_decode_spec":
        return paged_decode_attn_spec(q_spec, cache, softmax_scale=softmax_scale)
    if route == "gather_ffa":
        return _gather_ffa_verify(q_spec, cache, host_lengths, softmax_scale)
    return _dense_verify(q_spec, cache, host_lengths, softmax_scale)


def _gather_ffa_decode(q_batch, cache, host_lengths, softmax_scale=None):
    """Per-slot gather+FFA decode. The new token sits at position
    ``length - 1`` (appended before attending), so the causal band covers
    exactly the stored rows."""
    S, hq, d = q_batch.shape
    dv = cache.head_dim_v
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
    """Per-slot gather+FFA over the ``spec_k`` draft rows: row ``t`` sits at
    ``length - spec_k + t`` and attends its own causal prefix, the spec
    kernel's geometry (a row before the slot's first token has nothing
    live: (0, -inf)). Each row is its own FFA call, the replay oracle's
    decode call: the plain FFA on the CPU computes a row of a multi-row
    call in another order than the same row alone (last-bit differences),
    and the pinned engine is held to the replay bit for bit."""
    S, spec_k, hq, d = q_spec.shape
    dv = cache.head_dim_v
    max_pages = cache.page_table.shape[1]
    outs, lses = [], []
    for s, length in enumerate(host_lengths):
        for t in range(spec_k):
            pos = int(length) - spec_k + t
            if length <= 0 or pos < 0:
                outs.append(q_spec.new_zeros((hq, dv)))
                lses.append(
                    torch.full((hq,), float("-inf"), device=q_spec.device)
                )
                continue
            out, lse = paged_attn(
                q_spec[s, t : t + 1], cache, s,
                q_start=pos,
                max_pages=max_pages,
                softmax_scale=softmax_scale,
            )
            outs.append(out[0])
            lses.append(lse[0])
    return (
        torch.stack(outs).reshape(S, spec_k, hq, dv),
        torch.stack(lses).reshape(S, spec_k, hq),
    )


def _dense_decode(q_batch, cache, host_lengths, softmax_scale=None):
    """Masked dense softmax over each slot's gathered pages, slot by slot."""
    S, hq, d = q_batch.shape
    dv = cache.head_dim_v
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
