"""Batched decode and speculative-verify attention for the serving engine.

The port's counterpart of ``magiattention_tpu/serving/decode.py``: each
step descends the backend registry's ``serve_decode`` ladder
(``kernels/registry.py``: JAX's six rungs, sharded / spec / int8 / base
kernels -> gather+FFA -> dense), filtered to the rungs feasible for the
cache and the shard count (JAX's ``_feasibility``,
:func:`decode_rungs`), from the registry's start rung (the caller's pin,
:func:`..env.backend.serve_decode_pin`, or, unpinned, JAX's default). The
first rung (:func:`decode_route`) launches its CUDA kernel for CUDA
tensors or raises.

Each kernel rung arms the ``serve_decode`` injection site (not the FFA
``kernel_lowering`` site, which prefill's FFA calls also arm). A rung that
fails with a recoverable type (``resilience/fallback.kernel_failure_types``:
an injected fault, a CUDA error a launch returned, an out-of-memory)
descends to the next rung under MAGI_ATTENTION_FALLBACK=1, one
``resilience`` record per hop; without the flag the failure propagates.
On CUDA tensors the descent ends at ``gather_ffa`` (B1): the plain
``dense`` rung is taken only for CPU tensors, and a card step that would
need it raises ``FallbackExhaustedError``.

- :func:`decode_attn_step`: unpinned, ``shards > 1`` takes the
  head-sharded step (B10 once per shard,
  :func:`~..kernels.paged_decode.paged_decode_attn_sharded`) where it is
  feasible, else a float cache takes the paged-decode kernel (B10), an
  int8 cache the int8 kernel (B12).
- :func:`verify_attn_step`: unpinned, a float cache takes the spec kernel
  (B11); an int8 cache never does (JAX's spec rung is infeasible there) and
  verifies through :func:`_gather_ffa_verify`, the dequantized gather + FFA
  (B1).
- ``gather_ffa`` pinned: :func:`_gather_ffa_decode` /
  :func:`_gather_ffa_verify`, the replay oracle's own call (one query row
  per FFA call); ``dense`` pinned: :func:`_dense_decode` /
  :func:`_dense_verify`.
"""

from __future__ import annotations

import torch

from ..env import backend as env_backend
from ..kernels import registry as _registry
from ..kernels.paged_decode import (
    paged_decode_attn,
    paged_decode_attn_int8,
    paged_decode_attn_sharded,
    paged_decode_attn_spec,
)
from ..kernels.paged_kv import PagedKVCache, gather_kv, paged_attn
from ..env import resilience as env_resilience
from ..resilience import fallback as _fallback
from ..resilience.errors import FallbackExhaustedError
from ..resilience.inject import maybe_inject


# JAX's serve_decode ladder, in rank order
RUNGS = (
    "paged_decode_sharded", "paged_decode_spec", "paged_decode_int8", "paged_decode",
    "gather_ffa", "dense",
)
# the rungs that launch a decode kernel (they arm the serve_decode site)
KERNEL_RUNGS = RUNGS[:4]


def decode_rungs(cache: PagedKVCache, multi_row: bool, shards: int = 1) -> list[str]:
    """The rungs a decode (``multi_row`` False) or verify step may run, in
    descent order: from the start (the pin, else JAX's default: the
    sharded rung for ``shards > 1``, the int8 kernel on an int8 cache, the
    spec kernel for a verify, else the paged-decode kernel) down the
    ladder, keeping those feasible for the cache and ``shards`` (JAX's
    ``_feasibility`` rules)."""
    hk = cache.k_pages.shape[2]
    quantized = cache.quantized
    feasible = {
        "paged_decode_sharded": (  # enough devices of the cache's kind: the CPU is any number
            not multi_row and not quantized and shards > 1 and hk % shards == 0
            and (cache.device.type == "cpu" or torch.cuda.device_count() >= shards)
        ),
        "paged_decode_spec": multi_row and not quantized,
        "paged_decode_int8": not multi_row and quantized,
        "paged_decode": not multi_row and not quantized,
        "gather_ffa": True,
        "dense": True,
    }
    if multi_row:
        default = "paged_decode_spec"
    elif quantized:
        default = "paged_decode_int8"
    else:
        default = "paged_decode_sharded" if shards > 1 else "paged_decode"
    start = _registry.resolve(
        "serve_decode", (hk, quantized, multi_row, shards), lambda: default,
        pin=env_backend.serve_decode_pin(),
    ).name
    return [r for r in _registry.ladder("serve_decode", start) if feasible[r]]


def decode_route(cache: PagedKVCache, multi_row: bool, shards: int = 1) -> str:
    """The rung a decode or verify step runs first (:func:`decode_rungs`)."""
    return decode_rungs(cache, multi_row, shards)[0]


def _host_lengths(cache: PagedKVCache, host_lengths) -> tuple[int, ...]:
    return tuple(cache.lengths.tolist()) if host_lengths is None else tuple(host_lengths)


def _descend(rungs: list[str], run, card: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``run(rung)`` on the first rung that succeeds: a kernel rung arms
    the ``serve_decode`` site first; a recoverable failure descends to the
    next rung under MAGI_ATTENTION_FALLBACK=1, else propagates. On the card
    (``card``) the descent stops before the plain ``dense`` rung: a failure
    with only that left raises ``FallbackExhaustedError``."""
    failures = _fallback.kernel_failure_types()
    for i, rung in enumerate(rungs):
        try:
            if rung in KERNEL_RUNGS:
                maybe_inject("serve_decode")
            return run(rung)
        except failures as e:
            if i + 1 >= len(rungs) or not env_resilience.is_fallback_enable():
                raise
            if not _fallback.card_rungs("serve_decode", rungs[i + 1:i + 2], card):
                raise FallbackExhaustedError(
                    f"serve_decode ladder exhausted: {rung} failed, and {rungs[i + 1]} is plain "
                    "PyTorch, never run in a kernel's place on the card"
                ) from e
            _fallback.record_resilience_event(
                "fallback", "serve_decode",
                action_detail=f"{rung}_to_{rungs[i + 1]}",
                error=type(e).__name__,
            )
    raise AssertionError("serve_decode ladder is empty")  # the last rung returns or raises


def decode_attn_step(
    q_batch: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
    host_lengths: tuple[int, ...] | None = None,
    shards: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step for every slot, down :func:`decode_rungs`.

    Args:
        q_batch: ``(max_seqs, hq, d)`` — one query row per slot (zeros on
            inactive slots, whose length is 0).
        cache: the paged cache AFTER this step's k/v rows were appended.
        host_lengths: per-slot counts as host ints (0 = inactive), which
            the gather and dense rungs need; None reads ``cache.lengths``
            (a device-to-host copy) when they do.
        shards: kv-head shards the engine asks for; 1 rules out the
            sharded rung.

    Returns (out ``(max_seqs, hq, dv)``, lse ``(max_seqs, hq)``).
    """

    def run(rung: str):
        if rung == "paged_decode_sharded":
            return paged_decode_attn_sharded(q_batch, cache, shards, softmax_scale=softmax_scale)
        if rung == "paged_decode_int8":
            return paged_decode_attn_int8(q_batch, cache, softmax_scale=softmax_scale)
        if rung == "paged_decode":
            return paged_decode_attn(q_batch, cache, softmax_scale=softmax_scale)
        lengths = _host_lengths(cache, host_lengths)
        if rung == "gather_ffa":
            return _gather_ffa_decode(q_batch, cache, lengths, softmax_scale)
        return _dense_decode(q_batch, cache, lengths, softmax_scale)

    return _descend(decode_rungs(cache, multi_row=False, shards=shards), run,
                    _fallback.on_card(q_batch))


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
    lse ``(max_seqs, spec_k, hq)``), down :func:`decode_rungs`.
    """

    def run(rung: str):
        if rung == "paged_decode_spec":
            return paged_decode_attn_spec(q_spec, cache, softmax_scale=softmax_scale)
        if rung == "gather_ffa":
            return _gather_ffa_verify(q_spec, cache, host_lengths, softmax_scale)
        return _dense_verify(q_spec, cache, host_lengths, softmax_scale)

    return _descend(decode_rungs(cache, multi_row=True), run, _fallback.on_card(q_spec))


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
