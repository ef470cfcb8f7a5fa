"""Dense masked softmax over band slices: the plain version of the FFA forward.

The port's copy of ``magiattention_tpu/kernels/sdpa.py`` (``sdpa_attn``,
``dense_max_logits``). It materializes
the ``(sq, sk)`` mask and the ``(hq, sq, sk)`` logits in float32, so it is a
reference for tests and for ``chip_smoke.py``, and the CPU path of
:func:`~.ffa.ffa_attn`; it is no yardstick of speed. ``sdpa_attn.calls``
counts its calls so a run can show that the card's path never took it.
"""

from __future__ import annotations

import numpy as np
import torch

from .mask_utils import build_dense_mask_band, types_to_bands


def sdpa_attn(
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
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compute flex attention densely.

    Args:
        q: ``[sq, hq, d]`` queries (varlen packed layout, no batch dim).
        k: ``[sk, hk, d]`` keys; ``hq % hk == 0`` (GQA).
        v: ``[sk, hk, dv]`` values.
        q_ranges/k_ranges/attn_type_map: slice metadata (N,2)/(N,2)/(N,),
            or explicit bands ``d_lo``/``d_hi``.

    Returns:
        out ``[sq, hq, dv]`` in q.dtype, lse ``[sq, hq]`` float32 (natural
        log; ``-inf`` on fully-masked rows, whose out is 0).
    """
    sdpa_attn.calls += 1
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
    kc = k.to(compute_dtype).repeat_interleave(g, dim=1)  # [sk, hq, d]
    vc = v.to(compute_dtype).repeat_interleave(g, dim=1)  # [sk, hq, dv]

    logits = torch.einsum("qhd,khd->hqk", qc, kc) * softmax_scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask, float("-inf"))

    lse = torch.logsumexp(logits, dim=-1)  # [hq, sq]; -inf on empty rows
    p = torch.exp(logits - torch.where(lse.isfinite(), lse, 0.0)[..., None])
    p = p.masked_fill(~mask, 0.0)
    out = torch.einsum("hqk,khd->qhd", p, vc)
    return out.to(q.dtype), lse.T.contiguous().float()


sdpa_attn.calls = 0


def dense_max_logits(
    q: torch.Tensor,
    k: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map=None,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    d_lo=None,
    d_hi=None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-head max of the (scaled, softcapped) masked logits: ``[hq]``
    float32, -inf for heads with no attended entry. The plain version of
    the FFA forward kernel's max-logits output (the port's copy of the JAX
    package's ``dense_max_logits``)."""
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    if d_lo is None or d_hi is None:
        if attn_type_map is None:
            attn_type_map = np.zeros(len(np.asarray(q_ranges)), np.int32)
        d_lo, d_hi = types_to_bands(q_ranges, k_ranges, attn_type_map)
    mask = build_dense_mask_band(
        q_ranges, k_ranges, d_lo, d_hi, sq, sk, device=q.device
    )
    kc = k.to(compute_dtype).repeat_interleave(hq // hk, dim=1)
    logits = torch.einsum("qhd,khd->hqk", q.to(compute_dtype), kc) * softmax_scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask, float("-inf"))
    return logits.amax(dim=(1, 2)).float()
