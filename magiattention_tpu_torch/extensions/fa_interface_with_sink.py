"""Flash-attention drop-in interfaces with an attention sink.

The port's counterpart of ``magiattention_tpu/extensions/fa_interface_with_sink.py``:
batch / varlen / qkvpacked entries with causal, sliding-window, softcap,
GQA and a sink, over :func:`~..functional.flex_flash_attn.flex_flash_attn_func`
(on the card: the FFA forward, and its backward, which a sink sends
through the fused kernel). The ``fa2_*`` / ``fa3_*`` / ``fa4_*``
generations share one implementation; the aliases exist for call sites
written against one of them.

Windows follow FA semantics: query i attends keys j with
``i + sk - sq - wl <= j <= i + sk - sq + wr`` (causal caps the right edge
at the main diagonal), one diagonal band slice per sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.enum import AttnSinkLayout
from ..functional.flex_flash_attn import flex_flash_attn_func
from ..functional.sink import check_sink_layout
from ..kernels.mask_utils import BAND_INF


def _band(sq: int, sk: int, causal: bool, window: tuple[int, int]) -> tuple[int, int]:
    """FA window/causal semantics -> one (d_lo, d_hi) band (j - i bounds)."""
    off = sk - sq
    wl, wr = window
    d_lo = off - wl if wl >= 0 else -BAND_INF
    if causal:
        d_hi = off if wr < 0 else min(off, off + wr)
    else:
        d_hi = off + wr if wr >= 0 else BAND_INF
    return d_lo, d_hi


def _run_packed(q, k, v, qr, kr, d_lo, d_hi, sink, softmax_scale, softcap, backend,
                sink_layout: AttnSinkLayout = "sh", deterministic: bool = False):
    out, meta = flex_flash_attn_func(
        q, k, v, qr, kr, None,
        softmax_scale=softmax_scale, softcap=softcap, sink=sink,
        sink_layout=sink_layout, deterministic=deterministic, backend=backend,
        d_lo=np.asarray(d_lo, np.int32), d_hi=np.asarray(d_hi, np.int32),
    )
    return out, meta.lse


def fa3_func_with_sink(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sink: torch.Tensor | None = None,
    sink_layout: AttnSinkLayout = "sh",
    softmax_scale: float | None = None,
    causal: bool = False,
    window_size: tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    backend: str | None = None,
):
    """FA-style batch attention with an optional sink.

    Args:
        q/k/v: ``(b, s, h, d)`` / ``(b, sk, hk, d)``.
        sink: ``(s_sink, h)`` shared sink logits (layout "sh"), or
            ``(b, s, s_sink, h)`` per-row logits (layout "ssh", packed to
            ``(b*s, s_sink, h)``).

    Returns:
        out ``(b, s, h, dv)``; with ``return_attn_probs``, also lse
        ``(b, h, s)`` float32.
    """
    if sink is not None:
        check_sink_layout(sink_layout)
    b, sq, hq, dh = q.shape
    _, sk, hk, dv = v.shape
    if sink is not None and sink_layout == "ssh":
        sink = sink.reshape(b * sq, *sink.shape[2:])
    d_lo, d_hi = _band(sq, sk, causal, window_size)
    qr = np.array([[i * sq, (i + 1) * sq] for i in range(b)], np.int32)
    kr = np.array([[i * sk, (i + 1) * sk] for i in range(b)], np.int32)
    # local band -> packed global coords: shift by kr.start - qr.start
    shift = np.arange(b) * (sk - sq)
    d_lo_a = np.where(d_lo > -BAND_INF, d_lo + shift, -BAND_INF).astype(np.int32)
    d_hi_a = np.where(d_hi < BAND_INF, d_hi + shift, BAND_INF).astype(np.int32)
    out, lse = _run_packed(
        q.reshape(b * sq, hq, dh), k.reshape(b * sk, hk, dh), v.reshape(b * sk, hk, dv),
        qr, kr, d_lo_a, d_hi_a, sink, softmax_scale, softcap, backend, sink_layout,
        deterministic,
    )
    out = out.reshape(b, sq, hq, dv)
    if return_attn_probs:
        return out, lse.reshape(b, sq, hq).transpose(1, 2)
    return out


def fa3_varlen_func_with_sink(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens_q,
    cu_seqlens_k,
    max_seqlen_q: int | None = None,
    max_seqlen_k: int | None = None,
    sink: torch.Tensor | None = None,
    sink_layout: AttnSinkLayout = "sh",
    softmax_scale: float | None = None,
    causal: bool = False,
    window_size: tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    backend: str | None = None,
):
    """FA varlen-style packed attention with an optional sink: q/k/v are
    ``(total, h, d)`` packed, cu_seqlens host metadata. With
    ``return_attn_probs``, also lse ``(total, h)`` float32."""
    if sink is not None:
        check_sink_layout(sink_layout)
    cu_q = [int(x) for x in np.asarray(cu_seqlens_q)]
    cu_k = [int(x) for x in np.asarray(cu_seqlens_k)]
    n = len(cu_q) - 1
    qr = np.array([[cu_q[i], cu_q[i + 1]] for i in range(n)], np.int32)
    kr = np.array([[cu_k[i], cu_k[i + 1]] for i in range(n)], np.int32)
    d_lo = np.empty(n, np.int32)
    d_hi = np.empty(n, np.int32)
    for i in range(n):
        lo, hi = _band(cu_q[i + 1] - cu_q[i], cu_k[i + 1] - cu_k[i], causal, window_size)
        # local band -> global: j_g - i_g = (j_l - i_l) + kr.start - qr.start
        shift = kr[i, 0] - qr[i, 0]
        d_lo[i] = max(-BAND_INF, lo + shift) if lo > -BAND_INF else -BAND_INF
        d_hi[i] = min(BAND_INF, hi + shift) if hi < BAND_INF else BAND_INF
    out, lse = _run_packed(
        q, k, v, qr, kr, d_lo, d_hi, sink, softmax_scale, softcap, backend, sink_layout,
        deterministic,
    )
    if return_attn_probs:
        return out, lse
    return out


def fa3_qkvpacked_func_with_sink(
    qkv: torch.Tensor,
    sink: torch.Tensor | None = None,
    sink_layout: AttnSinkLayout = "sh",
    softmax_scale: float | None = None,
    causal: bool = False,
    window_size: tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    backend: str | None = None,
):
    """FA qkvpacked-style: qkv ``(b, s, 3, h, d)``."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return fa3_func_with_sink(
        q, k, v, sink, sink_layout, softmax_scale, causal, window_size,
        softcap, deterministic, return_attn_probs, backend,
    )


# the fa2 / fa4 generations share the implementation
fa2_func_with_sink = fa3_func_with_sink
fa2_varlen_func_with_sink = fa3_varlen_func_with_sink
fa2_qkvpacked_func_with_sink = fa3_qkvpacked_func_with_sink
fa4_func_with_sink = fa3_func_with_sink
fa4_varlen_func_with_sink = fa3_varlen_func_with_sink
fa4_qkvpacked_func_with_sink = fa3_qkvpacked_func_with_sink
