"""Single-device flex-flash-attention entry point.

The port's counterpart of ``magiattention_tpu/functional/flex_flash_attn.py``:
varlen-packed q/k/v + slice metadata -> (out, AttnForwardMeta). Backends:

- ``ffa``: the FFA kernels through the ``torch.autograd.Function``
  ``_FFACore`` (``kernels/ffa.py``), or, with a sink, :class:`_FFASinkCore`
  over the same kernels; CPU tensors take the kernels' plain versions;
- ``sdpa`` / ``sdpa_online``: the plain dense / blockwise-online backends,
  differentiated by autograd (a sink is folded in afterwards).

``return_max_logits=True`` fills ``AttnForwardMeta.max_logits`` with the
per-head max of the scaled, softcapped logits over the attended entries
(the sink's logits not included): the forward kernel's own output on
``ffa``, ``dense_max_logits`` on the plain backends.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..common.forward_meta import AttnForwardMeta
from ..env import general as env_general
from ..kernels.ffa import (
    FFAParams,
    ffa_attn,
    ffa_bwd,
    ffa_delta,
    ffa_fwd_dispatch,
    plan_params,
)
from ..kernels.ffa_plan import FFAPlan
from ..kernels.sdpa import dense_max_logits, sdpa_attn
from ..kernels.sdpa_online import sdpa_online_attn
from .sink import apply_sink_fwd, check_sink_layout, sink_bwd


def _as_range_array(ranges: Any, name: str) -> np.ndarray:
    """Accept an object with ``to_array()`` or an array-like -> (N, 2)
    int32 host array (slice metadata builds the host plan)."""
    arr = ranges.to_array() if hasattr(ranges, "to_array") else ranges
    arr = np.asarray(arr, dtype=np.int32)
    if arr.ndim != 2 or arr.shape[-1] != 2:
        raise ValueError(f"{name} must have shape (N, 2), got {arr.shape}")
    return arr


def flex_flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges: Any,
    k_ranges: Any,
    attn_type_map: Any = None,
    *,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    sink: torch.Tensor | None = None,
    sink_layout: str = "sh",
    deterministic: bool = False,
    backend: str | None = None,
    return_max_logits: bool = False,
    d_lo: Any = None,
    d_hi: Any = None,
) -> tuple[torch.Tensor, AttnForwardMeta]:
    """Compute flex attention on one device, differentiable in q, k, v
    (and the sink).

    Args:
        q: ``[sq, hq, d]`` (varlen packed, no batch dim).
        k/v: ``[sk, hk, d] / [sk, hk, dv]``; ``hq % hk == 0`` (GQA).
        q_ranges/k_ranges: ``(N, 2)`` int32 slice ranges. Padding slices
            have ``q_start >= q_end`` and are skipped.
        attn_type_map: ``(N,)`` int32 (0=FULL 1=CAUSAL 2=INVCAUSAL
            3=BICAUSAL); None = all FULL.
        sink: optional sink logits (layout ``sink_layout``: sh | ssh).
        deterministic: make the backward bitwise reproducible on the
            ``ffa`` backend: the kernels' backward resolves the split mode
            (no atomics) ahead of every pin and the cost model, as
            MAGI_ATTENTION_DETERMINISTIC_MODE=1 does for every caller. The
            plain backends are deterministic as they are.
        backend: ffa | sdpa | sdpa_online; None = env
            ``MAGI_ATTENTION_KERNEL_BACKEND`` (default ffa).
        return_max_logits: also fill ``max_logits`` (``[hq]`` float32,
            -inf for a head with no attended entry).

    Returns:
        (out ``[sq, hq, dv]``, AttnForwardMeta(lse=``[sq, hq]`` float32,
        max_logits)).
    """
    qr = _as_range_array(q_ranges, "q_ranges")
    kr = _as_range_array(k_ranges, "k_ranges")
    if attn_type_map is None:
        tmap = np.zeros((qr.shape[0],), dtype=np.int32)
    else:
        tmap = np.asarray(attn_type_map, dtype=np.int32).reshape(-1)
    if sink is not None:
        check_sink_layout(sink_layout)

    if backend is None:
        backend = env_general.kernel_backend()
    if env_general.precision() == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))

    kw = dict(softmax_scale=softmax_scale, softcap=softcap, d_lo=d_lo, d_hi=d_hi)
    max_logits = None
    if backend == "sdpa":
        out, lse = sdpa_attn(q, k, v, qr, kr, tmap, compute_dtype=torch.float32, **kw)
    elif backend == "sdpa_online":
        out, lse = sdpa_online_attn(
            q, k, v, qr, kr, tmap, compute_dtype=torch.float32, **kw
        )
    elif backend == "ffa":
        if sink is not None:
            plan, params = plan_params(
                qr, kr, tmap, d_lo, d_hi, q.shape[0], k.shape[0], q.shape[-1],
                softmax_scale, softcap, deterministic=deterministic,
            )
            out, lse, *ml = _FFASinkCore.apply(
                q, k, v, sink, plan, params, sink_layout, return_max_logits
            )
            return out, AttnForwardMeta(lse=lse, max_logits=ml[0] if ml else None)
        out, lse, *ml = ffa_attn(
            q, k, v, qr, kr, tmap, return_max_logits=return_max_logits,
            deterministic=deterministic, **kw,
        )
        max_logits = ml[0] if ml else None
    else:
        raise ValueError(f"unknown kernel backend: {backend}")

    if sink is not None:
        # the plain backends are differentiated end to end by autograd, so
        # folding the sink in afterwards is gradient-exact
        out, lse = apply_sink_fwd(out, lse, sink, sink_layout)
    if return_max_logits and max_logits is None:
        max_logits = dense_max_logits(q, k, qr, kr, tmap, **kw).detach()
    return out, AttnForwardMeta(lse=lse, max_logits=max_logits)


class _FFASinkCore(torch.autograd.Function):
    """FFA with a sink: the forward kernel, then the sink folded into
    (out, lse); the backward runs the backward kernels (fused or split, by
    ``ffa_bwd_mode``) against the sink-adjusted lse (which renormalizes dq/dk/dv exactly) and
    :func:`~.sink.sink_bwd` for dsink. The cotangents of lse and of the
    optional max_logits (the kernel's, over the real logits) are ignored."""

    @staticmethod
    def forward(
        ctx, q, k, v, sink, plan: FFAPlan, params: FFAParams, sink_layout: str,
        return_max_logits: bool = False,
    ):
        out0, lse0, *ml = ffa_fwd_dispatch(q, k, v, plan, params, return_max_logits)
        out, lse = apply_sink_fwd(out0, lse0, sink, sink_layout)
        ctx.save_for_backward(q, k, v, sink, out, lse)
        ctx.plan, ctx.params, ctx.sink_layout = plan, params, sink_layout
        ctx.mark_non_differentiable(lse, *ml)
        return (out, lse, *ml)

    @staticmethod
    def backward(ctx, dout, *_aux):
        q, k, v, sink, out, lse = ctx.saved_tensors
        plan, params = ctx.plan, ctx.params
        delta = ffa_delta(out, dout)
        dq, dk, dv = ffa_bwd(q, k, v, dout, lse, delta, plan, params)
        dsink = sink_bwd(sink, lse, delta, ctx.sink_layout)
        return (
            dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dsink,
            None, None, None, None,
        )
