"""Kernel and plan pre-warming (the port's counterpart of
``magiattention_tpu/testing/precompile.py``).

The JAX package warms its FFA plan cache and jax's jit cache. Here the
first call's cost is building the kernel libraries (``nvcc``, one process
per source, ``kernels/_build.py``), the native host library (``g++``,
``csrc_backend/build.py``) and the FFA plans: :func:`precompile_kernels`
builds every library ahead of the first call, :func:`precompile_ffa`
warms the plans (and, on the card, runs each configuration's forward once)
so timed or distributed bodies start warm. On the CPU only the plans and
the host library are warmed.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def precompile_kernels(names: tuple[str, ...] | None = None) -> float:
    """Build every CUDA kernel library (``names``, default all of
    ``kernels/_build.py:SOURCES``; all ``nvcc`` processes started together)
    and the native host library; returns the seconds it took. Raises
    ``KernelBuildError`` where ``nvcc`` is missing or a source does not
    compile."""
    from ..csrc_backend import build as host_build
    from ..kernels import _build

    t0 = time.perf_counter()
    _build.build_all(_build.SOURCES if names is None else names)
    host_build.available()
    return time.perf_counter() - t0


def precompile_ffa(configs: list[dict], dtype: torch.dtype = torch.float32,
                   device: torch.device | str | None = None) -> int:
    """Warm the FFA plans of each configuration as :func:`~..kernels.ffa.ffa_attn`
    resolves them (mixed dispatch, tiles, the backward's per-pass tiles);
    on a CUDA ``device`` also run its forward once on zeros. ``device``
    defaults to the card (``device.resolve_device``); pass ``"cpu"`` to warm
    only the plans.

    Each config: ``{"q_ranges", "k_ranges", "attn_type_map", "seqlen_q",
    "seqlen_k", "num_heads_q", "num_heads_kv", "head_dim"}`` (ranges as
    (N, 2) arrays), the JAX package's keys. Returns the number warmed.
    """
    from ..device import resolve_device
    from ..kernels.ffa import ffa_attn, plan_params, resolve_dispatch
    from ..kernels.ffa_plan import get_ffa_plan
    from ..kernels.mask_utils import types_to_bands

    device = resolve_device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = 0
    for cfg in configs:
        sq, sk = cfg["seqlen_q"], cfg["seqlen_k"]
        d = cfg.get("head_dim", 64)
        qr = np.asarray(cfg["q_ranges"], np.int32).reshape(-1, 2)
        kr = np.asarray(cfg["k_ranges"], np.int32).reshape(-1, 2)
        tm = cfg.get("attn_type_map")
        tm = np.zeros(len(qr), np.int32) if tm is None else np.asarray(tm, np.int32)
        if device.type == "cuda":
            hq, hk = cfg.get("num_heads_q", 2), cfg.get("num_heads_kv", 1)
            q = torch.zeros((sq, hq, d), dtype=dtype, device=device)
            kv = torch.zeros((sk, hk, d), dtype=dtype, device=device)
            ffa_attn(q, kv, kv, qr, kr, tm)
        else:
            lo, hi = types_to_bands(qr, kr, tm)
            how = resolve_dispatch(qr, kr, lo, hi, sq, sk, d, d, itemsize)
            if how.mixed is not None:
                mix = how.mixed
                for idx, blocks in ((mix.dense_idx, mix.coarse_blocks), (mix.frag_idx, mix.fine_blocks)):
                    get_ffa_plan(qr[idx], kr[idx], lo[idx], hi[idx], sq, sk, *blocks)
            else:
                plan_params(qr, kr, None, lo, hi, sq, sk, d, None, 0.0, *how.blocks,
                            False, how.overrides)
        n += 1
    return n
