"""The head dims the port's CUDA kernels are compiled for, and the zero
padding that takes every other ``d, dv <= 256`` through them.

Every kernel body is instantiated at head dims 64, 128 and 256 with equal
q/k and v widths. A call with other dims pads q and k (width ``d``) and v, dO
and out (width ``dv``) with zero columns to the smallest compiled width
that holds both, runs the kernel and slices the logical columns back. The
padding is exact: zero columns add exact zeros to S, dP and delta and give
zero columns in every output. The softmax scale stays the caller's (the
true ``d``'s), fixed before any tensor is padded.

At 256 the column split is per family (:func:`column_halves`). The bf16
forward (B1/B2), dq pass (B3/B4) and k-major backward (B5/B6, B8/B9)
write all 256 columns from one CTA and compute S and dP once
(:data:`FULL_WIDTH_KERNELS`; the backward passes with two consumer
warpgroups, one a 128-column half). The float32 bodies and NSA's split
the columns they write in two 128-column halves across the grid, each
half recomputing S and dP over the full width. Above 256
the card has no kernel (ROADMAP C4c): at 512 the Q, K and V tiles take
64 KB each in bf16, and no public model configuration of the repo's
families is that wide.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_HEAD_DIMS = (64, 128, 256)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]
# the widest output a CTA of a splitting kernel writes: above it the
# kernel splits its output columns into halves of this width across the grid
SPLIT_WIDTH = 128
# the FFA kernels (utils/mem_budget.py names) whose bf16 (tensor-core) body
# writes every column from one CTA at each width: csrc/ffa_fwd_tc.cuh,
# csrc/ffa_fwd_ws.cuh, csrc/ffa_bwd_dq_tc.cuh, csrc/ffa_bwd_dq_ws.cuh,
# csrc/bwd_kv_tc.cuh and csrc/bwd_kv_ws.cuh
FULL_WIDTH_KERNELS = frozenset({"fwd", "fwd_gqa", "dq", "dq_gqa", "dkv", "fused"})


def cta_width(d: int, kernel: str | None = None, itemsize: int = 4) -> int:
    """The output columns one CTA writes at compiled width ``d``: all of
    them in the bf16 (``itemsize`` 2) body of a :data:`FULL_WIDTH_KERNELS`
    kernel, else at most :data:`SPLIT_WIDTH` (every float32 body, NSA's
    kernels; ``kernel`` None)."""
    if itemsize == 2 and kernel in FULL_WIDTH_KERNELS:
        return d
    return min(d, SPLIT_WIDTH)


def column_halves(d: int, kernel: str | None = None, itemsize: int = 4) -> int:
    """The column halves a kernel's grid runs at compiled width ``d``: 2
    at 256 where the kernel splits its columns (:func:`cta_width`), else
    1."""
    return d // cta_width(d, kernel, itemsize)


def kernel_head_dim(d: int, dv: int | None = None) -> int:
    """The compiled width a call of head dims ``d`` (q, k) and ``dv`` (v;
    default ``d``) runs at: the smallest of :data:`KERNEL_HEAD_DIMS` that
    is at least both. Raises ``ValueError`` above :data:`MAX_HEAD_DIM`."""
    dv = d if dv is None else dv
    widest = max(d, dv)
    if min(d, dv) < 1:
        raise ValueError(f"head dims d={d}, dv={dv} must be positive")
    if widest > MAX_HEAD_DIM:
        raise ValueError(
            f"head dims d={d}, dv={dv}: the CUDA kernels take at most "
            f"{MAX_HEAD_DIM} (at 512 the Q, K and V tiles take 64 KB each in "
            "bf16; ROADMAP C4c)"
        )
    return next(w for w in KERNEL_HEAD_DIMS if w >= widest)


def is_kernel_width(d: int, dv: int) -> bool:
    """True when the kernels run these dims as they are (no padding)."""
    return d == dv and d in KERNEL_HEAD_DIMS


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended to ``width`` on its last dim (``t``
    itself, no copy, when it is that wide already)."""
    extra = width - t.shape[-1]
    if extra < 0:
        raise ValueError(f"cannot pad a width of {t.shape[-1]} to {width}")
    return t if extra == 0 else F.pad(t, (0, extra))


def pad_to_kernel_width(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *rest: torch.Tensor) -> list[torch.Tensor]:
    """``[q, k, v, *rest]`` padded to the width :func:`kernel_head_dim`
    gives for q's and v's head dims (``rest``: dO, out): the tensors
    themselves, no copy, when ``d == dv`` is a compiled width."""
    width = kernel_head_dim(q.shape[-1], v.shape[-1])
    return [pad_head_dim(t, width) for t in (q, k, v, *rest)]
