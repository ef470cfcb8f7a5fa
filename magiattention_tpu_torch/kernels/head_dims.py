"""The head dims the port's CUDA kernels are compiled for, and the zero
padding that takes every other ``d, dv <= 128`` through them.

Every kernel body is instantiated at head dims 64 and 128 with equal q/k
and v widths. A call with other dims pads q and k (width ``d``) and v, dO
and out (width ``dv``) with zero columns to the smallest compiled width
that holds both, runs the kernel and slices the logical columns back. The
padding is exact: zero columns add exact zeros to S, dP and delta and give
zero columns in every output. The softmax scale stays the caller's (the
true ``d``'s), fixed before any tensor is padded.

Above 128 the card has no kernel: a 256-wide tile's dk and dv (2 x 128
floats a thread) do not fit one warpgroup's registers, so a new register
plan is needed (ROADMAP C4b). No model configuration of the repo exceeds
128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_HEAD_DIMS = (64, 128)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]


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
            f"{MAX_HEAD_DIM} (a 256-wide tile's dk and dv, 2 x 128 floats a "
            "thread, do not fit one warpgroup's registers; ROADMAP C4b)"
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
