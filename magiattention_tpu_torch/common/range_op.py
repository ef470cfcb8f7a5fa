"""range_op — range-indexed fill / gather / scatter / reduce on tensors.

The port's counterpart of ``magiattention_tpu/common/range_op.py``.

Ref: magi_attention/common/range_op/ (Triton kernels ``range_fill_`` :65,
``range_gather`` :127, ``range_reduce`` with sum / avg / lse-weighted and a
deterministic ordered variant, _range_reduce.py:80,360). Ranges are host
metadata, so each op turns them into flat row indices once (numpy) and runs
one torch gather, copy or ``index_add_``. Every op returns a new tensor and
leaves its inputs as they are, as the JAX functions do. The lse-weighted
reduce merges range pairs in list order (safe log-add-exp), the
reference's ordered semantics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..functional.utils import correct_attn_out_lse
from .range import RangeError


def _ranges_to_indices(ranges) -> np.ndarray:
    """(N, 2) host ranges -> concatenated row indices."""
    r = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
    chunks = [np.arange(s, e, dtype=np.int64) for s, e in r if s < e]
    if not chunks:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(chunks)


def _index(ranges, device) -> torch.Tensor:
    return torch.from_numpy(_ranges_to_indices(ranges)).to(device)


def range_fill(x: torch.Tensor, ranges, value) -> torch.Tensor:
    """Set rows covered by ``ranges`` to ``value`` (ref range_fill_ :65)."""
    idx = _index(ranges, x.device)
    out = x.clone()
    if len(idx):
        out[idx] = value
    return out


def range_gather(x: torch.Tensor, ranges) -> torch.Tensor:
    """Concatenate rows covered by ``ranges`` (ref range_gather :127)."""
    return x.index_select(0, _index(ranges, x.device))


def range_scatter(x: torch.Tensor, ranges, rows: torch.Tensor) -> torch.Tensor:
    """Inverse of range_gather: write ``rows`` into the covered positions."""
    idx = _index(ranges, x.device)
    return x.index_copy(0, idx, rows[: len(idx)].to(x.dtype))


def range_reduce(
    out: torch.Tensor,
    inp: torch.Tensor,
    out_ranges,
    inp_ranges,
    op: str = "sum",
    deterministic: bool = False,
) -> torch.Tensor:
    """Reduce ``inp`` range-blocks into ``out`` range-blocks.

    Each pair ``(inp_ranges[i] -> out_ranges[i])`` (equal lengths) adds its
    rows into the destination; overlapping destinations accumulate.
    op: "sum" | "avg" (mean over all partials of a destination row, the
    row's own value counting as one). ``deterministic`` is accepted for
    parity (ref _range_reduce.py:80); on the CPU ``index_add_`` sums in
    index order.
    """
    del deterministic
    oi = _ranges_to_indices(out_ranges)
    ii = _ranges_to_indices(inp_ranges)
    if len(oi) != len(ii):
        raise RangeError(
            f"range length mismatch: out_ranges {out_ranges} cover "
            f"{len(oi)} rows vs inp_ranges {inp_ranges} {len(ii)} rows"
        )
    if len(oi) == 0:
        return out
    oj = torch.from_numpy(oi).to(out.device)
    rows = inp.index_select(0, torch.from_numpy(ii).to(inp.device)).to(out.dtype)
    acc = out.index_add(0, oj, rows)
    if op == "sum":
        return acc
    if op == "avg":
        counts = np.zeros(out.shape[0], dtype=np.int64)
        np.add.at(counts, oi, 1)
        scale = np.where(counts > 0, 1.0 / (counts + 1), 1.0).astype(np.float32)
        shape = (-1,) + (1,) * (out.ndim - 1)
        scale_t = torch.from_numpy(scale).to(out.device).reshape(shape)
        return (acc.float() * scale_t).to(out.dtype)
    raise ValueError(f"unknown op: {op}")


def range_lse_reduce(
    out: torch.Tensor,
    lse: torch.Tensor,
    inp_out: torch.Tensor,
    inp_lse: torch.Tensor,
    out_ranges,
    inp_ranges,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LSE-weighted partial-attention reduce (ref range_lse_reduce_kernel
    :239): for each range pair, merge the incoming partial (out, lse) rows
    into the destination rows with the safe log-sum-exp identity. Pairs
    merge in list order — the deterministic ordered semantics."""
    out, lse = out.clone(), lse.clone()
    ro = np.asarray(out_ranges, dtype=np.int64).reshape(-1, 2)
    ri = np.asarray(inp_ranges, dtype=np.int64).reshape(-1, 2)
    for (os_, oe), (is_, ie) in zip(ro, ri):
        if oe <= os_:
            continue
        merged_o, merged_l = correct_attn_out_lse(
            out[os_:oe], lse[os_:oe], inp_out[is_:ie], inp_lse[is_:ie]
        )
        out[os_:oe], lse[os_:oe] = merged_o, merged_l
    return out, lse
