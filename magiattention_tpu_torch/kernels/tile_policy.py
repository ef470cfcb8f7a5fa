"""The backward-mode cost model.

The port's copy of the split-vs-fused part of
``magiattention_tpu/kernels/tile_policy.py`` (``bwd_mxu_elems``,
``bwd_hbm_bytes``, ``choose_bwd_mode``), with the compute/memory balance
constant re-derived for the H100. The TPU tile-size policy (auto-tile,
mixed dispatch) is not ported yet (ROADMAP).
"""

from __future__ import annotations

# tile matmuls per work item (asserted 7 -> 5 by unit test)
BWD_TILE_MATMULS_SPLIT_DQ = 3  # s, dp, dq
BWD_TILE_MATMULS_SPLIT_DKV = 4  # s_t, dp_t, dk, dv
BWD_TILE_MATMULS_SPLIT = BWD_TILE_MATMULS_SPLIT_DQ + BWD_TILE_MATMULS_SPLIT_DKV
BWD_TILE_MATMULS_FUSED = 5  # s_t, dp_t, dk, dv, dq
# Tensor-core elements per HBM byte at which compute and memory time
# balance: NVIDIA H100 SXM data sheet, 989 TFLOP/s dense bf16 against
# 3.35 TB/s HBM3 = 295.2 (the JAX package's 240 is a TPU v5e's 197 TFLOP/s
# over 819 GB/s). Converts the HBM term into the units the product term is
# counted in.
BWD_MXU_ELEMS_PER_HBM_BYTE = 295


def bwd_mxu_elems(
    mode: str,
    w_dq: int,
    bq_dq: int,
    bk_dq: int,
    wt: int,
    bq_dkv: int,
    bk_dkv: int,
    d: int,
) -> int:
    """Product-element (multiply-add) count of one backward under
    ``mode`` ("split" | "fused"): tile products per work item x the item's
    (bq, bk, d) volume. Under equal blocks and equal work counts the split/fused
    ratio is exactly 7/5 — the fusion's recompute saving."""
    if mode == "split":
        return (
            BWD_TILE_MATMULS_SPLIT_DQ * w_dq * bq_dq * bk_dq * d
            + BWD_TILE_MATMULS_SPLIT_DKV * wt * bq_dkv * bk_dkv * d
        )
    return BWD_TILE_MATMULS_FUSED * wt * bq_dkv * bk_dkv * d


def bwd_hbm_bytes(
    mode: str,
    w_dq: int,
    bq_dq: int,
    bk_dq: int,
    wt: int,
    bq_dkv: int,
    bk_dkv: int,
    d: int,
    dv: int,
    itemsize: int = 2,
    group: int = 1,
) -> int:
    """Modeled HBM bytes streamed by one backward under ``mode``: per grid
    item, the operand blocks fetched plus the output blocks written. The
    fused mode drops the dq pass's whole stream but adds the revisited dq
    window's fp32 read-modify-write every step."""
    g = group
    dq_stream = (
        (bq_dq * d + bk_dq * d + bk_dq * dv + bq_dq * dv) * itemsize
        + bq_dq * d * 4  # fp32 dq out
    )
    dkv_stream = (
        (g * bq_dkv * d + bk_dkv * d + bk_dkv * dv + g * bq_dkv * dv)
        * itemsize
        + (bk_dkv * d + bk_dkv * dv) * 4  # fp32 dk/dv outs
    )
    if mode == "split":
        return w_dq * dq_stream + wt * dkv_stream
    # fused: one pass, plus 2x the fp32 dq window (read + write) per step
    return wt * (dkv_stream + 2 * g * bq_dkv * d * 4)


def choose_bwd_mode(
    w_dq: int,
    bq_dq: int,
    bk_dq: int,
    wt: int,
    bq_dkv: int,
    bk_dkv: int,
    d: int,
    dv: int,
    itemsize: int = 2,
    group: int = 1,
) -> str:
    """"fused" or "split" by modeled cost (product elements + balanced HBM
    term).

    Fused wins whenever the two plans are comparably sized (the common
    case: 5/7 the recompute and half the operand streams); split wins when
    the q-major dq plan is much cheaper than the k-major plan — e.g. a
    mask whose k-major tiling fragments far worse than its q-major one,
    where rerunning the cheap dq pass beats dragging dq through every
    k-major step's fp32 read-modify-write. Feasibility (shared memory and
    registers, plan meta columns) is the caller's job
    (kernels/ffa.ffa_bwd_mode)."""
    args = (w_dq, bq_dq, bk_dq, wt, bq_dkv, bk_dkv, d)
    hbm = (dv, itemsize, group)
    split_cost = bwd_mxu_elems("split", *args) + (
        BWD_MXU_ELEMS_PER_HBM_BYTE * bwd_hbm_bytes("split", *args, *hbm)
    )
    fused_cost = bwd_mxu_elems("fused", *args) + (
        BWD_MXU_ELEMS_PER_HBM_BYTE * bwd_hbm_bytes("fused", *args, *hbm)
    )
    return "fused" if fused_cost <= split_cost else "split"
