"""Block/index-sparse mask utilities (ref: magi_attention/utils/sparse_utils.py).

The port's copy of ``magiattention_tpu/utils/sparse_utils.py`` (numpy only,
imports rewired).

Converts sparse attention patterns into the slice metadata the FFA kernel
consumes (the reference's block-mask -> ranges conversion :371-407 and
topk -> ranges :262-304). Covers the Magi-1 spatiotemporal video mask
(BASELINE config 4): a per-block boolean mask over (q_blocks, k_blocks).
"""

from __future__ import annotations

import numpy as np

from ..common.ranges import AttnRanges


def block_mask_to_ranges(
    block_mask: np.ndarray,
    block_size_q: int,
    block_size_k: int,
) -> tuple[AttnRanges, AttnRanges, list]:
    """Block-boolean mask -> (q_ranges, k_ranges, FULL types).

    One slice per maximal contiguous run of attended k blocks in each q-block
    row (runs collapse many blocks into one wide slice — the kernel's plan
    stays small for structured video masks).
    """
    from ..common.enum import AttnMaskType

    nqb, nkb = block_mask.shape
    q_out, k_out, t_out = AttnRanges(), AttnRanges(), []
    from ..common.range import AttnRange

    for qb in range(nqb):
        row = block_mask[qb]
        j = 0
        while j < nkb:
            if not row[j]:
                j += 1
                continue
            j0 = j
            while j < nkb and row[j]:
                j += 1
            q_out.append(AttnRange(qb * block_size_q, (qb + 1) * block_size_q))
            k_out.append(AttnRange(j0 * block_size_k, j * block_size_k))
            t_out.append(AttnMaskType.FULL)
    return q_out, k_out, t_out


def topk_indices_to_block_mask(
    topk_idx: np.ndarray, num_k_blocks: int
) -> np.ndarray:
    """(nqb, topk) block indices (pad -1) -> (nqb, nkb) boolean block mask
    (the index-sparse -> block-sparse preprocessing, ref :262-304)."""
    nqb = topk_idx.shape[0]
    mask = np.zeros((nqb, num_k_blocks), dtype=bool)
    for qb in range(nqb):
        for idx in topk_idx[qb]:
            if idx >= 0:
                mask[qb, int(idx)] = True
    return mask


def make_video_block_mask(
    num_frames: int,
    tokens_per_frame_blocks: int,
    window_frames: int = 2,
    causal_frames: bool = True,
) -> np.ndarray:
    """Magi-1 style spatiotemporal pattern at block granularity: each frame's
    blocks attend to all blocks of the last ``window_frames`` frames
    (optionally causal over frames). Returns (nqb, nkb) boolean."""
    nb = num_frames * tokens_per_frame_blocks
    mask = np.zeros((nb, nb), dtype=bool)
    for f in range(num_frames):
        f_lo = max(0, f - window_frames + 1)
        f_hi = f + 1 if causal_frames else min(num_frames, f + window_frames)
        q0, q1 = f * tokens_per_frame_blocks, (f + 1) * tokens_per_frame_blocks
        k0, k1 = f_lo * tokens_per_frame_blocks, f_hi * tokens_per_frame_blocks
        mask[q0:q1, k0:k1] = True
    return mask


def block_mask_to_dense_mask(
    block_mask: np.ndarray, block_size_q: int, block_size_k: int
) -> np.ndarray:
    """Token-level dense boolean oracle for a block mask (the reference's
    SDPA-mask test oracles, sparse_utils.py:500-699)."""
    return np.kron(
        block_mask, np.ones((block_size_q, block_size_k), dtype=bool)
    )


def ranges_to_block_mask(
    q_ranges, k_ranges, num_q_blocks: int, num_k_blocks: int,
    block_size_q: int, block_size_k: int,
) -> np.ndarray:
    """Inverse of :func:`block_mask_to_ranges` for block-aligned FULL slices
    (round-trip testing aid)."""
    mask = np.zeros((num_q_blocks, num_k_blocks), dtype=bool)
    for qr, kr in zip(q_ranges, k_ranges):
        qb0, qb1 = qr.start // block_size_q, -(-qr.end // block_size_q)
        kb0, kb1 = kr.start // block_size_k, -(-kr.end // block_size_k)
        mask[qb0:qb1, kb0:kb1] = True
    return mask


def varlen_block_mask_to_ranges(
    block_mask: np.ndarray,
    q_block_bounds: np.ndarray,
    k_block_bounds: np.ndarray,
) -> tuple[AttnRanges, AttnRanges, list]:
    """Variable-size blocks: ``*_block_bounds`` are (nb+1,) token offsets per
    block (the reference's variable block patterns, sparse_utils.py:749).
    Returns (q_ranges, k_ranges, FULL types), one slice per maximal run."""
    from ..common.enum import AttnMaskType
    from ..common.range import AttnRange

    nqb, nkb = block_mask.shape
    assert len(q_block_bounds) == nqb + 1 and len(k_block_bounds) == nkb + 1
    q_out, k_out, t_out = AttnRanges(), AttnRanges(), []
    for qb in range(nqb):
        row = block_mask[qb]
        j = 0
        while j < nkb:
            if not row[j]:
                j += 1
                continue
            j0 = j
            while j < nkb and row[j]:
                j += 1
            q_out.append(
                AttnRange(int(q_block_bounds[qb]), int(q_block_bounds[qb + 1]))
            )
            k_out.append(
                AttnRange(int(k_block_bounds[j0]), int(k_block_bounds[j]))
            )
            t_out.append(AttnMaskType.FULL)
    return q_out, k_out, t_out


def topk_indices_to_ranges(
    topk_idx: np.ndarray, block_size_q: int, block_size_k: int,
    num_k_blocks: int,
) -> tuple[AttnRanges, AttnRanges, list]:
    """Index-sparse (per-q-block top-k k-blocks) directly to slice metadata
    (ref topk -> ranges, sparse_utils.py:262-304)."""
    mask = topk_indices_to_block_mask(topk_idx, num_k_blocks)
    return block_mask_to_ranges(mask, block_size_q, block_size_k)
