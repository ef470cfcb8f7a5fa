"""Brute-force ground-truth dispatcher (the port's copy of
``magiattention_tpu/testing/gt_dispatcher.py``).

Computes per-chunk self-attention areas by materializing the full mask
(O(S^2) memory, testing only), to validate the solver's closed-form areas.
"""

from __future__ import annotations

import numpy as np

from ..common.enum import AttnMaskType
from ..common.mask import AttnMask
from ..common.ranges import AttnRanges


class GroundTruthDispatcher:
    def __init__(
        self,
        q_ranges: AttnRanges,
        k_ranges: AttnRanges,
        attn_mask_type: list[AttnMaskType],
        total_seqlen: int,
    ) -> None:
        self.mask = AttnMask.from_ranges(
            q_ranges, k_ranges, attn_mask_type,
            total_seqlen_q=total_seqlen, total_seqlen_k=total_seqlen,
        ).mask_array
        self.total_seqlen = total_seqlen

    def chunk_areas(self, chunk_size: int) -> np.ndarray:
        n = -(-self.total_seqlen // chunk_size)
        return np.array(
            [int(self.mask[c * chunk_size : (c + 1) * chunk_size].sum()) for c in range(n)],
            dtype=np.int64,
        )

    def rank_areas(self, partitions: list[list[int]], chunk_size: int) -> list[int]:
        per_chunk = self.chunk_areas(chunk_size)
        return [int(sum(per_chunk[c] for c in p)) for p in partitions]
