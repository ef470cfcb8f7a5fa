"""DispatchMeta — the chunk->rank assignment and its permutations.

The port's copy of ``magiattention_tpu/meta/collection/dispatch_meta.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/collection/dispatch_meta.py:24-122. For the TPU
build the permutation lives as host numpy index arrays that become static
gather indices inside the sharded dispatch/undispatch ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...common.enum import AttnType
from ...common.ranges import AttnRanges


@dataclass
class DispatchMeta:
    """Assignment of sequence chunks to CP ranks.

    Attributes:
        attn_type: self or cross attention.
        total_seqlen: global (padded) sequence length.
        chunk_size: rows per chunk.
        cp_size: number of CP ranks.
        partitions: chunk ids per rank, sorted ascending within each rank.
        position_ids: ``(cp_size, shard_len)`` int32 — global row index of
            each local row, per rank (the dispatch gather indices).
        host_ranges_per_rank: merged global row ranges owned by each rank.
    """

    attn_type: AttnType
    total_seqlen: int
    chunk_size: int
    cp_size: int
    partitions: list[list[int]]
    _position_ids: np.ndarray | None = field(default=None, repr=False)
    _host_ranges: list[AttnRanges] | None = field(default=None, repr=False)
    _unpermute_index: np.ndarray | None = field(default=None, repr=False)

    @property
    def num_chunks(self) -> int:
        return self.total_seqlen // self.chunk_size

    @property
    def is_uneven(self) -> bool:
        """Ranks own different chunk counts (DispatchConfig.uneven_shard)."""
        lens = {len(p) for p in self.partitions}
        return len(lens) > 1

    @property
    def shard_seqlen(self) -> int:
        """Padded on-device rows per rank (max over ranks when uneven)."""
        return max(len(p) for p in self.partitions) * self.chunk_size

    @property
    def shard_lens(self) -> list[int]:
        """Valid (unpadded) rows per rank."""
        return [len(p) * self.chunk_size for p in self.partitions]

    @property
    def position_ids(self) -> np.ndarray:
        """(cp, shard_seqlen) global row per local row; pad rows index 0
        (their attention output is never read back — dummy-tile rows)."""
        if self._position_ids is None:
            cs = self.chunk_size
            sp = self.shard_seqlen
            out = np.zeros((self.cp_size, sp), dtype=np.int32)
            for r, chunks in enumerate(self.partitions):
                rows = [np.arange(c * cs, (c + 1) * cs, dtype=np.int32) for c in chunks]
                cat = np.concatenate(rows) if rows else np.zeros(0, np.int32)
                out[r, : len(cat)] = cat
            self._position_ids = out
        return self._position_ids

    @property
    def host_ranges_per_rank(self) -> list[AttnRanges]:
        if self._host_ranges is None:
            cs = self.chunk_size
            self._host_ranges = [
                AttnRanges.from_ranges(
                    [(c * cs, (c + 1) * cs) for c in chunks]
                ).merge()
                for chunks in self.partitions
            ]
        return self._host_ranges

    @property
    def unpermute_index(self) -> np.ndarray:
        """``(total_seqlen,)`` int32: for each global row, its index in the
        rank-major concatenation of all (padded) local shards (the undispatch
        gather). Pad rows are simply never selected."""
        if self._unpermute_index is None:
            sp = self.shard_seqlen
            pos = self.position_ids  # (cp, sp), pads point at row 0
            inv = np.empty(self.total_seqlen, dtype=np.int32)
            flat_pos = pos.reshape(-1)
            flat_idx = np.arange(len(flat_pos), dtype=np.int32)
            valid = np.ones(len(flat_pos), dtype=bool)
            # pads (uneven shard) duplicate global row 0: keep only each
            # rank's true rows
            for r, n in enumerate(self.shard_lens):
                valid[r * sp + n: (r + 1) * sp] = False
            inv[flat_pos[valid]] = flat_idx[valid]
            self._unpermute_index = inv
        return self._unpermute_index

    def global_row_owner(self) -> np.ndarray:
        """``(total_seqlen,)`` int32 rank owning each global row."""
        owner = np.empty(self.total_seqlen, dtype=np.int32)
        cs = self.chunk_size
        for r, chunks in enumerate(self.partitions):
            for c in chunks:
                owner[c * cs : (c + 1) * cs] = r
        return owner
