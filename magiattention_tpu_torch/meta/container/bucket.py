"""AttnChunk / AttnBucket — workload bookkeeping for dispatch

The port's copy of ``magiattention_tpu/meta/container/bucket.py`` (numpy only, imports
rewired).
(ref: magi_attention/meta/container/chunk.py:23, bucket.py:24)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ...common.range import AttnRange
from .slice import AttnSlice


@dataclass
class AttnChunk:
    """One contiguous chunk of q rows and the slices restricted to it."""

    chunk_id: int
    q_range: AttnRange
    attn_slices: list[AttnSlice] = field(default_factory=list)

    @property
    def area(self) -> int:
        return sum(s.area for s in self.attn_slices)

    @property
    def seqlen(self) -> int:
        return self.q_range.seqlen


@dataclass
class AttnBucket:
    """A set of chunks owned by one rank (or the global bucket, cp_rank=None)."""

    cp_rank: int | None = None
    q_chunks: list[AttnChunk] = field(default_factory=list)

    @property
    def area(self) -> int:
        return sum(c.area for c in self.q_chunks)

    @property
    def chunk_ids(self) -> list[int]:
        return [c.chunk_id for c in self.q_chunks]

    @property
    def areas_per_chunk(self) -> list[int]:
        return [c.area for c in self.q_chunks]
