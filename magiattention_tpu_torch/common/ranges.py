"""Ordered list-of-ranges algebra for attention planning.

The port's copy of ``magiattention_tpu/common/ranges.py`` (numpy only, imports
rewired).

Host-side planning primitive (ref: magi_attention/common/ranges.py:101-924).
``AttnRanges`` is the workhorse of the dispatch / dist-attn solvers: a mutable
sequence of :class:`AttnRange` with sort / merge / chunk / coordinate-remap
operations. Pure Python, no JAX dependency.
"""

from __future__ import annotations

import bisect
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from .range import AttnRange, RangeError


class AttnRanges:
    """A list of half-open ranges with planning algebra."""

    def __init__(self, ranges: Iterable[AttnRange] | None = None) -> None:
        self._ranges: list[AttnRange] = list(ranges) if ranges is not None else []

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_ranges(
        cls, ranges: Sequence[Sequence[int]] | Sequence[AttnRange], check: bool = False
    ) -> "AttnRanges":
        out = cls()
        for r in ranges:
            if isinstance(r, AttnRange):
                out.append(AttnRange.from_range(r))
            else:
                out.append(AttnRange(r[0], r[1]))
        if check and not out.is_valid():
            raise RangeError(f"invalid ranges: {out}")
        return out

    @classmethod
    def from_cu_seqlens(cls, cu_seqlens: Sequence[int], seq_len: int | None = None) -> "AttnRanges":
        """Build contiguous ranges from a cumulative-seqlen array."""
        if len(cu_seqlens) == 0:
            return cls()
        if cu_seqlens[0] != 0:
            raise RangeError(f"cu_seqlens must start at 0, got {cu_seqlens[0]}")
        if seq_len is not None and cu_seqlens[-1] != seq_len:
            raise RangeError(
                f"cu_seqlens must end at seq_len={seq_len}, got {cu_seqlens[-1]}"
            )
        return cls.from_ranges(
            [(cu_seqlens[i], cu_seqlens[i + 1]) for i in range(len(cu_seqlens) - 1)]
        )

    # -- container protocol ------------------------------------------------

    def append(self, r: AttnRange, check: bool = False) -> None:
        if check and not r.is_valid():
            raise RangeError(f"invalid range {r}")
        self._ranges.append(r)

    def extend(self, other: "AttnRanges", check: bool = False) -> None:
        for r in other:
            self.append(r, check=check)

    def insert(self, idx: int, r: AttnRange) -> None:
        self._ranges.insert(idx, r)

    def pop(self, idx: int = -1) -> AttnRange:
        return self._ranges.pop(idx)

    def clear(self) -> None:
        self._ranges.clear()

    def __len__(self) -> int:
        return len(self._ranges)

    def __iter__(self) -> Iterator[AttnRange]:
        return iter(self._ranges)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return AttnRanges(self._ranges[idx])
        return self._ranges[idx]

    def __setitem__(self, idx: int, value: AttnRange) -> None:
        self._ranges[idx] = value

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, AttnRanges):
            return self._ranges == other._ranges
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple(self._ranges))

    def __repr__(self) -> str:
        return f"AttnRanges({self._ranges})"

    # -- properties --------------------------------------------------------

    @property
    def start(self) -> int:
        """Min start over all non-empty ranges."""
        starts = [r.start for r in self._ranges if not r.is_empty()]
        if not starts:
            return 0
        return min(starts)

    @property
    def end(self) -> int:
        """Max end over all ranges."""
        if not self._ranges:
            return 0
        return max(r.end for r in self._ranges)

    @property
    def total_seqlen(self) -> int:
        """Sum of range lengths (NOT deduplicated)."""
        return sum(r.seqlen for r in self._ranges)

    @property
    def max_seqlen(self) -> int:
        if not self._ranges:
            return 0
        return max(r.seqlen for r in self._ranges)

    def is_empty(self) -> bool:
        return all(r.is_empty() for r in self._ranges)

    def is_valid(self) -> bool:
        return all(r.is_valid() for r in self._ranges)

    def is_sorted(self) -> bool:
        return all(
            self._ranges[i].start <= self._ranges[i + 1].start
            for i in range(len(self._ranges) - 1)
        )

    def is_merged(self) -> bool:
        """True iff sorted, non-empty, pairwise disjoint and non-adjacent."""
        m = self.merge()
        return self._ranges == m._ranges

    def is_non_overlap(self) -> bool:
        rs = sorted(r for r in self._ranges if not r.is_empty())
        return all(rs[i].end <= rs[i + 1].start for i in range(len(rs) - 1))

    def is_cu_seqlens(self, seq_len: int | None = None) -> bool:
        """True iff ranges are contiguous from 0 (optionally covering seq_len)."""
        if not self._ranges:
            return seq_len in (None, 0)
        if self._ranges[0].start != 0:
            return False
        for i in range(len(self._ranges) - 1):
            if self._ranges[i].end != self._ranges[i + 1].start:
                return False
        return seq_len is None or self._ranges[-1].end == seq_len

    # -- algebra -----------------------------------------------------------

    def sort(self) -> "AttnRanges":
        return AttnRanges(sorted(self._ranges, key=lambda r: (r.start, r.end)))

    def merge(self) -> "AttnRanges":
        """Sort, drop empties, coalesce overlapping/adjacent ranges."""
        rs = sorted((r for r in self._ranges if not r.is_empty()), key=lambda r: r.start)
        out: list[AttnRange] = []
        for r in rs:
            if out and r.start <= out[-1].end:
                if r.end > out[-1].end:
                    out[-1] = AttnRange(out[-1].start, r.end)
            else:
                out.append(AttnRange.from_range(r))
        return AttnRanges(out)

    def intersect_size(self) -> int:
        """Total (deduplicated) covered length."""
        return self.merge().total_seqlen

    def intersect_size_with(self, other: "AttnRanges") -> int:
        """Covered length of the intersection of the two (merged) coverages."""
        a, b = self.merge(), other.merge()
        i = j = 0
        total = 0
        while i < len(a) and j < len(b):
            total += a[i].intersect_size(b[j])
            if a[i].end < b[j].end:
                i += 1
            else:
                j += 1
        return total

    def union_size_with(self, other: "AttnRanges") -> int:
        combined = AttnRanges(list(self._ranges) + list(other._ranges))
        return combined.intersect_size()

    def find_hole_ranges(
        self, other: "AttnRanges", is_self_merged: bool = False
    ) -> "AttnRanges":
        """Coverage of ``self`` not covered by ``other`` (set difference)."""
        mine = self if is_self_merged else self.merge()
        theirs = other.merge()
        out = AttnRanges()
        j = 0
        for r in mine:
            cur = r.start
            while j < len(theirs) and theirs[j].end <= cur:
                j += 1
            k = j
            while k < len(theirs) and theirs[k].start < r.end:
                if theirs[k].start > cur:
                    out.append(AttnRange(cur, theirs[k].start))
                cur = max(cur, theirs[k].end)
                if cur >= r.end:
                    break
                k += 1
            if cur < r.end:
                out.append(AttnRange(cur, r.end))
        return out

    def find_overlap_ranges(self, other: "AttnRanges") -> "AttnRanges":
        """Coverage intersection of the two (merged) range sets."""
        a, b = self.merge(), other.merge()
        out = AttnRanges()
        i = j = 0
        while i < len(a) and j < len(b):
            inter = a[i].intersect(b[j])
            if not inter.is_empty():
                out.append(inter)
            if a[i].end < b[j].end:
                i += 1
            else:
                j += 1
        return out

    def chunk(self, chunk_size: int, check: bool = False) -> list["AttnRanges"]:
        """Split the (merged) coverage into consecutive chunks of ``chunk_size``
        *in coverage coordinates*: chunk i covers covered positions
        ``[i*chunk_size, (i+1)*chunk_size)``. Each chunk is an AttnRanges of the
        global sub-ranges it maps to.
        """
        merged = self.merge()
        if check and merged.total_seqlen % chunk_size != 0:
            raise RangeError(
                f"total covered seqlen {merged.total_seqlen} is not divisible by "
                f"chunk_size {chunk_size}"
            )
        chunks: list[AttnRanges] = []
        cur = AttnRanges()
        budget = chunk_size
        for r in merged:
            start = r.start
            while start < r.end:
                take = min(budget, r.end - start)
                cur.append(AttnRange(start, start + take))
                start += take
                budget -= take
                if budget == 0:
                    chunks.append(cur)
                    cur = AttnRanges()
                    budget = chunk_size
        if len(cur) > 0:
            chunks.append(cur)
        return chunks

    def locator(self) -> "RangeLocator":
        """Bisect-backed global<->local mapper over the merged ranges.

        Build once per (stable) range list and reuse: every query is
        O(log n + pieces) instead of make_ranges_local's O(n) scan with a
        fresh merge — the 1M-token planning hot path (the reference solves
        the same problem by moving these loops into the C++ backend,
        csrc/extensions/attn_ranges.hpp).
        """
        return RangeLocator(self)

    def make_range_local(self, r: AttnRange, is_self_merged: bool = False) -> AttnRange:
        """Map a global sub-range into the local (concatenated) coordinate system
        defined by this range list. ``r`` must be fully inside one range."""
        offset = 0
        host = self if is_self_merged else self.merge()
        for own in host:
            if r.is_subrange_of(own):
                return AttnRange(
                    offset + (r.start - own.start), offset + (r.end - own.start)
                )
            offset += own.seqlen
        raise RangeError(f"range {r} is not contained in any single range of {host}")

    def make_ranges_local(
        self, ranges: "AttnRanges", is_self_merged: bool = False
    ) -> "AttnRanges":
        """Map global sub-ranges into local coordinates, splitting at boundaries."""
        host = self if is_self_merged else self.merge()
        # prefix offsets of each host range in local coords
        offsets = []
        off = 0
        for own in host:
            offsets.append(off)
            off += own.seqlen
        out = AttnRanges()
        for r in ranges:
            if r.is_empty():
                continue
            remaining = AttnRange.from_range(r)
            matched = 0
            for own, own_off in zip(host, offsets):
                inter = remaining.intersect(own)
                if inter.is_empty():
                    continue
                out.append(
                    AttnRange(
                        own_off + (inter.start - own.start),
                        own_off + (inter.end - own.start),
                    )
                )
                matched += inter.seqlen
            if matched != r.seqlen:
                raise RangeError(f"range {r} is not fully covered by {host}")
        return out

    def find_overlap_ranges_with_self(self) -> "AttnRanges":
        """Positions covered by >= 2 ranges of self."""
        events: list[tuple[int, int]] = []
        for r in self._ranges:
            if not r.is_empty():
                events.append((r.start, 1))
                events.append((r.end, -1))
        events.sort()
        out = AttnRanges()
        depth = 0
        seg_start = None
        for pos, delta in events:
            new_depth = depth + delta
            if depth < 2 and new_depth >= 2:
                seg_start = pos
            elif depth >= 2 and new_depth < 2 and seg_start is not None:
                if pos > seg_start:
                    out.append(AttnRange(seg_start, pos))
                seg_start = None
            depth = new_depth
        return out.merge()

    # -- conversions -------------------------------------------------------

    def to_cu_seqlens(self, seq_len: int | None = None) -> list[int]:
        if not self.is_cu_seqlens(seq_len):
            raise RangeError(f"{self} is not in cu_seqlens (contiguous) form")
        if not self._ranges:
            return [0]
        return [0] + [r.end for r in self._ranges]

    def to_naive_ranges(self) -> list[tuple[int, int]]:
        return [r.to_tuple() for r in self._ranges]

    def to_array(self) -> np.ndarray:
        """``(n, 2)`` int32 array — the device-metadata form."""
        if not self._ranges:
            return np.zeros((0, 2), dtype=np.int32)
        return np.asarray(self.to_naive_ranges(), dtype=np.int32)

    def points(self) -> list[int]:
        out: list[int] = []
        for r in self._ranges:
            out.extend(range(r.start, r.end))
        return out


class RangeLocator:
    """Bisect-backed global->local mapper for a merged range list.

    Precomputes (starts, ends, local offsets) of the merged host ranges so
    repeated single-range queries avoid make_ranges_local's per-call merge +
    linear scan (the 1M-token planning hot loop; the reference keeps these
    loops in C++, csrc/extensions/attn_ranges.hpp).
    """

    __slots__ = ("starts", "ends", "offsets")

    def __init__(self, host: "AttnRanges") -> None:
        merged = host.merge()
        self.starts = [r.start for r in merged]
        self.ends = [r.end for r in merged]
        self.offsets = []
        off = 0
        for r in merged:
            self.offsets.append(off)
            off += r.seqlen

    def segments(
        self, start: int, end: int
    ) -> list[tuple[int, int, int | None]]:
        """Decompose global [start, end) into maximal pieces.

        Returns (gs, ge, local_start) per piece in global order;
        ``local_start`` is None for pieces not covered by the host ranges
        (holes). Empty input yields [].
        """
        out: list[tuple[int, int, int | None]] = []
        if start >= end:
            return out
        pos = start
        # first host range whose end > pos
        i = bisect.bisect_right(self.ends, pos)
        n = len(self.starts)
        while pos < end:
            if i >= n or self.starts[i] >= end:
                out.append((pos, end, None))
                break
            hs, he = self.starts[i], self.ends[i]
            if pos < hs:
                out.append((pos, hs, None))
                pos = hs
            ge = min(end, he)
            out.append((pos, ge, self.offsets[i] + (pos - hs)))
            pos = ge
            i += 1
        return out

    def to_local(self, start: int, end: int) -> list[tuple[int, int]]:
        """Local (ls, le) pieces covering global [start, end); raises
        RangeError on any uncovered position (make_ranges_local contract)."""
        out = []
        for gs, ge, ls in self.segments(start, end):
            if ls is None:
                raise RangeError(
                    f"range [{start}, {end}) not fully covered by host"
                )
            out.append((ls, ls + (ge - gs)))
        return out
