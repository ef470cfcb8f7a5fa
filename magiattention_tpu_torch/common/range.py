"""Half-open interval ``[start, end)`` algebra.

The port's copy of ``magiattention_tpu/common/range.py`` (numpy only, imports
rewired).

Host-side planning primitive (ref: magi_attention/common/range.py:24-294).
Pure Python — no JAX dependency; everything here runs at plan/trace time.
"""

from __future__ import annotations

from typing import Any, Iterator


class RangeError(ValueError):
    pass


class AttnRange:
    """A half-open integer interval ``[start, end)``."""

    __slots__ = ("_start", "_end")

    def __init__(self, start: int, end: int) -> None:
        self.check_valid(start, end)
        self._start = int(start)
        self._end = int(end)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def check_valid(start: int, end: int) -> None:
        if start < 0 or end < 0:
            raise RangeError(f"range must be non-negative, got [{start}, {end})")
        if start > end:
            raise RangeError(f"range start must be <= end, got [{start}, {end})")

    @classmethod
    def from_range(cls, other: "AttnRange") -> "AttnRange":
        return cls(other.start, other.end)

    @classmethod
    def from_tuple(cls, t: tuple[int, int]) -> "AttnRange":
        return cls(t[0], t[1])

    # -- properties --------------------------------------------------------

    @property
    def start(self) -> int:
        return self._start

    @start.setter
    def start(self, value: int) -> None:
        self.check_valid(value, self._end)
        self._start = int(value)

    @property
    def end(self) -> int:
        return self._end

    @end.setter
    def end(self, value: int) -> None:
        self.check_valid(self._start, value)
        self._end = int(value)

    @property
    def seqlen(self) -> int:
        return self._end - self._start

    def is_empty(self) -> bool:
        return self._start == self._end

    def is_valid(self) -> bool:
        return 0 <= self._start <= self._end

    # -- algebra -----------------------------------------------------------

    def is_subrange_of(self, other: "AttnRange") -> bool:
        if self.is_empty():
            return True
        return other.start <= self.start and self.end <= other.end

    def is_overlap_with(self, other: "AttnRange") -> bool:
        return max(self.start, other.start) < min(self.end, other.end)

    def intersect(self, other: "AttnRange") -> "AttnRange":
        """The overlap of the two ranges (empty range at the boundary if disjoint)."""
        start = max(self.start, other.start)
        end = min(self.end, other.end)
        if start >= end:  # disjoint -> canonical empty range
            return AttnRange(start, start)
        return AttnRange(start, end)

    def union(self, other: "AttnRange") -> "AttnRange":
        """The union, valid only if the ranges touch or overlap."""
        if not (self.is_overlap_with(other) or self.is_adjacent_to(other)):
            raise RangeError(f"cannot union disjoint ranges {self} and {other}")
        return AttnRange(min(self.start, other.start), max(self.end, other.end))

    def is_adjacent_to(self, other: "AttnRange") -> bool:
        return self.end == other.start or other.end == self.start

    def diff_by(self, other: "AttnRange") -> list["AttnRange"]:
        """``self - other`` as a list of 0-2 non-empty ranges."""
        out: list[AttnRange] = []
        if not self.is_overlap_with(other):
            if not self.is_empty():
                out.append(AttnRange.from_range(self))
            return out
        if self.start < other.start:
            out.append(AttnRange(self.start, other.start))
        if other.end < self.end:
            out.append(AttnRange(other.end, self.end))
        return out

    def truncate(self, start: int | None = None, end: int | None = None) -> "AttnRange":
        """Clamp this range into ``[start, end)``."""
        lo = self.start if start is None else max(self.start, start)
        hi = self.end if end is None else min(self.end, end)
        if lo >= hi:
            lo = hi = max(lo if end is None else min(lo, end), 0)
        return AttnRange(lo, hi)

    def offset(self, off: int) -> "AttnRange":
        return AttnRange(self.start + off, self.end + off)

    def intersect_size(self, other: "AttnRange") -> int:
        return max(0, min(self.end, other.end) - max(self.start, other.start))

    # -- dunder ------------------------------------------------------------

    def to_tuple(self) -> tuple[int, int]:
        return (self._start, self._end)

    def __contains__(self, pos: int) -> bool:
        return self._start <= pos < self._end

    def __iter__(self) -> Iterator[int]:
        return iter(range(self._start, self._end))

    def __len__(self) -> int:
        return self.seqlen

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, AttnRange):
            return self._start == other._start and self._end == other._end
        return NotImplemented

    def __lt__(self, other: "AttnRange") -> bool:
        return (self._start, self._end) < (other._start, other._end)

    def __hash__(self) -> int:
        return hash((self._start, self._end))

    def __repr__(self) -> str:
        return f"[{self._start}, {self._end})"
