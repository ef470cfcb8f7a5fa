"""C++-backed AttnRange / AttnRanges conforming to ``common.protocols``
(the port's copy of ``magiattention_tpu/csrc_backend/ranges.py``).

The set-algebra paths (merge / holes / overlaps / make-local) run in
native code over (n,2) int32 buffers; scalar interval methods subclass the
Python implementation (O(1), not worth crossing the FFI). Swapped in by
``common/__init__`` under ``MAGI_ATTENTION_CPP_BACKEND=1`` (default). Where
the library cannot be built (no ``g++``), each method takes the Python
implementation's result, which the native one equals.

As in the JAX package, the planners import the Python classes directly:
their range lists stay short (tens of entries), where per-call ctypes
marshalling costs more than it saves; these classes are the package-root
export for callers with long range lists.
"""

from __future__ import annotations

from typing import Sequence

from ..common.range import AttnRange as _PyAttnRange
from ..common.ranges import AttnRanges as _PyAttnRanges
from . import build, ops


class CppAttnRange(_PyAttnRange):
    """Scalar interval — same semantics as the Python backend."""

    __slots__ = ()


class CppAttnRanges(_PyAttnRanges):
    """Range-list with native set algebra."""

    def merge(self) -> "CppAttnRanges":
        if not self._ranges:
            return CppAttnRanges()
        if not build.available():
            return CppAttnRanges.from_ranges(super().merge())
        merged = ops.ranges_merge_native(self.to_array())
        return CppAttnRanges.from_ranges(merged.tolist())

    def find_hole_ranges(
        self, other: _PyAttnRanges, is_self_merged: bool = False
    ) -> "CppAttnRanges":
        if not build.available():
            return CppAttnRanges.from_ranges(super().find_hole_ranges(other, is_self_merged))
        mine = self if is_self_merged else self.merge()
        holes = ops.ranges_holes_native(
            mine.to_array(), other.merge().to_array()
        )
        return CppAttnRanges.from_ranges(holes.tolist())

    def find_overlap_ranges(self, other: _PyAttnRanges) -> "CppAttnRanges":
        if not build.available():
            return CppAttnRanges.from_ranges(super().find_overlap_ranges(other))
        out = ops.ranges_overlap_native(
            self.merge().to_array(), other.merge().to_array()
        )
        return CppAttnRanges.from_ranges(out.tolist())

    def make_ranges_local(
        self, ranges: _PyAttnRanges, is_self_merged: bool = False
    ) -> "CppAttnRanges":
        if not build.available():
            return CppAttnRanges.from_ranges(super().make_ranges_local(ranges, is_self_merged))
        host = self if is_self_merged else self.merge()
        out = ops.ranges_make_local_native(host.to_array(), ranges.to_array())
        return CppAttnRanges.from_ranges(out.tolist())

    @classmethod
    def from_ranges(
        cls, ranges: Sequence[Sequence[int]] | Sequence[_PyAttnRange], check: bool = False
    ) -> "CppAttnRanges":
        out = cls()
        for r in ranges:
            if isinstance(r, _PyAttnRange):
                out.append(CppAttnRange(r.start, r.end), check=check)
            else:
                out.append(CppAttnRange(int(r[0]), int(r[1])), check=check)
        return out

    def sort(self) -> "CppAttnRanges":
        return CppAttnRanges(sorted(self._ranges, key=lambda r: (r.start, r.end)))

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return CppAttnRanges(self._ranges[idx])
        return self._ranges[idx]
