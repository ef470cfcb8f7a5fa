"""AttnRectangle(s) — (q_range, k_range, d_range) geometry.

The port's copy of ``magiattention_tpu/common/rectangle.py`` (numpy only, imports
rewired).

Ref: magi_attention/common/rectangle.py:28-564, rectangles.py:29-309 — the
planning unit of the *dynamic* (qo-comm) solver. A rectangle is a q x k box
with a diagonal band ``d_range = [d_lo, d_hi]`` (closed, in ``j - i``
coordinates); identical to the band-slice encoding the kernels use
(kernels/mask_utils), so converting between the two is free.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kernels.mask_utils import BAND_INF
from .enum import AttnMaskType
from .range import AttnRange


@dataclass
class AttnRectangle:
    q_range: AttnRange
    k_range: AttnRange
    d_lo: int = -BAND_INF
    d_hi: int = BAND_INF

    @classmethod
    def from_mask_type(
        cls, q_range: AttnRange, k_range: AttnRange, mask_type: AttnMaskType
    ) -> "AttnRectangle":
        d_hi = (
            k_range.end - q_range.end
            if mask_type in (AttnMaskType.CAUSAL, AttnMaskType.BICAUSAL)
            else BAND_INF
        )
        d_lo = (
            k_range.start - q_range.start
            if mask_type in (AttnMaskType.INVCAUSAL, AttnMaskType.BICAUSAL)
            else -BAND_INF
        )
        return cls(q_range, k_range, d_lo, d_hi).shrink()

    # -- geometry ----------------------------------------------------------

    def shrink(self) -> "AttnRectangle":
        """Tighten q/k ranges and d bounds to the actual footprint
        (ref rectangle.py shrink_d/q/k_range)."""
        qs, qe = self.q_range.start, self.q_range.end
        ks, ke = self.k_range.start, self.k_range.end
        if qs >= qe or ks >= ke or self.d_lo > self.d_hi:
            return AttnRectangle(AttnRange(qs, qs), AttnRange(ks, ks), 0, -1)
        # d range implied by the box corners
        lo = max(self.d_lo, ks - (qe - 1))
        hi = min(self.d_hi, (ke - 1) - qs)
        if lo > hi:
            return AttnRectangle(AttnRange(qs, qs), AttnRange(ks, ks), 0, -1)
        # k bounds implied by band over q rows
        k_min = max(ks, qs + lo)
        k_max = min(ke, (qe - 1) + hi + 1)
        # q bounds implied by band over k cols
        q_min = max(qs, k_min - hi)
        q_max = min(qe, (k_max - 1) - lo + 1)
        return AttnRectangle(
            AttnRange(q_min, q_max), AttnRange(k_min, k_max), lo, hi
        )

    def is_empty(self) -> bool:
        r = self.shrink()
        return r.q_range.is_empty() or r.k_range.is_empty() or r.d_lo > r.d_hi

    def area(self) -> int:
        from ..meta.container.slice import band_area

        return band_area(
            self.q_range.start, self.q_range.end,
            self.k_range.start, self.k_range.end,
            self.d_lo, self.d_hi,
        )

    def cut_q(self, pos: int) -> tuple["AttnRectangle", "AttnRectangle"]:
        """Split at q == pos into (top, bottom), both shrunk (ref cut_q)."""
        top = AttnRectangle(
            self.q_range.truncate(end=pos), self.k_range, self.d_lo, self.d_hi
        ).shrink()
        bot = AttnRectangle(
            self.q_range.truncate(start=pos), self.k_range, self.d_lo, self.d_hi
        ).shrink()
        return top, bot

    def cut_k(self, pos: int) -> tuple["AttnRectangle", "AttnRectangle"]:
        """Split at k == pos into (left, right), both shrunk (ref cut_k)."""
        left = AttnRectangle(
            self.q_range, self.k_range.truncate(end=pos), self.d_lo, self.d_hi
        ).shrink()
        right = AttnRectangle(
            self.q_range, self.k_range.truncate(start=pos), self.d_lo, self.d_hi
        ).shrink()
        return left, right


@dataclass
class AttnRectangles:
    """A list of rectangles with bulk geometry ops (ref rectangles.py)."""

    rects: list[AttnRectangle] = field(default_factory=list)

    @classmethod
    def from_ranges(cls, q_ranges, k_ranges, attn_mask_type) -> "AttnRectangles":
        out = cls()
        for qr, kr, mt in zip(q_ranges, k_ranges, attn_mask_type):
            r = AttnRectangle.from_mask_type(qr, kr, AttnMaskType.normalize(mt))
            if not r.is_empty():
                out.rects.append(r)
        return out

    def append(self, r: AttnRectangle) -> None:
        self.rects.append(r)

    def extend(self, other: "AttnRectangles") -> None:
        self.rects.extend(other.rects)

    def area(self) -> int:
        return sum(r.area() for r in self.rects)

    def count(self) -> int:
        return len(self.rects)

    def cut_q(self, pos: int) -> tuple["AttnRectangles", "AttnRectangles"]:
        top, bot = AttnRectangles(), AttnRectangles()
        for r in self.rects:
            t, b = r.cut_q(pos)
            if not t.is_empty():
                top.append(t)
            if not b.is_empty():
                bot.append(b)
        return top, bot

    def cut_k(self, pos: int) -> tuple["AttnRectangles", "AttnRectangles"]:
        left, right = AttnRectangles(), AttnRectangles()
        for r in self.rects:
            lft, rgt = r.cut_k(pos)
            if not lft.is_empty():
                left.append(lft)
            if not rgt.is_empty():
                right.append(rgt)
        return left, right

    def __iter__(self):
        return iter(self.rects)

    def __len__(self) -> int:
        return len(self.rects)
