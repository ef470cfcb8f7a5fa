"""AttnSlice — the atomic calculation unit (ref: magi_attention/meta/container/slice.py:23).

The port's copy of ``magiattention_tpu/meta/container/slice.py`` (numpy only, imports
rewired).

A slice is a (q_range, k_range, diagonal band) triple; ``area`` is its number
of unmasked (q, k) pairs. Bands (``d_lo <= j - i <= d_hi`` in global
coordinates) subsume the four mask types — see kernels/mask_utils.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...common.enum import AttnMaskType
from ...common.range import AttnRange
from ...csrc_backend import build as native_build
from ...csrc_backend.ops import band_area_native
from ...env.general import is_cpp_backend_enable
from ...kernels.mask_utils import BAND_INF


def band_area(
    i0: int, i1: int, j0: int, j1: int, lo: int, hi: int
) -> int:
    """Unmasked pairs of band [lo, hi] on rect [i0,i1) x [j0,j1): the
    native host backend's closed form (``csrc/magi_host.cpp``
    ``magi_band_area``) under MAGI_ATTENTION_CPP_BACKEND=1 where it builds,
    else O(rows) vectorized here (the same integer)."""
    if i0 >= i1 or j0 >= j1 or lo > hi:
        return 0
    if is_cpp_backend_enable() and native_build.available():
        return band_area_native(i0, i1, j0, j1, lo, hi)
    rows = np.arange(i0, i1, dtype=np.int64)
    lo_j = np.maximum(j0, rows + lo)
    hi_j = np.minimum(j1 - 1, rows + hi)
    return int(np.clip(hi_j - lo_j + 1, 0, None).sum())


def band_area_batch(i0, i1, j0, j1, lo, hi) -> np.ndarray:
    """Vectorized closed-form band area over int64 arrays.

    Same contract as :func:`band_area` per element, O(1) per slice instead
    of O(rows): area = f(hi) - f(lo-1) where f(d) counts rectangle pairs
    with j - i <= d; f is a clipped arithmetic series in i.
    """
    i0, i1, j0, j1, lo, hi = (
        np.asarray(a, dtype=np.int64) for a in (i0, i1, j0, j1, lo, hi)
    )

    def f(d):
        # cnt(i) = clip(d + i + 1 - j0, 0, j1 - j0); series region is
        # i in [j0 - d, j1 - d - 1), full region above
        lo_i = np.clip(j0 - d, i0, i1)
        hi_i = np.clip(j1 - d - 1, i0, i1)
        n = hi_i - lo_i
        first = d + lo_i + 1 - j0
        last = d + hi_i - j0
        series = n * (first + last) // 2
        full = (i1 - hi_i) * (j1 - j0)
        return series + full

    area = f(hi) - f(lo - 1)
    empty = (i0 >= i1) | (j0 >= j1) | (lo > hi)
    return np.where(empty, 0, area)


def type_to_band(
    q_range: AttnRange, k_range: AttnRange, mask_type: AttnMaskType
) -> tuple[int, int]:
    """Band bounds implied by a mask type on (q_range, k_range)."""
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
    return d_lo, d_hi


@dataclass
class AttnSlice:
    """One (q_range x k_range) band slice in global coordinates."""

    q_range: AttnRange
    k_range: AttnRange
    d_lo: int = -BAND_INF
    d_hi: int = BAND_INF
    _area: int | None = field(default=None, repr=False)

    @classmethod
    def from_mask_type(
        cls, q_range: AttnRange, k_range: AttnRange, mask_type: AttnMaskType
    ) -> "AttnSlice":
        lo, hi = type_to_band(q_range, k_range, mask_type)
        return cls(q_range=q_range, k_range=k_range, d_lo=lo, d_hi=hi)

    @property
    def area(self) -> int:
        if self._area is None:
            self._area = band_area(
                self.q_range.start,
                self.q_range.end,
                self.k_range.start,
                self.k_range.end,
                self.d_lo,
                self.d_hi,
            )
        return self._area

    def is_empty(self) -> bool:
        return self.area == 0

    def clip_q(self, i0: int, i1: int) -> "AttnSlice":
        """Restrict to q rows [i0, i1) — exact under band encoding."""
        return AttnSlice(
            q_range=self.q_range.truncate(i0, i1),
            k_range=self.k_range,
            d_lo=self.d_lo,
            d_hi=self.d_hi,
        )

    def clip_k(self, j0: int, j1: int) -> "AttnSlice":
        """Restrict to k cols [j0, j1) — exact under band encoding."""
        return AttnSlice(
            q_range=self.q_range,
            k_range=self.k_range.truncate(j0, j1),
            d_lo=self.d_lo,
            d_hi=self.d_hi,
        )

    def needed_k_range(self) -> AttnRange:
        """The k sub-range actually touched given the band bounds."""
        qs, qe = self.q_range.start, self.q_range.end
        ks, ke = self.k_range.start, self.k_range.end
        if qs >= qe:
            return AttnRange(ks, ks)
        k_min = max(ks, qs + self.d_lo) if self.d_lo > -BAND_INF else ks
        k_max = min(ke, qe - 1 + self.d_hi + 1) if self.d_hi < BAND_INF else ke
        if k_min >= k_max:
            return AttnRange(ks, ks)
        return AttnRange(k_min, k_max)

    def shrink(self) -> "AttnSlice":
        """Shrink q/k ranges to the band's actual footprint."""
        k = self.needed_k_range()
        qs, qe = self.q_range.start, self.q_range.end
        # rows with a nonempty valid j interval
        if k.is_empty():
            return AttnSlice(AttnRange(qs, qs), k, self.d_lo, self.d_hi)
        q_min = max(qs, k.start - self.d_hi) if self.d_hi < BAND_INF else qs
        q_max = min(qe, k.end - 1 - self.d_lo + 1) if self.d_lo > -BAND_INF else qe
        if q_min >= q_max:
            return AttnSlice(AttnRange(qs, qs), AttnRange(k.start, k.start),
                             self.d_lo, self.d_hi)
        return AttnSlice(AttnRange(q_min, q_max), k, self.d_lo, self.d_hi)
