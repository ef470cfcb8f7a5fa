"""Attention mask types (the port's copy of the ``AttnMaskType`` part of
``magiattention_tpu/common/enum.py``).

Integer codes match the reference kernel contract (0=FULL, 1=CAUSAL,
2=INVCAUSAL, 3=BICAUSAL), so slice metadata arrays are interchangeable
between the two packages.
"""

from __future__ import annotations

from enum import Enum


class AttnMaskType(Enum):
    """Unit mask type of an attention slice.

    Semantics over a slice ``(q_range=[qs,qe), k_range=[ks,ke))`` for global
    coordinates ``(i, j)``:

    - ``FULL``:      all pairs in the rectangle are unmasked.
    - ``CAUSAL``:    bottom-right aligned lower-triangle: ``j - i <= ke - qe``.
    - ``INVCAUSAL``: top-left aligned upper-triangle:     ``j - i >= ks - qs``.
    - ``BICAUSAL``:  both constraints (a diagonal band).
    """

    FULL = "full"
    CAUSAL = "causal"
    BICAUSAL = "bi_causal"
    INVCAUSAL = "inv_causal"

    @classmethod
    def from_int_type(cls, int_type: int) -> "AttnMaskType":
        return _INT_TO_MASK_TYPE[int_type]

    def to_int_type(self) -> int:
        return _MASK_TYPE_TO_INT[self]

    @classmethod
    def normalize(cls, value: "AttnMaskType | str | int") -> "AttnMaskType":
        """Accept enum / str / int forms uniformly (numpy integer scalars
        included: mask metadata often arrives as int32 arrays)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, int) or (
            hasattr(value, "__index__") and not isinstance(value, str)
        ):
            return cls.from_int_type(int(value))
        return cls(value)


_INT_TO_MASK_TYPE = {
    0: AttnMaskType.FULL,
    1: AttnMaskType.CAUSAL,
    2: AttnMaskType.INVCAUSAL,
    3: AttnMaskType.BICAUSAL,
}
_MASK_TYPE_TO_INT = {v: k for k, v in _INT_TO_MASK_TYPE.items()}
