"""Materializable 2-D attention mask built from slice metadata.

The port's copy of ``magiattention_tpu/common/mask.py`` (numpy only, imports
rewired).

Testing / solver aid (ref: magi_attention/common/mask.py:29-472). Materializes
the boolean mask implied by ``(q_ranges, k_ranges, attn_mask_type)`` on the
host with numpy; never used on the device path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .enum import AttnMaskType
from .range import AttnRange
from .ranges import AttnRanges


def make_causal_mask(
    seqlen_q: int, seqlen_k: int, align: str = "bottom-right", dtype=np.bool_
) -> np.ndarray:
    """Tril mask aligned to the requested corner of the (seqlen_q, seqlen_k) box."""
    m = max(seqlen_q, seqlen_k)
    tril = np.tril(np.ones((m, m), dtype=dtype))
    if align == "bottom-right":
        return tril[m - seqlen_q :, m - seqlen_k :]
    elif align == "top-left":
        return tril[:seqlen_q, :seqlen_k]
    raise ValueError(f"invalid alignment mode: {align}")


def slice_mask_block(
    q_range: AttnRange, k_range: AttnRange, mask_type: AttnMaskType
) -> np.ndarray:
    """The (q_range.seqlen, k_range.seqlen) boolean mask of one slice.

    Geometry (d = j - i in global coords):
      CAUSAL:    j - i <= k_range.end - q_range.end     (bottom-right aligned)
      INVCAUSAL: j - i >= k_range.start - q_range.start (top-left aligned)
      BICAUSAL:  both
    """
    sq, sk = q_range.seqlen, k_range.seqlen
    i = np.arange(q_range.start, q_range.end)[:, None]
    j = np.arange(k_range.start, k_range.end)[None, :]
    d = j - i
    if mask_type == AttnMaskType.FULL:
        return np.ones((sq, sk), dtype=np.bool_)
    if mask_type == AttnMaskType.CAUSAL:
        return d <= (k_range.end - q_range.end)
    if mask_type == AttnMaskType.INVCAUSAL:
        return d >= (k_range.start - q_range.start)
    if mask_type == AttnMaskType.BICAUSAL:
        return (d <= (k_range.end - q_range.end)) & (
            d >= (k_range.start - q_range.start)
        )
    raise ValueError(f"invalid mask type: {mask_type}")


def slice_area(q_range: AttnRange, k_range: AttnRange, mask_type: AttnMaskType) -> int:
    """Number of unmasked (q, k) pairs of one slice, in closed form."""
    sq, sk = q_range.seqlen, k_range.seqlen
    if sq == 0 or sk == 0:
        return 0
    if mask_type == AttnMaskType.FULL:
        return sq * sk

    def tri_causal(sq: int, sk: int) -> int:
        # bottom-right aligned causal area
        if sk >= sq:
            return sq * sk - sq * (sq - 1) // 2
        # top rows of the box are fully masked
        return sk * (sk + 1) // 2

    if mask_type == AttnMaskType.CAUSAL:
        return tri_causal(sq, sk)
    if mask_type == AttnMaskType.INVCAUSAL:
        # top-left aligned inv-causal == transpose-symmetric of causal
        return tri_causal(sq, sk)
    if mask_type == AttnMaskType.BICAUSAL:
        # band: rows each see [row_lo, row_hi] where width = sk - sq + 1 if sk>=sq
        if sk >= sq:
            return sq * (sk - sq + 1)
        return 0  # d_range empty: no valid band
    raise ValueError(f"invalid mask type: {mask_type}")


class AttnMask:
    """A materialized attention mask with slice metadata attached."""

    def __init__(
        self,
        mask_array: np.ndarray,
        q_ranges: AttnRanges,
        k_ranges: AttnRanges,
        attn_mask_type: list[AttnMaskType],
        total_seqlen_q: int,
        total_seqlen_k: int,
    ) -> None:
        self.mask_array = mask_array
        self.q_ranges = q_ranges
        self.k_ranges = k_ranges
        self.attn_mask_type = attn_mask_type
        self.total_seqlen_q = total_seqlen_q
        self.total_seqlen_k = total_seqlen_k

    @classmethod
    def from_ranges(
        cls,
        q_ranges: AttnRanges,
        k_ranges: AttnRanges,
        attn_mask_type: Sequence[AttnMaskType | str | int],
        total_seqlen_q: int | None = None,
        total_seqlen_k: int | None = None,
    ) -> "AttnMask":
        if not (len(q_ranges) == len(k_ranges) == len(attn_mask_type)):
            raise ValueError(
                f"length mismatch: {len(q_ranges)=} {len(k_ranges)=} "
                f"{len(attn_mask_type)=}"
            )
        mask_types = [AttnMaskType.normalize(t) for t in attn_mask_type]
        tq = total_seqlen_q if total_seqlen_q is not None else q_ranges.end
        tk = total_seqlen_k if total_seqlen_k is not None else k_ranges.end
        mask = np.zeros((tq, tk), dtype=np.bool_)
        for qr, kr, mt in zip(q_ranges, k_ranges, mask_types):
            mask[qr.start : qr.end, kr.start : kr.end] |= slice_mask_block(qr, kr, mt)
        return cls(mask, q_ranges, k_ranges, mask_types, tq, tk)

    @property
    def area(self) -> int:
        return int(self.mask_array.sum())

    def make_sub_mask(self, q_range: AttnRange, k_range: AttnRange) -> np.ndarray:
        return self.mask_array[q_range.start : q_range.end, k_range.start : k_range.end]

    def is_pure_causal(self) -> bool:
        expected = make_causal_mask(self.total_seqlen_q, self.total_seqlen_k)
        return bool((self.mask_array == expected).all())

    def is_empty(self) -> bool:
        return not self.mask_array.any()

    def __eq__(self, other) -> bool:
        if isinstance(other, AttnMask):
            return (
                self.mask_array.shape == other.mask_array.shape
                and bool((self.mask_array == other.mask_array).all())
            )
        return NotImplemented

    def __repr__(self) -> str:
        return (
            f"AttnMask(q={self.total_seqlen_q}, k={self.total_seqlen_k}, "
            f"area={self.area}, n_slices={len(self.q_ranges)})"
        )

    def visualize(
        self,
        path: str | None = None,
        max_cells: int = 64,
        rank_of_row: np.ndarray | None = None,
    ) -> str:
        """Render the mask (ref common/mask.py:430 AttnMask.visualize).

        Returns an ASCII rendering downsampled to at most ``max_cells`` per
        side; when ``path`` is given, additionally writes a PNG (matplotlib,
        best-effort). ``rank_of_row`` (optional, (total_seqlen_q,) int) tints
        rows by owning CP rank — the dispatch-assignment view (ref
        dynamic_solver_vis.py).
        """
        m = self.mask_array
        sq, sk = m.shape
        fq = max(1, -(-sq // max_cells))
        fk = max(1, -(-sk // max_cells))
        nq, nk = -(-sq // fq), -(-sk // fk)
        pad = np.zeros((nq * fq, nk * fk), dtype=np.float32)
        pad[:sq, :sk] = m
        cells = pad.reshape(nq, fq, nk, fk).mean(axis=(1, 3))
        shades = " .:#"
        lines = []
        for i in range(nq):
            row = "".join(
                shades[min(int(c * (len(shades) - 1) + 0.999), len(shades) - 1)]
                for c in cells[i]
            )
            if rank_of_row is not None:
                r = int(rank_of_row[min(i * fq, sq - 1)])
                row += f"  r{r}"
            lines.append(row)
        text = "\n".join(lines)
        if path is not None:
            try:  # pragma: no cover - depends on matplotlib backend
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                fig, ax = plt.subplots(figsize=(6, 6))
                if rank_of_row is not None:
                    img = np.where(
                        m,
                        rank_of_row[:, None].astype(np.float32) + 1.0,
                        np.nan,
                    )
                    ax.imshow(img, aspect="auto", interpolation="nearest",
                              cmap="tab20")
                else:
                    ax.imshow(m, aspect="auto", interpolation="nearest",
                              cmap="Greys")
                ax.set_xlabel("k")
                ax.set_ylabel("q")
                ax.set_title(repr(self))
                fig.savefig(path, dpi=120, bbox_inches="tight")
                plt.close(fig)
            except Exception:
                pass
        return text
