"""Slice metadata -> diagonal bands, band merging, dense masks.

The port's copy of ``magiattention_tpu/kernels/mask_utils.py``. Public
metadata is ``q_ranges (N,2) int32``, ``k_ranges (N,2) int32``,
``attn_type_map (N,) int32`` with 0=FULL, 1=CAUSAL, 2=INVCAUSAL, 3=BICAUSAL.

Internally every slice is an explicit diagonal band ``d_lo <= j - i <= d_hi``
in global coordinates: types only bound the band at construction time, after
which clipping a slice in q or k never changes the band. Empty slices
(``q_start >= q_end``) are padding and contribute nothing.
"""

from __future__ import annotations

import numpy as np
import torch

# sentinel band bound: wide enough to be unbounded for any real seqlen,
# small enough that int32 arithmetic with coordinates cannot overflow
BAND_INF = 1 << 30


def types_to_bands(q_ranges, k_ranges, attn_type_map):
    """(q_range, k_range, mask_type) -> diagonal band bounds (numpy).

    Geometry (d = j - i, global coords):
      CAUSAL:    d <= k_end - q_end      (bottom-right aligned)
      INVCAUSAL: d >= k_start - q_start  (top-left aligned)
      BICAUSAL:  both;  FULL: unbounded.

    Returns ``(d_lo, d_hi)`` int32 arrays of shape (N,).
    """
    qr = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    t = np.asarray(attn_type_map)
    is_causal = (t == 1) | (t == 3)
    is_inv = (t == 2) | (t == 3)
    d_hi = np.where(is_causal, kr[:, 1] - qr[:, 1], BAND_INF).astype(np.int32)
    d_lo = np.where(is_inv, kr[:, 0] - qr[:, 0], -BAND_INF).astype(np.int32)
    return d_lo, d_hi


def merge_band_slices(q_ranges, k_ranges, d_lo, d_hi):
    """Merge band-compatible adjacent slices (host numpy, exact).

    Bands are global-coordinate, so two rectangles with the SAME band whose
    k ranges are adjacent (or whose q ranges are adjacent, at equal k) union
    to one rectangle with that band: the merged slice covers exactly the
    same (i, j) pairs, while fragmented masks collapse into fewer work items.

    Empty slices are dropped. Returns ``(q_ranges, k_ranges, d_lo, d_hi)``
    int32 arrays with at least one row: if every input slice was empty, a
    single all-zero empty slice is synthesized.
    """
    qr = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    lo = np.asarray(d_lo, dtype=np.int64).reshape(-1)
    hi = np.asarray(d_hi, dtype=np.int64).reshape(-1)

    keep = (qr[:, 0] < qr[:, 1]) & (kr[:, 0] < kr[:, 1])
    if not keep.any():
        empty = np.zeros((1, 2), np.int32)
        return (
            empty, empty.copy(),
            np.zeros(1, np.int32), np.zeros(1, np.int32),
        )
    rows = np.concatenate(
        [qr[keep], kr[keep], lo[keep, None], hi[keep, None]], axis=1
    )  # (n, 6): q0 q1 k0 k1 lo hi

    def sweep(rows, key_cols, adj_lo, adj_hi):
        """Sort by key_cols then merge maximal chains where all key_cols
        match and each row's [adj_lo] equals its predecessor's [adj_hi];
        the merged row spans [first.adj_lo, last.adj_hi)."""
        order = np.lexsort(
            tuple(rows[:, c] for c in reversed(key_cols + [adj_lo]))
        )
        r = rows[order]
        n = len(r)
        start = np.ones(n, dtype=bool)
        if n > 1:
            same_key = np.ones(n - 1, dtype=bool)
            for c in key_cols:
                same_key &= r[1:, c] == r[:-1, c]
            start[1:] = ~(same_key & (r[1:, adj_lo] == r[:-1, adj_hi]))
        out = r[start].copy()
        starts = np.nonzero(start)[0]
        last = np.append(starts[1:] - 1, n - 1)
        out[:, adj_hi] = r[last, adj_hi]
        return out

    prev_n = -1
    while rows.shape[0] != prev_n:
        prev_n = rows.shape[0]
        # k-direction: same (q range, band), k-adjacent
        rows = sweep(rows, [0, 1, 4, 5], adj_lo=2, adj_hi=3)
        # q-direction: same (k range, band), q-adjacent
        rows = sweep(rows, [2, 3, 4, 5], adj_lo=0, adj_hi=1)
    return (
        rows[:, 0:2].astype(np.int32),
        rows[:, 2:4].astype(np.int32),
        rows[:, 4].astype(np.int32),
        rows[:, 5].astype(np.int32),
    )


def build_dense_mask_band(
    q_ranges,
    k_ranges,
    d_lo,
    d_hi,
    seqlen_q: int,
    seqlen_k: int,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """The ``(seqlen_q, seqlen_k)`` boolean mask of the band slices, built
    on ``device`` (one broadcast compare per slice: testing and plain
    versions only; the kernels never materialize it)."""
    qr = np.asarray(q_ranges, dtype=np.int64).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int64).reshape(-1, 2)
    lo = np.asarray(d_lo, dtype=np.int64).reshape(-1)
    hi = np.asarray(d_hi, dtype=np.int64).reshape(-1)
    i = torch.arange(seqlen_q, device=device, dtype=torch.int64)[:, None]
    j = torch.arange(seqlen_k, device=device, dtype=torch.int64)[None, :]
    mask = torch.zeros((seqlen_q, seqlen_k), dtype=torch.bool, device=device)
    for s in range(len(qr)):
        (q0, q1), (k0, k1) = qr[s], kr[s]
        if q0 >= q1 or k0 >= k1 or lo[s] > hi[s]:
            continue
        d = j[:, k0:k1] - i[q0:q1]
        mask[q0:q1, k0:k1] |= (d >= int(lo[s])) & (d <= int(hi[s]))
    return mask
