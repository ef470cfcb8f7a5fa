"""Host-side work accounting shared by the telemetry call sites.

``band_area`` is the TRUE score-matrix element count of a band-slice set —
the numerator of every padding-efficiency figure (the FFA planner's padded
grid work is the denominator), and the base of estimated-FLOP numbers
(fwd flops = 4 * area * head_dim * num_heads_q, the FlashAttention-2
convention). The port's copy of ``magiattention_tpu/telemetry/stats.py``.
"""

from __future__ import annotations

import numpy as np


def band_area(
    qr: np.ndarray, kr: np.ndarray, d_lo: np.ndarray, d_hi: np.ndarray
) -> int:
    """Exact (i, j) pair count of band slices: rows i in [qs, qe), cols j in
    [ks, ke) with lo <= j - i <= hi. Vectorized per slice over rows."""
    total = 0
    for s in range(len(qr)):
        qs, qe = int(qr[s, 0]), int(qr[s, 1])
        ks, ke = int(kr[s, 0]), int(kr[s, 1])
        lo, hi = int(d_lo[s]), int(d_hi[s])
        if qs >= qe or ks >= ke or lo > hi:
            continue
        i = np.arange(qs, qe, dtype=np.int64)
        j0 = np.maximum(ks, i + lo)
        j1 = np.minimum(ke - 1, i + hi)
        total += int(np.maximum(j1 - j0 + 1, 0).sum())
    return total
