"""API helper functions (the port's copy of
``magiattention_tpu/api/functools.py``; ref: magi_attention/api/functools.py).

The mask compilers that ``magi_attn_varlen_key`` calls (cu_seqlens ->
slices :335, sliding-window -> slices :180). Pure host code. The padding
and batch-packing helpers are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Sequence

from ..common.enum import AttnMaskType
from ..common.ranges import AttnRanges


def infer_attn_mask_from_cu_seqlens(
    cu_seqlens_q: Sequence[int],
    cu_seqlens_k: Sequence[int] | None = None,
    causal: bool = True,
    window_size: tuple[int, int] = (-1, -1),
    global_window_size: int = 0,
) -> tuple[AttnRanges, AttnRanges, list[AttnMaskType]]:
    """Varlen (packed segments) mask -> slice metadata (ref :335).

    With the default ``window_size=(-1, -1)`` each segment gets a plain
    FULL/CAUSAL mask. A bounded window compiles per-segment sliding
    windows (requires ``causal=False``, as in the reference :387-390 —
    a causal window is expressed as ``(left, 0)``), optionally with
    ``global_window_size`` leading key tokens per segment that every
    query attends to. Global-token semantics follow the reference
    (:399-470): a query at in-segment position ``i`` sees global keys
    ``[0, min(G, i + right_window + 1))`` — early queries see fewer, so
    no information leaks past the right window boundary — and its
    sliding window runs over the remaining keys (end-aligned; queries
    above the end-aligned square keep their right-window reach into the
    local keys, the reference's part-3 blocks).
    """
    q_ranges = AttnRanges.from_cu_seqlens(list(cu_seqlens_q))
    k_ranges = (
        AttnRanges.from_cu_seqlens(list(cu_seqlens_k))
        if cu_seqlens_k is not None
        else AttnRanges.from_ranges(q_ranges.to_naive_ranges())
    )
    if len(q_ranges) != len(k_ranges):
        raise ValueError("cu_seqlens_q and cu_seqlens_k imply different counts")
    if global_window_size < 0:
        raise ValueError("global_window_size must be non-negative")
    if tuple(window_size) == (-1, -1):
        # global_window_size is only effective with a bounded window —
        # the reference's documented contract (ref :360-361); with no
        # window every query already reaches the leading keys its mask
        # type allows
        t = AttnMaskType.CAUSAL if causal else AttnMaskType.FULL
        return q_ranges, k_ranges, [t] * len(q_ranges)
    if causal:
        raise ValueError(
            "causal must be False when window_size is not (-1, -1) — "
            "express a causal window as (left, 0) (ref functools.py:387)"
        )
    if global_window_size == 0:
        # pure windows: one batched compile over all segments
        return infer_attn_mask_from_sliding_window(
            q_ranges, k_ranges,
            [AttnMaskType.FULL] * len(q_ranges), window_size,
        )

    left, right = window_size
    out_q, out_k, out_t = AttnRanges(), AttnRanges(), []

    def emit(qs, qe, ks, ke, t):
        if qs < qe and ks < ke:
            from ..common.range import AttnRange

            out_q.append(AttnRange(qs, qe))
            out_k.append(AttnRange(ks, ke))
            out_t.append(t)

    for qr, kr in zip(q_ranges, k_ranges):
        qs, qe, ks, ke = qr.start, qr.end, kr.start, kr.end
        qlen, klen = qe - qs, ke - ks
        if qlen <= 0 or klen <= 0:
            continue
        g = min(global_window_size, klen)
        # global part: constrained early queries (CAUSAL over the strip,
        # right edge at i + rw), then FULL over all g global keys
        rw_eff = right if (right != -1 and right < klen - 1) else klen
        constrained = min(max(0, g - rw_eff - 1), qlen)
        emit(qs, qs + constrained, ks, ks + constrained + rw_eff,
             AttnMaskType.CAUSAL)
        emit(qs + constrained, qe, ks, ks + g, AttnMaskType.FULL)
        # local part: the window band over the non-global keys, with NO
        # invalid-row drop — the band's natural validity keeps every
        # query whose right window reaches a local key (parts 2 + 3 of
        # the reference composition in one exact decomposition). The
        # clamp uses the FULL key length: the reference's part-3 blocks
        # apply the literal right window to the dropped rows (its
        # oracle: tests/test_api/test_functools.py:133-185), so a
        # local-length re-clamp would overreach there.
        lklen = klen - g
        if lklen <= 0:
            continue
        lw_l = left if (left != -1 and left < klen - 1) else klen
        rw_l = right if (right != -1 and right < klen - 1) else klen
        diag_c = ke - qe
        _compile_band(qs, qe, ks + g, ke, diag_c - lw_l, diag_c + rw_l,
                      emit)
    return out_q, out_k, out_t


def _compile_band(qs, qe, ks, ke, lo, hi, emit):
    """Exact disjoint slices of the diagonal band ``lo <= c - q <= hi``
    intersected with the rectangle ``[qs, qe) x [ks, ke)``.

    Rows are split by which band edge the rectangle clips, so each region
    is EXACTLY one of the four mask types (the types bound the band at
    range corners — kernels/mask_utils.types_to_bands):

    - left edge clipped at ks, right inside      -> CAUSAL   (hi at end)
    - both edges inside                          -> BICAUSAL (lo, hi)
    - both edges clipped (wide band, narrow k)   -> FULL
    - left inside, right clipped at ke           -> INVCAUSAL (lo at start)
    """
    if qs >= qe or ks >= ke or lo > hi:
        return
    q0 = max(qs, ks - hi)       # first row with any in-range column
    q1 = min(qe, ke - lo)       # one past the last such row
    if q0 >= q1:
        return
    a = ks - lo                 # first row whose left edge clears ks
    b = ke - 1 - hi             # first row whose right edge reaches ke-1
    lo_edge, hi_edge = min(a, b), max(a, b)

    u, v = q0, min(max(lo_edge, q0), q1)
    emit(u, v, ks, v + hi, AttnMaskType.CAUSAL)
    u, v = min(max(lo_edge, q0), q1), min(max(hi_edge, q0), q1)
    if a <= b:
        emit(u, v, u + lo, v + hi, AttnMaskType.BICAUSAL)
    else:
        emit(u, v, ks, ke, AttnMaskType.FULL)
    u, v = min(max(hi_edge, q0), q1), q1
    emit(u, v, u + lo, ke, AttnMaskType.INVCAUSAL)


def infer_attn_mask_from_sliding_window(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    attn_mask_type: list[AttnMaskType],
    window_size: tuple[int, int],
    sink_size: int = 0,
) -> tuple[AttnRanges, AttnRanges, list[AttnMaskType]]:
    """Compile per-segment sliding windows into slices (ref :180).

    Segments may be cross-shaped — any (q_range, k_range) pair, including
    seqlen mismatch — of any mask type. The window rides the END-aligned
    diagonal ``c - q = k_end - q_end`` (the reference's convention, ref
    functools.py:216-225: when q is longer than k, rows above the
    end-aligned square are invalid and dropped), and the segment's own
    mask type intersects as a band bound: CAUSAL caps the right edge at
    the diagonal, INVCAUSAL floors the left edge at the START-aligned
    diagonal ``c - q = k_start - q_start``, BICAUSAL does both.

    Args:
        q_ranges/k_ranges/attn_mask_type: one entry per segment.
        window_size: (left, right) window radius around the end-aligned
            diagonal; -1 means unbounded on that side. Fully unbounded
            (-1, -1) with no sink is vacuous for FULL/INVCAUSAL segments:
            the segment's own mask is returned un-windowed (the reference
            short-circuits this case before its helper,
            ref functools.py:370-385).
        sink_size: keys at the start of each segment's k range that every
            query attends to (FULL/CAUSAL segments only): rows whose
            diagonal falls inside the sink strip attend causally within
            it; later rows see the whole strip plus their window clipped
            to start after it.

    Returns:
        Decomposed (q_ranges, k_ranges, attn_mask_type) slice metadata —
        disjoint slices (overlap would double-count in the kernel softmax).
    """
    out_q, out_k, out_t = AttnRanges(), AttnRanges(), []

    def emit(qs, qe, ks, ke, t):
        if qs < qe and ks < ke:
            from ..common.range import AttnRange

            out_q.append(AttnRange(qs, qe))
            out_k.append(AttnRange(ks, ke))
            out_t.append(t)

    left, right = window_size
    for qr, kr, mt in zip(q_ranges, k_ranges, attn_mask_type):
        qs, qe, ks, ke = qr.start, qr.end, kr.start, kr.end
        qlen, klen = qe - qs, ke - ks
        if qlen <= 0 or klen <= 0:
            continue
        snk = min(sink_size, klen) if sink_size > 0 else 0
        if snk and mt not in (AttnMaskType.FULL, AttnMaskType.CAUSAL):
            raise NotImplementedError(
                f"sink_size over {mt} segments is contradictory (the sink "
                "strip violates the start-aligned lower bound)"
            )
        diag_c = ke - qe  # end-aligned diagonal offset (c - q on it)
        # reference clamp (functools.py:227-237): -1 or >= klen-1 means
        # unbounded; klen guarantees the edge clears the rectangle
        lw = left if (left != -1 and left < klen - 1) else klen
        rw = right if (right != -1 and right < klen - 1) else klen
        lo, hi = diag_c - lw, diag_c + rw
        if mt in (AttnMaskType.CAUSAL, AttnMaskType.BICAUSAL):
            hi = min(hi, diag_c)
        if mt in (AttnMaskType.INVCAUSAL, AttnMaskType.BICAUSAL):
            lo = max(lo, ks - qs)
        # the reference's invalid-row drop: an active window keeps only
        # rows whose end-aligned diagonal is inside the k range. CAUSAL /
        # BICAUSAL bands imply it already; a fully-unbounded windowless
        # call must stay the identity on FULL/INVCAUSAL segments.
        vacuous = left == -1 and right == -1 and snk == 0
        qv0 = qs if vacuous else max(qs, qe - klen)
        if snk:
            # rows with diagonal inside the sink strip: causal within it
            q_snk = min(qe, max(ks + snk - diag_c, qv0))
            emit(qv0, q_snk, ks, q_snk + diag_c, AttnMaskType.CAUSAL)
            # every later row sees the whole strip...
            emit(q_snk, qe, ks, ks + snk, AttnMaskType.FULL)
            # ...plus its window, clipped to start after the strip
            _compile_band(q_snk, qe, ks + snk, ke, lo, hi, emit)
        else:
            _compile_band(qv0, qe, ks, ke, lo, hi, emit)
    return out_q, out_k, out_t

