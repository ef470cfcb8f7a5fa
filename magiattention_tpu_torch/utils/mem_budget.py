"""Shared memory of one CTA of each FFA kernel, for Hopper.

The port's counterpart of ``magiattention_tpu/utils/mem_budget.py``
(``ffa_vmem_budget``, ``ffa_bwd_vmem_budget``): the JAX package guards its
tiles with the VMEM one grid step keeps resident; here the guard is the
dynamic shared memory one CTA takes, per (kernel, dtype, head dim, q tile,
k tile), against the card's per-CTA opt-in limit. Each formula is the
``Smem`` struct of the kernel's body in ``csrc/`` written out on the host,
so the CPU tests can run it; ``chip_smoke.py`` (phase ``tiles``) holds it
equal to each library's ``<name>_smem_bytes`` export for every instance
and prints the limit the device reports.

Kernels: ``fwd`` (B1, ``csrc/ffa_fwd.cu``), ``fwd_gqa`` (B2), ``dq`` (B3),
``dq_gqa`` (B4), ``dkv`` (B5/B6) and ``fused`` (B8/B9). ``itemsize`` 2 is
bf16 (the tensor-core bodies), 4 float32 (the 3xTF32 forward; the
CUDA-core backward bodies, compiled at 64 x 64 only).
"""

from __future__ import annotations

from ..kernels.head_dims import KERNEL_HEAD_DIMS, SPLIT_WIDTH, cta_width

# the dynamic shared memory one CTA may opt into on an H100 (sm_90): 227 KB
SMEM_PER_CTA = 232_448
# the shared memory of one SM, of which each resident CTA also reserves 1 KB
SMEM_PER_SM = 233_472
# the (q tile, k tile) rows the FFA kernels are instantiated at
# (csrc/common.cuh MAGI_FFA_TILES); a pair is compiled where its CTA fits
TILE_PAIRS = ((64, 64), (128, 64), (64, 128), (128, 128))
# the default pair, the one every kernel and dtype has
DEFAULT_TILES = (64, 64)
KERNELS = ("fwd", "fwd_gqa", "dq", "dq_gqa", "dkv", "fused")
# the packed kernels' (head dim, heads a CTA, k tile) instances
# (csrc/ffa_fwd_gqa.cu MAGI_FWD_GQA / _F32, csrc/ffa_bwd_dq_gqa.cu), all at
# 64-row q tiles; the float32 dq body at 64 x 64
PACKED_INSTANCES = {
    ("fwd_gqa", 2): {(64, 2, 64), (64, 2, 128), (64, 4, 64), (128, 2, 64),
                     (128, 2, 128), (256, 2, 64), (256, 2, 128)},
    ("fwd_gqa", 4): {(64, 2, 64), (64, 2, 128), (128, 2, 64), (128, 2, 128)},
    ("dq_gqa", 2): {(64, 2, 64), (64, 2, 128), (128, 2, 64), (128, 2, 128)},
    ("dq_gqa", 4): {(64, 2, 64), (64, 4, 64), (128, 2, 64)},
}
# one float32 64-row P / dS tile at row stride 80 (the CUDA-core bodies)
P_TILE_FLOATS = 64 * 80


def _tile_floats(d: int) -> int:
    """One 64-row float32 operand tile at row stride d + 4."""
    return 64 * (d + 4)


def warpgroups(kernel: str, bq: int = 64, bk: int = 64, heads: int = 1) -> int:
    """Consumer warpgroups of one tensor-core CTA: one a head (packed) or a
    64-row half of the q tile (q-major kernels), one a 64-row block of the
    k tile (k-major kernels)."""
    if kernel in ("dkv", "fused"):
        return bk // 64
    return heads * (bq // 64)


def fwd_smem_bytes(d: int, bq: int = 64, bk: int = 64, itemsize: int = 2, heads: int = 1) -> int:
    """One forward CTA (B1, or B2 with ``heads``). bfloat16
    (csrc/ffa_fwd_tc.cuh ``Smem``): a 64-row q tile per warpgroup and two
    stages of the k tile's K and V (V the 128-column half at d = 256), 16
    bytes a warpgroup for the max-logits reduction and 1024 to align the
    window. float32 (csrc/ffa_fwd_tf32.cuh ``Smem``): a q tile per
    warpgroup in tf32 hi and lo, the raw 32-key K and V chunk (none at d =
    256) and two stages of its split tiles where they fit, else one; it
    does not depend on the k tile (an item is walked in 32-key chunks)."""
    wg, w = warpgroups("fwd", bq, bk, heads), cta_width(d)
    if itemsize == 2:
        return wg * 64 * d * 2 + 2 * bk * (d + w) * 2 + 16 * wg + 1024
    raw = 128 * (d + w) if d <= SPLIT_WIDTH else 0
    fixed = 512 * wg * d + raw + 16 * wg + 1024
    stage = 256 * (d + w)
    two_stages = fixed + 2 * stage
    return two_stages if two_stages <= SMEM_PER_CTA else fixed + stage


def dq_smem_bytes(d: int, bq: int = 64, bk: int = 64, itemsize: int = 2, heads: int = 1) -> int:
    """One dq CTA (B3, or B4 with ``heads``). bfloat16
    (csrc/ffa_bwd_dq_tc.cuh ``Smem``): a Q and a dO tile per warpgroup and
    two stages of the k tile's K and V, and 1024 bytes to align the window.
    float32 (csrc/ffa_bwd_dq.cuh ``DqSmem``, 64 x 64): the heads' q and dO
    tiles, the k and v tiles, the dS tile (at d = 256 the contraction's
    128-column chunks)."""
    if itemsize == 2:
        wg = warpgroups("dq", bq, bk, heads)
        return 2 * wg * 64 * d * 2 + 4 * bk * d * 2 + 1024
    return 4 * ((2 * heads + 2) * _tile_floats(cta_width(d)) + P_TILE_FLOATS)


def dkv_smem_bytes(d: int, bq: int = 64, bk: int = 64, itemsize: int = 2, fused: bool = False) -> int:
    """One dk/dv CTA (B5/B6), or with ``fused`` one fused-backward CTA
    (B8/B9). bfloat16 (csrc/bwd_kv_tc.cuh ``Smem``): K and V per
    warpgroup (64 key rows each), two stages of the q tile's Q and dO and
    of its lse and delta, with ``fused`` a 64 x 64 bf16 dS^T tile per
    warpgroup, and 1024 bytes to align the window. float32
    (csrc/bwd_kv.cuh ``DkvSmem``, 64 x 64, the same with fused): K, V, Q
    and dO at row stride d + 4, the P^T and dS^T tiles, the q tile's lse and
    delta."""
    if itemsize == 2:
        wg = warpgroups("dkv", bq, bk)
        ds = wg * 64 * 64 * 2 if fused else 0
        return wg * 2 * 64 * d * 2 + 4 * bq * d * 2 + ds + 2 * 2 * bq * 4 + 1024
    return 4 * (4 * _tile_floats(cta_width(d)) + 2 * P_TILE_FLOATS + 2 * 64)


def ffa_smem_bytes(kernel: str, d: int, bq: int = 64, bk: int = 64, itemsize: int = 2, heads: int = 1) -> int:
    """The shared memory one CTA of ``kernel`` takes at these tiles."""
    if kernel in ("fwd", "fwd_gqa"):
        return fwd_smem_bytes(d, bq, bk, itemsize, heads)
    if kernel in ("dq", "dq_gqa"):
        return dq_smem_bytes(d, bq, bk, itemsize, heads)
    if kernel in ("dkv", "fused"):
        return dkv_smem_bytes(d, bq, bk, itemsize, fused=kernel == "fused")
    raise ValueError(f"unknown FFA kernel {kernel!r} (one of {KERNELS})")


def compiled_tiles(kernel: str, itemsize: int, d: int, heads: int = 1) -> tuple[tuple[int, int], ...]:
    """The (q tile, k tile) pairs ``kernel`` is compiled for at this dtype
    (``itemsize``), head dim and, for the packed kernels, heads a CTA: the
    pairs of :data:`TILE_PAIRS` whose CTA fits :data:`SMEM_PER_CTA`,
    where the body takes them. The float32 backward bodies (CUDA cores)
    are 64 x 64 only; the packed kernels take 64-row q tiles only (a
    128-row tile's two warpgroups are its halves) at their listed
    instances (:data:`PACKED_INSTANCES`). Empty for a head dim with no
    kernel."""
    if d not in KERNEL_HEAD_DIMS:
        return ()
    if kernel.endswith("_gqa"):
        inst = PACKED_INSTANCES[(kernel, itemsize)]
        return tuple(
            (64, bk) for bk in (64, 128)
            if (d, heads, bk) in inst
            and ffa_smem_bytes(kernel, d, 64, bk, itemsize, heads) <= SMEM_PER_CTA
        )
    if itemsize == 4 and kernel in ("dq", "dkv", "fused"):
        return (DEFAULT_TILES,)
    if kernel not in KERNELS:
        raise ValueError(f"unknown FFA kernel {kernel!r} (one of {KERNELS})")
    return tuple(
        (bq, bk) for bq, bk in TILE_PAIRS
        if ffa_smem_bytes(kernel, d, bq, bk, itemsize) <= SMEM_PER_CTA
    )


def is_compiled(kernel: str, itemsize: int, d: int, bq: int, bk: int, heads: int = 1) -> bool:
    return (bq, bk) in compiled_tiles(kernel, itemsize, d, heads)


def ctas_per_sm(kernel: str, d: int, bq: int = 64, bk: int = 64, heads: int = 1) -> int:
    """CTAs of a tensor-core kernel one SM holds at once: as many as its
    shared memory allows (each reserving 1 KB more), at most two (the
    register file: a warpgroup's thread keeps up to 255 registers), one
    when the CTA runs two warpgroups or more."""
    by_smem = SMEM_PER_SM // (ffa_smem_bytes(kernel, d, bq, bk, 2, heads) + 1024)
    return max(1, min(by_smem, 2 // warpgroups(kernel, bq, bk, heads)))


# -- the decode (B10-B12) and block-sparse (B13/B14) libraries ---------------

# the decode walk's constants (csrc/paged_decode.cuh): threads, tokens a
# chunk, chunk stages; its row instances (RMAX) a library takes
DECODE_THREADS, DECODE_CHUNK, DECODE_STAGES = 256, 32, 2
DECODE_ROWS = {"paged_decode": (8,), "paged_decode_int8": (8,), "paged_decode_spec": (8, 16, 32)}
# the block-sparse tile (csrc/block_sparse.cuh): query rows, gathered keys
BSP_ROWS = BSP_KEYS = 64


def decode_smem_bytes(d: int, page_itemsize: int, rmax: int = 8) -> int:
    """One decode walk CTA (csrc/paged_decode.cuh ``Smem<TP, D, RMAX>``):
    the q rows (float32) and four arrays a row, then the larger of the
    walk (two stages of a 32-token K chunk at row stride d + 16 bytes and a
    V chunk, raw pages of ``page_itemsize`` bytes; the scores; with int8
    pages each stage's K and V scales) and the token-group reduction that
    reuses it. 0 for a head dim with no instance."""
    if d not in KERNEL_HEAD_DIMS:
        return 0
    quant = page_itemsize == 1
    ds = d + 16 // page_itemsize
    kch, vch = DECODE_CHUNK * ds, DECODE_CHUNK * d
    nsl = 8 if d > 128 else 4
    scr = max(nsl * rmax * DECODE_CHUNK, DECODE_CHUNK * (rmax + 4))
    scales = 2 * DECODE_STAGES * DECODE_CHUNK if quant else 0
    cpt = 1 if rmax >= 32 else 2
    groups = DECODE_THREADS // (d // cpt)
    walk = page_itemsize * DECODE_STAGES * (kch + vch) + 4 * (scr + scales)
    red = 4 * (groups // 2) * rmax * d
    return 4 * (rmax * d + 4 * rmax) + max(walk, red)


def decode_rmax(rows: int) -> int:
    """The row instance the spec library launches for ``rows`` query rows
    (0 above 32: no instance)."""
    return next((r for r in (8, 16, 32) if rows <= r), 0)


def block_sparse_smem_bytes(kind: str, d: int, itemsize: int) -> int:
    """One block-sparse CTA: ``kind`` "fwd" (B13), "dq" or "dkv" (B14's two
    walks). bfloat16 (csrc/block_sparse_tc.cuh ``FwdSmem`` / ``DqSmem`` /
    ``DkvSmem``): 64-row bf16 tiles (V and the outputs a 128-column half at
    d = 256) in two stages, the walks' float32 row statistics, 1024 bytes
    to align the window. float32 (``BspFwdSmem``, csrc/block_sparse_bwd.cu
    ``DqSmemF32`` / ``DkvSmemF32``): tiles at row stride (width + 4), the
    probability / dS tiles at row stride 80, row statistics and the
    gathered key rows' indices. 0 for a head dim with no instance."""
    if d not in KERNEL_HEAD_DIMS:
        return 0
    dv = min(d, SPLIT_WIDTH)
    rows, keys, pstr = BSP_ROWS, BSP_KEYS, BSP_ROWS + 16
    if itemsize == 2:
        tile = 64 * d * 2
        if kind == "fwd":
            return tile + 2 * (tile + 64 * dv * 2) + 1024
        if kind == "dq":
            return 6 * tile + 1024
        if kind == "dkv":
            return 6 * tile + 2 * 3 * 64 * 4 + 1024
    else:
        if kind == "fwd":
            ds = d + 4
            return 4 * (rows * ds + keys * ds + rows * pstr) + 4 * keys
        ds = dv + 4
        if kind == "dq":
            return 4 * (2 * rows * ds + 2 * keys * ds + keys * pstr + 2 * rows) + 4 * keys
        if kind == "dkv":
            return 4 * (2 * keys * ds + 2 * rows * ds + 2 * keys * pstr + 2 * rows + keys)
    raise ValueError(f"unknown block-sparse kernel {kind!r} (fwd | dq | dkv)")
