"""Paged decode attention straight from the pages: one query row per slot,
speculative verify (spec_k draft rows per slot) and int8 pages.

The port's counterpart of ``paged_decode_attn``, ``paged_decode_attn_spec``
and ``paged_decode_attn_int8`` in ``magiattention_tpu/kernels/paged_decode.py``.
A CUDA tensor launches the matching kernel (``csrc/paged_decode.cu``,
``csrc/paged_decode_spec.cu``, ``csrc/paged_decode_int8.cu``: one body,
``csrc/paged_decode.cuh``, lengths and page table read on the device, so
one launch serves every tick); a CPU tensor takes the plain version. There
is no other route: a kernel that fails to build or launch raises.

All three split each slot's page walk across CTAs (flash-decoding): the
grid is (kv head, slot, split), each split a fixed token range that
:func:`decode_split_plan` sets from the cache's shape and the SM count
alone, so one launch still serves every tick and B11 at one draft row is
B10. The chunks of a range are double-buffered in shared memory by
``cp.async`` (B12: the raw int8 codes, with each token row's K and V scale
beside them); a slot longer than one split leaves per-row partials in a
float32 workspace (:func:`split_workspace`, allocated here per launch) that
a second kernel merges in split order, so two launches give the same bits.
What still bounds them is each chunk's work on the CUDA cores and in shared
memory, and the merge launch (PERF.md).

The kernels are compiled at head dims 64, 128 and 256. A cache on the card
holds its pages at that width already (``PagedKVCache.create``), so a call
with other logical dims pads only q (small, per tick) and slices out back
to ``head_dim_v``.

The head-sharded variant of the TPU module is not ported (ROADMAP).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import _build
from .head_dims import KERNEL_HEAD_DIMS, pad_head_dim
from .paged_kv import PagedKVCache

KERNEL_MAX_GROUP = 8  # GMAX in csrc/paged_decode.cu and paged_decode_int8.cu
KERNEL_MAX_SPEC_ROWS = 32  # largest RMAX in csrc/paged_decode_spec.cu
SPLIT_UNIT = 64  # splits are whole 64-token units (two of the walk's chunks)
MIN_SPLIT_TOKENS = 256  # a split loads its q rows and writes its partials once


def decode_split_plan(P: int, ps: int, hk: int, sms: int) -> tuple[int, int]:
    """``(splits, split_len)``: how B10, B11 and B12 cut each slot's page
    walk.

    Split ``z`` of a slot owns tokens ``[z * split_len, (z + 1) *
    split_len)``; ``splits * split_len`` covers the table's ``P * ps``
    tokens. The plan reads only the table width ``P``, the page size, the
    kv heads and the SM count: never the lengths (which live on the
    device) nor the draft rows, so one launch serves every tick and B11 at
    one draft row keeps B10's geometry. About as many splits as one long
    slot needs to give each SM a CTA (``hk * splits`` near ``sms``, never
    above it), none shorter than :data:`MIN_SPLIT_TOKENS`.
    """
    if min(P, ps, hk, sms) < 1:
        raise ValueError(f"decode_split_plan: P={P}, ps={ps}, hk={hk}, sms={sms}")
    span = P * ps
    per = -(-span // -(-sms // hk))
    split_len = max(MIN_SPLIT_TOKENS, -(-per // SPLIT_UNIT) * SPLIT_UNIT)
    return -(-span // split_len), split_len


def split_plan_of(cache: PagedKVCache, sms: int) -> tuple[int, int]:
    """:func:`decode_split_plan` of a cache's shape on a card of ``sms``
    SMs: the plan B10, B11 and B12 launch with."""
    P = cache.page_table.shape[1]
    _, ps, hk, _ = cache.v_pages.shape
    return decode_split_plan(P, ps, hk, sms)


def split_workspace(splits: int, rows: int, d: int,
                    device: torch.device | str) -> torch.Tensor | None:
    """The float32 partials of a split launch over ``rows`` out rows
    (``S * spec_k * hq``): per split, ``rows x d`` accumulators, then per
    split ``rows x 2`` (max in the log2 domain, sum). ``None`` for one
    split, where every slot is written directly."""
    if splits == 1:
        return None
    return torch.empty(splits * rows * (d + 2), dtype=torch.float32, device=device)


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> argument types of its ``<name>_f32`` / ``<name>_bf16`` (pointers
# first, then the ints, the softmax scale and the stream)
_ARGTYPES = {
    "paged_decode": [_P] * 8 + [_I] * 8 + [_F, _P],
    "paged_decode_spec": [_P] * 8 + [_I] * 9 + [_F, _P],
    "paged_decode_int8": [_P] * 10 + [_I] * 8 + [_F, _P],
}


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def _check_launch(what: str, q: torch.Tensor, cache: PagedKVCache, rows: int,
                  page_dtype: torch.dtype, max_rows: int) -> None:
    """What every paged-decode kernel takes; raises before any launch."""
    S = q.shape[0]
    hq, d = q.shape[-2:]
    num_pages, ps, hk, width = cache.v_pages.shape
    if not (q.is_cuda and cache.k_pages.device == q.device):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {q.dtype} not supported")
    if cache.k_pages.dtype != page_dtype or cache.v_pages.dtype != page_dtype:
        raise TypeError(f"{what}: pages must be {page_dtype}")
    if d != cache.head_dim:
        raise ValueError(f"{what}: q's head dim {d} is not the cache's {cache.head_dim}")
    if cache.k_pages.shape[-1] != width or width not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{what}: pages {cache.k_pages.shape[-1]} / {width} wide: the kernels "
            f"take pages of one width in {KERNEL_HEAD_DIMS} (PagedKVCache.create "
            "on the card allocates them so)"
        )
    if hq % hk or rows > max_rows:
        raise ValueError(
            f"{what}: hq={hq} must be a multiple of hk={hk}, with at most "
            f"{max_rows} query rows per kv head (got {rows})"
        )
    if cache.page_table.shape[0] != S or cache.lengths.shape != (S,):
        raise ValueError(f"{what}: one query block per cache slot")
    tensors = [q, cache.k_pages, cache.v_pages, cache.page_table, cache.lengths]
    if cache.quantized:
        tensors += [cache.k_scales, cache.v_scales]
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous, aligned tensors")
    if cache.page_table.dtype != torch.int32 or cache.lengths.dtype != torch.int32:
        raise TypeError(f"{what}: table and lengths must be int32")


def _logical(out: torch.Tensor, cache: PagedKVCache) -> torch.Tensor:
    """out at the cache's v width (a copy only where the pages are wider)."""
    dv = cache.head_dim_v
    return out if out.shape[-1] == dv else out[..., :dv].contiguous()


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def paged_decode_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode.cu``: ``q (S, hq, d)`` CUDA tensor of the
    pages' dtype (float32 or bfloat16), split by :func:`split_plan_of`.
    Adds one to ``paged_decode_kernel.launches`` per launch (the split walk
    and its merge)."""
    q = q.contiguous()
    num_pages, ps, hk, width = cache.v_pages.shape
    _check_launch("paged_decode_kernel", q, cache, q.shape[1] // hk, q.dtype,
                  KERNEL_MAX_GROUP)
    q = pad_head_dim(q, width)
    S, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((S, hq), dtype=torch.float32, device=q.device)
    splits, split_len = split_plan_of(cache, _sm_count(q.device))
    part = split_workspace(splits, S * hq, d, q.device)
    lib = _lib("paged_decode")
    fn = lib.paged_decode_f32 if q.dtype == torch.float32 else lib.paged_decode_bf16
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), None if part is None else part.data_ptr(),
        S, hq, hk, d, ps, cache.page_table.shape[1], splits, split_len,
        softmax_scale, _stream(q),
    )
    _build.check(lib, code, "paged_decode_kernel")
    paged_decode_kernel.launches += 1
    return _logical(out, cache), lse


paged_decode_kernel.launches = 0


def paged_decode_spec_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode_spec.cu``: ``q (S, spec_k, hq, d)`` CUDA
    tensor of the pages' dtype, ``spec_k * hq / hk <= 32``, split as
    :func:`paged_decode_kernel` (the same plan at every ``spec_k``). Adds
    one to ``paged_decode_spec_kernel.launches`` per launch."""
    q = q.contiguous()
    S, spec_k, hq, _ = q.shape
    num_pages, ps, hk, width = cache.v_pages.shape
    if spec_k < 1:
        raise ValueError(f"spec_k={spec_k} must be >= 1")
    _check_launch("paged_decode_spec_kernel", q, cache, spec_k * (hq // hk),
                  q.dtype, KERNEL_MAX_SPEC_ROWS)
    q = pad_head_dim(q, width)
    d = q.shape[-1]
    out = torch.empty_like(q)
    lse = torch.empty((S, spec_k, hq), dtype=torch.float32, device=q.device)
    splits, split_len = split_plan_of(cache, _sm_count(q.device))
    part = split_workspace(splits, S * spec_k * hq, d, q.device)
    lib = _lib("paged_decode_spec")
    fn = (lib.paged_decode_spec_f32 if q.dtype == torch.float32
          else lib.paged_decode_spec_bf16)
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), None if part is None else part.data_ptr(),
        S, spec_k, hq, hk, d, ps, cache.page_table.shape[1], splits, split_len,
        softmax_scale, _stream(q),
    )
    _build.check(lib, code, "paged_decode_spec_kernel")
    paged_decode_spec_kernel.launches += 1
    return _logical(out, cache), lse


paged_decode_spec_kernel.launches = 0


def paged_decode_int8_kernel(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/paged_decode_int8.cu``: ``q (S, hq, d)`` CUDA tensor
    (float32 or bfloat16) over an int8 cache with its scales, split as
    :func:`paged_decode_kernel`. Adds one to
    ``paged_decode_int8_kernel.launches`` per launch."""
    if not cache.quantized:
        raise ValueError("paged_decode_int8_kernel needs an int8 cache")
    q = q.contiguous()
    num_pages, ps, hk, width = cache.v_pages.shape
    _check_launch("paged_decode_int8_kernel", q, cache, q.shape[1] // hk,
                  torch.int8, KERNEL_MAX_GROUP)
    q = pad_head_dim(q, width)
    S, hq, d = q.shape
    if cache.k_scales.dtype != torch.float32 or cache.v_scales.dtype != torch.float32:
        raise TypeError("paged_decode_int8_kernel: scales must be float32")
    out = torch.empty_like(q)
    lse = torch.empty((S, hq), dtype=torch.float32, device=q.device)
    splits, split_len = split_plan_of(cache, _sm_count(q.device))
    part = split_workspace(splits, S * hq, d, q.device)
    lib = _lib("paged_decode_int8")
    fn = (lib.paged_decode_int8_f32 if q.dtype == torch.float32
          else lib.paged_decode_int8_bf16)
    code = fn(
        q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(),
        cache.k_scales.data_ptr(), cache.v_scales.data_ptr(),
        cache.page_table.data_ptr(), cache.lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), None if part is None else part.data_ptr(),
        S, hq, hk, d, ps, cache.page_table.shape[1], splits, split_len,
        softmax_scale, _stream(q),
    )
    _build.check(lib, code, "paged_decode_int8_kernel")
    paged_decode_int8_kernel.launches += 1
    return _logical(out, cache), lse


paged_decode_int8_kernel.launches = 0


def _plain_pages(cache: PagedKVCache) -> tuple[torch.Tensor, torch.Tensor]:
    """Every slot's pages gathered (-1 entries clamp to page 0) as float32
    ``(S, P * ps, hk, head_dim)`` K and ``(..., head_dim_v)`` V, dequantized
    on an int8 cache."""
    S, P = cache.page_table.shape
    ps, hk = cache.k_pages.shape[1:3]
    table = cache.page_table.clamp_min(0).long()  # (S, P)
    k = cache.k_pages[table][..., : cache.head_dim].float()  # (S, P, ps, hk, d)
    v = cache.v_pages[table][..., : cache.head_dim_v].float()
    if cache.quantized:
        k = k * cache.k_scales[table][:, :, None, :, None]
        v = v * cache.v_scales[table][:, :, None, :, None]
    return k.reshape(S, P * ps, hk, -1), v.reshape(S, P * ps, hk, -1)


def _plain_attend(q, k, v, limits, softmax_scale):
    """Softmax attention in float32 of ``q (S, T, hq, d)`` over ``k/v (S, L,
    hk, d)``, row (s, t) over columns ``< limits[s, t]``; empty rows give
    (0, -inf). Returns out ``(S, T, hq, dv)`` in q's dtype, lse ``(S, T,
    hq)``."""
    S, T, hq, d = q.shape
    L, hk, dv = v.shape[1:]
    g = hq // hk
    qf = q.float().reshape(S, T, hk, g, d)
    scores = torch.einsum("sthgd,slhd->sthgl", qf, k) * softmax_scale
    cols = torch.arange(L, device=q.device)
    live = cols[None, None, :] < limits[:, :, None]  # (S, T, L)
    scores = scores.masked_fill(~live[:, :, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m.isfinite(), m, 0.0)
    p = torch.exp(scores - m_safe)  # exactly 0 on masked rows
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    out = torch.einsum("sthgl,slhd->sthgd", p, v) / torch.where(empty, 1.0, l)
    lse = torch.where(empty, float("-inf"), m_safe + torch.log(l))
    return out.reshape(S, T, hq, dv).to(q.dtype), lse.reshape(S, T, hq)


def paged_decode_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`paged_decode_attn`: gather every slot's
    pages, mask rows at or past the slot's length, softmax in float32.
    Counts its calls in ``paged_decode_plain.calls``."""
    paged_decode_plain.calls += 1
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    k, v = _plain_pages(cache)
    limits = cache.lengths.long()[:, None]
    out, lse = _plain_attend(q[:, None], k, v, limits, softmax_scale)
    return out[:, 0], lse[:, 0]


paged_decode_plain.calls = 0


def paged_decode_spec_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`paged_decode_attn_spec`: draft token t of
    slot s attends columns ``< lengths[s] - (spec_k - 1 - t)``. Counts its
    calls in ``paged_decode_spec_plain.calls``."""
    paged_decode_spec_plain.calls += 1
    S, spec_k = q.shape[:2]
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    k, v = _plain_pages(cache)
    t = torch.arange(spec_k, device=q.device)
    limits = cache.lengths.long()[:, None] - (spec_k - 1 - t)[None, :]
    return _plain_attend(q, k, v, limits, softmax_scale)


paged_decode_spec_plain.calls = 0


def paged_decode_int8_plain(
    q: torch.Tensor, cache: PagedKVCache, softmax_scale: float | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`paged_decode_attn_int8`: the pages
    dequantized (code * scale) to float32, then :func:`paged_decode_plain`'s
    arithmetic. Counts its calls in ``paged_decode_int8_plain.calls``."""
    paged_decode_int8_plain.calls += 1
    if not cache.quantized:
        raise ValueError("paged_decode_int8_plain needs an int8 cache")
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    k, v = _plain_pages(cache)
    limits = cache.lengths.long()[:, None]
    out, lse = _plain_attend(q[:, None], k, v, limits, softmax_scale)
    return out[:, 0], lse[:, 0]


paged_decode_int8_plain.calls = 0


def paged_decode_attn(
    q: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched decode step: each slot's single query token attends over
    its own paged KV rows ``[0, lengths[slot])``.

    Args:
        q: ``(max_seqs, hq, d)`` — one query row per slot. Slots with
            ``lengths == 0`` are inactive and yield (out=0, lse=-inf).
        cache: the paged cache after this step's k/v rows were appended.
        softmax_scale: defaults to ``d ** -0.5``.

    Returns:
        (out ``(max_seqs, hq, dv)`` in q's dtype, lse ``(max_seqs, hq)``
        float32, ``-inf`` on inactive slots).
    """
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return paged_decode_kernel(q, cache, float(softmax_scale))
    return paged_decode_plain(q, cache, softmax_scale)


def paged_decode_attn_spec(
    q: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative verify step: each slot's ``spec_k`` draft-token query
    rows (already appended to the cache, so ``lengths`` includes them)
    attend their own causal prefixes in one launch.

    Args:
        q: ``(max_seqs, spec_k, hq, d)`` — draft token ``t`` of a slot sits
            at absolute position ``lengths[slot] - spec_k + t``. Rows with
            no live column (inactive slots, slots shorter than spec_k)
            yield (out=0, lse=-inf). The kernel takes at most 32 rows per
            kv head (``spec_k * hq / hk``).

    Returns:
        (out ``(max_seqs, spec_k, hq, dv)`` in q's dtype,
        lse ``(max_seqs, spec_k, hq)`` float32).
    """
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return paged_decode_spec_kernel(q, cache, float(softmax_scale))
    return paged_decode_spec_plain(q, cache, softmax_scale)


def paged_decode_attn_int8(
    q: torch.Tensor,
    cache: PagedKVCache,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One batched decode step over an int8 cache (``PagedKVCache.create(
    ..., dtype=torch.int8)``). Same contract as :func:`paged_decode_attn`."""
    if not cache.quantized:
        raise ValueError(
            "paged_decode_attn_int8 needs a quantized cache "
            "(PagedKVCache.create(..., dtype=torch.int8))"
        )
    if softmax_scale is None:
        softmax_scale = float(q.shape[-1]) ** -0.5
    if q.is_cuda:
        return paged_decode_int8_kernel(q, cache, float(softmax_scale))
    return paged_decode_int8_plain(q, cache, softmax_scale)
