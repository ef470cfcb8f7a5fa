"""Block-sparse attention over a top-k block table: the NSA selected branch.

The port's counterpart of ``magiattention_tpu/kernels/block_sparse.py``.
Each q block of ``block_size_q`` rows attends, per kv head, the KV blocks
that its row of ``block_idx`` names. Selectable blocks start on a
``d_stride`` grid and may overlap (``d_stride < block_len``), so every
block is ``block_len // d_stride`` consecutive chunks of ``d_stride`` keys:
the chunk table (:func:`chunk_table`) lists them per (kv head, q block),
and a chunk named twice counts twice, as in the gathered dense reference.

Hand-written Hopper kernels walk it, behind the
``torch.autograd.Function`` :class:`_BSPCore`:

- ``csrc/block_sparse_fwd.cu`` (B13): out and natural-log lse, one CTA per
  64 query rows of a (kv head, q block), the keys gathered 64 at a time;
- ``csrc/block_sparse_bwd.cu`` (B14), two launches with no atomic: the dq
  walk (query-major, the forward's CTAs) and the dk/dv walk (key-major:
  one CTA per 64 key rows of a kv head over the table's transpose,
  :func:`key_table`, each key row weighted by its chunk's multiplicity in
  the visiting row), so dq, dk and dv are bitwise reproducible.

Their bf16 bodies run on the tensor cores (``csrc/block_sparse_tc.cuh``),
their float32 bodies on the CUDA cores. The kernels are compiled at head
dims 64, 128 and 256; :class:`_BSPCore` pads other dims up to 256 with
zero columns (:mod:`.head_dims`). Beside each kernel, a plain PyTorch version
(:func:`block_sparse_fwd_plain`, :func:`block_sparse_bwd_plain`): a
gathered dense softmax over the same chunk table. CPU tensors take the
plain versions; CUDA tensors launch the kernels or raise.
``validate_block_table``, ``modeled_slc_bytes`` and ``first_visit_flags``
are the JAX package's host functions (the last is what its backward's
revisit scheme needs; the CUDA backward has no use for it).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import _build
from .head_dims import KERNEL_HEAD_DIMS, is_kernel_width, pad_head_dim, pad_to_kernel_width

# the JAX kernel's lane width: its d_stride rule (<= 128 or a multiple of
# 128) is kept for error parity, though the CUDA kernels take any stride
NUM_LANES = 128
KEY_TILE = 64  # key rows a CTA of the dk/dv walk owns

__all__ = [
    "BSPParams",
    "KeyTable",
    "block_sparse_attn",
    "block_sparse_bwd_dkv_kernel",
    "block_sparse_bwd_dq_kernel",
    "block_sparse_bwd_kernel",
    "block_sparse_bwd_plain",
    "block_sparse_fwd_kernel",
    "block_sparse_fwd_plain",
    "chunk_table",
    "first_visit_flags",
    "key_table",
    "modeled_slc_bytes",
    "validate_block_table",
]


def first_visit_flags(chunk_tbl, n_chunks: int) -> np.ndarray:
    """Per-head first-visit flags of the TPU backward's revisit windows.

    For each kv head, chunk-table entries are visited in row-major
    ``(q_block, slot)`` order; entry (b, c) is 1 iff it is the first one
    naming its chunk. ``(hk, n_qb, C)`` int32 (host)."""
    tbl = np.asarray(chunk_tbl, dtype=np.int32)
    if tbl.size and (tbl.min() < 0 or tbl.max() >= n_chunks):
        raise ValueError(f"chunk index out of range [0, {n_chunks})")
    flags = np.zeros(tbl.shape, np.int32)
    for h in range(tbl.shape[0]):
        _, first = np.unique(tbl[h].reshape(-1), return_index=True)
        flags[h].reshape(-1)[first] = 1
    return flags


def validate_block_table(block_idx, n_blocks: int) -> None:
    """Host audit of a concrete table: every block index in range, and each
    (kv head, q block) row's picks pairwise distinct (a duplicate would
    double that block's softmax mass silently)."""
    tbl = np.asarray(block_idx)
    if tbl.size == 0:
        raise ValueError("block_idx is empty")
    if tbl.min() < 0 or tbl.max() >= n_blocks:
        raise ValueError(
            f"block_idx out of range: min={tbl.min()} max={tbl.max()} "
            f"valid=[0, {n_blocks})"
        )
    srt = np.sort(tbl, axis=-1)
    if (srt[..., 1:] == srt[..., :-1]).any():
        raise ValueError(
            "block_idx has duplicate block picks within a "
            "(kv-head, q-block) row"
        )


def modeled_slc_bytes(
    *,
    hk: int,
    n_qb: int,
    top_k: int,
    block_len: int,
    d_stride: int,
    block_size_q: int,
    g: int,
    d: int,
    dv: int,
    itemsize: int,
) -> dict:
    """Modeled HBM bytes of the slc branch: streaming the selected chunks
    against the gathered dense reference, which also writes and reads back
    the materialized ``top_k * block_len`` rows per (head, q block)."""
    r = block_size_q * g
    C = top_k * (block_len // d_stride)
    q_bytes = hk * n_qb * r * d * itemsize
    out_bytes = hk * n_qb * r * dv * itemsize
    streamed_kv = hk * n_qb * C * d_stride * (d + dv) * itemsize
    streamed = q_bytes + out_bytes + streamed_kv
    gathered = streamed + 2 * hk * n_qb * top_k * block_len * (d + dv) * itemsize
    return {"streamed_bytes": streamed, "gathered_bytes": gathered}


def chunk_table(block_idx: torch.Tensor, block_starts, d_stride: int, block_len: int) -> torch.Tensor:
    """``(hk, n_qb, top_k * block_len // d_stride)`` int32 chunk indices on
    ``block_idx``'s device: each selected block's consecutive chunks, in
    table order."""
    starts = torch.as_tensor(np.asarray(block_starts), dtype=torch.int64, device=block_idx.device)
    alpha = block_len // d_stride
    hk, n_qb = block_idx.shape[:2]
    first = (starts // d_stride)[block_idx.long()]  # (hk, n_qb, top_k)
    steps = torch.arange(alpha, device=block_idx.device)
    return (first[..., None] + steps).reshape(hk, n_qb, -1).to(torch.int32).contiguous()


@dataclass(frozen=True)
class BSPParams:
    """Static parameters of one call."""

    softmax_scale: float
    d_stride: int
    block_size_q: int


def chunk_slots(ds: int) -> int:
    """The most chunks of ``ds`` keys one key tile of :data:`KEY_TILE` rows
    overlaps: the multiplicities a :class:`KeyTable` visit carries."""
    return KEY_TILE // ds if KEY_TILE % ds == 0 else (KEY_TILE - 1) // ds + 2


@dataclass(frozen=True)
class KeyTable:
    """The chunk table transposed for the key-major dk/dv walk: per (kv
    head h, key tile kt), pair ``p = h * n_tiles + kt``, the q blocks whose
    table row names a chunk overlapping the tile's keys ``[64 kt, 64 kt +
    64)``, and each such row's multiplicity of each of those chunks.

    Attributes:
        order: ``(hk * n_tiles,)`` int32, the pairs by visit count, most
            first (stable): CTA ``x`` of the walk takes pair ``order[x]``.
        ptr: ``(hk * n_tiles + 1,)`` int32: pair ``p``'s visits are rows
            ``[ptr[p], ptr[p + 1])`` of ``qblock`` and ``mult``, q blocks
            ascending; rows past ``ptr[-1]`` are unused.
        qblock: ``(R,)`` int32, each visit's q block.
        mult: ``(R, slots)`` int32: entry ``m`` counts the row's entries
            equal to chunk ``64 kt // ds + m`` (0 where it names it not).
        n_tiles: ``ceil(S / 64)``; slots: :func:`chunk_slots` of ``ds``.
    """

    order: torch.Tensor
    ptr: torch.Tensor
    qblock: torch.Tensor
    mult: torch.Tensor
    n_tiles: int
    slots: int


def key_table(ctbl: torch.Tensor, seq: int, ds: int) -> KeyTable:
    """The :class:`KeyTable` of chunk table ``ctbl (hk, n_qb, C)`` over a
    sequence of ``seq`` keys: host-side planning by index ops on
    ``ctbl``'s device (one sort of the entries' (visit, chunk slot) keys,
    then run boundaries, a cumsum, a searchsorted and index writes), few
    of them (each costs host time), none that waits for the device, so it
    queues behind the dq walk. Its memory is O(entries): each entry
    expands to the at most ``(ds - 1) // 64 + 2`` key tiles its chunk
    overlaps (one where ds divides 64), and the visit rows are allocated
    for every expanded entry."""
    hk, n_qb, C = ctbl.shape
    dev = ctbl.device
    n_tiles = -(-seq // KEY_TILE)
    slots = chunk_slots(ds)
    pairs = hk * n_tiles
    dead = pairs * n_qb * slots  # past every (visit, slot) key: sorts last
    idt = torch.int32 if dead < 2**31 else torch.int64
    aligned = KEY_TILE % ds == 0  # a chunk lies in one key tile
    # key of (kv head h, q block b, tile t, slot s):
    # ((h * n_tiles + t) * n_qb + b) * slots + s = base[h, b] + t * n_qb * slots + s
    stride = n_tiles * n_qb * slots
    base = (torch.arange(0, hk * stride, stride, dtype=idt, device=dev)[:, None, None]
            + torch.arange(0, n_qb * slots, slots, dtype=idt, device=dev)[:, None])
    c = ctbl.to(idt)
    if aligned:  # t = c // slots and s = c % slots
        key = base + torch.add(c, c // slots, alpha=(n_qb - 1) * slots)
    else:  # the tiles a chunk may overlap; those it does not get the dead key
        c = c[..., None]
        t = c * ds // KEY_TILE + torch.arange((ds - 1) // KEY_TILE + 2, dtype=idt, device=dev)
        key = torch.where(
            t * KEY_TILE < (c + 1) * ds,
            base[..., None] + t * (n_qb * slots) + c - t * KEY_TILE // ds,
            dead,
        )
    key = key.flatten().sort().values
    rows = key.numel()
    visit = key // slots
    new = torch.empty(rows, dtype=torch.bool, device=dev)
    new[:1] = True
    torch.ne(visit[1:], visit[:-1], out=new[1:])
    before = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    torch.cumsum(new, 0, dtype=torch.int32, out=before[1:])  # visits up to each entry
    row = before[1:] - 1  # each live entry's visit row
    at = torch.add(key % slots, row, alpha=slots)
    src = torch.ones(rows, dtype=torch.int32, device=dev)
    if not aligned:  # dead entries (sorted last) add 0 at their own index
        live = key < dead
        at = torch.where(live, at, torch.arange(0, rows * slots, slots, dtype=idt, device=dev))
        src = live.to(torch.int32)
        row = torch.where(live, row, rows)
    mult = torch.zeros((rows + 1) * slots, dtype=torch.int32, device=dev)
    mult.index_add_(0, at, src)
    qblock = torch.empty(rows + 1, dtype=torch.int32, device=dev)
    qblock[row] = (visit % n_qb).to(torch.int32)
    # visits are sorted by pair: pair p starts at the visits before its
    # first entry (dead entries sort last, as pair `pairs`)
    first = torch.searchsorted(visit // n_qb, torch.arange(pairs + 1, dtype=idt, device=dev))
    ptr = before[first]
    order = torch.sort(ptr[1:] - ptr[:-1], descending=True, stable=True).indices
    return KeyTable(
        order=order.to(torch.int32), ptr=ptr, qblock=qblock,
        mult=mult.reshape(rows + 1, slots), n_tiles=n_tiles, slots=slots,
    )


# ---------------------------------------------------------------------------
# the CUDA kernels (ctypes launchers)
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# symbol prefix -> argument types of its <prefix>_f32 / <prefix>_bf16
_ARGTYPES = {
    # q k v tbl out lse | hq hk d bq n_qb C ds | scale | stream
    "block_sparse_fwd": [_P] * 6 + [_I] * 7 + [_F, _P],
    # q k v do lse delta tbl dq | hq hk d bq n_qb C ds | scale | stream
    "block_sparse_bwd_dq": [_P] * 8 + [_I] * 7 + [_F, _P],
    # q k v do lse delta order ptr qblock mult dk dv | hq hk d bq S ds slots
    # n_tiles | scale | stream
    "block_sparse_bwd_dkv": [_P] * 12 + [_I] * 8 + [_F, _P],
}
# kernel library (csrc/<name>.cu) -> the symbol prefixes it exports
_LIBRARIES = {
    "block_sparse_fwd": ("block_sparse_fwd",),
    "block_sparse_bwd": ("block_sparse_bwd_dq", "block_sparse_bwd_dkv"),
}


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    for prefix in _LIBRARIES[name]:
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{prefix}_{suffix}")
            fn.argtypes = _ARGTYPES[prefix]
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, prefix: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    lib = _lib(name)
    fn = getattr(lib, f"{prefix}_{'f32' if dtype == torch.float32 else 'bf16'}")
    code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, f"{prefix}_kernel")


def _kernel_inputs(name: str, q, k, v, params: BSPParams, *rest) -> list[torch.Tensor]:
    """Check what the kernels take; returns ``[q, k, v, *rest]`` contiguous
    in q's dtype (``rest``: tensors shaped like q, e.g. dO)."""
    S, hq, d = q.shape
    sk, hk, dv = v.shape
    if not (q.is_cuda and all(t.device == q.device for t in (k, v, *rest))):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if not is_kernel_width(d, dv) or hq % hk or sk != S or k.shape != v.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k/v {tuple(k.shape)}: need one "
            f"sequence, equal head dims in {KERNEL_HEAD_DIMS} (block_sparse_attn "
            "pads other dims), hq a multiple of hk"
        )
    if S % params.block_size_q:
        raise ValueError(f"{name}: S={S} is not a multiple of block_size_q")
    if any(t.shape != q.shape for t in rest):
        raise ValueError(f"{name}: dO must have q's shape {tuple(q.shape)}")
    out = [q.contiguous()] + [t.to(q.dtype).contiguous() for t in (k, v, *rest)]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    return out


def _table(name: str, ctbl: torch.Tensor, q, k, params: BSPParams) -> torch.Tensor:
    """The chunk table as contiguous int32 on q's device, checked to be
    ``(hk, S / block_size_q, C)``."""
    want = (k.shape[1], q.shape[0] // params.block_size_q)
    if ctbl.device != q.device or ctbl.dim() != 3 or tuple(ctbl.shape[:2]) != want:
        raise ValueError(f"{name}: table {tuple(ctbl.shape)} is not (hk, S / block_size_q, C)")
    return ctbl.to(torch.int32).contiguous()


def _row_stats(q, lse, delta) -> list[torch.Tensor]:
    want = tuple(q.shape[:2])
    if any(tuple(s.shape) != want or s.device != q.device for s in (lse, delta)):
        raise ValueError(f"lse and delta must be [S, hq] = {want} on {q.device}")
    return [lse.float().contiguous(), delta.float().contiguous()]


def _dims(q, k, ctbl, params: BSPParams) -> tuple[int, ...]:
    """hq hk d bq n_qb C ds of a launch."""
    S, hq, d = q.shape
    return (
        hq, k.shape[1], d, params.block_size_q, S // params.block_size_q,
        ctbl.shape[2], params.d_stride,
    )


def block_sparse_fwd_kernel(q, k, v, ctbl, params: BSPParams):
    """Launch ``csrc/block_sparse_fwd.cu`` (B13) on CUDA tensors ``q
    [S, hq, d]``, ``k/v [S, hk, d]`` of one dtype (float32 or bfloat16,
    d 64, 128 or 256) and the chunk table ``ctbl [hk, S / block_size_q, C]``,
    whose entries the caller keeps in ``[0, S / d_stride)``. Returns (out
    ``[S, hq, d]`` in q's dtype, lse ``[S, hq]`` float32). Adds one to
    ``block_sparse_fwd_kernel.launches`` per launch."""
    q, k, v = _kernel_inputs("block_sparse_fwd_kernel", q, k, v, params)
    tbl = _table("block_sparse_fwd_kernel", ctbl, q, k, params)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(
        "block_sparse_fwd", "block_sparse_fwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tbl.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *_dims(q, k, tbl, params),
        params.softmax_scale,
    )
    block_sparse_fwd_kernel.launches += 1
    return out, lse


def block_sparse_bwd_dq_kernel(q, k, v, do, lse, delta, ctbl, params: BSPParams):
    """Launch the dq walk of ``csrc/block_sparse_bwd.cu`` (B14, query-major,
    the forward's CTAs) from dO ``[S, hq, d]``, the forward's lse and delta
    = rowsum(dO * out) ``[S, hq]``. Returns dq ``[S, hq, d]`` float32, each
    row written once. Adds one to ``block_sparse_bwd_dq_kernel.launches``
    per launch."""
    q, k, v, do = _kernel_inputs("block_sparse_bwd_dq_kernel", q, k, v, params, do)
    tbl = _table("block_sparse_bwd_dq_kernel", ctbl, q, k, params)
    lse, delta = _row_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch(
        "block_sparse_bwd", "block_sparse_bwd_dq", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), tbl.data_ptr(), dq.data_ptr(),
        *_dims(q, k, tbl, params), params.softmax_scale,
    )
    block_sparse_bwd_dq_kernel.launches += 1
    return dq


def block_sparse_bwd_dkv_kernel(q, k, v, do, lse, delta, ktbl: KeyTable, params: BSPParams):
    """Launch the dk/dv walk of ``csrc/block_sparse_bwd.cu`` (B14,
    key-major over ``ktbl``, :func:`key_table` of the chunk table): one CTA
    per (kv head, 64 key rows), every key row's dk and dv summed on chip
    and written once. Returns (dk, dv) ``[S, hk, d]`` float32. Adds one to
    ``block_sparse_bwd_dkv_kernel.launches`` per launch."""
    q, k, v, do = _kernel_inputs("block_sparse_bwd_dkv_kernel", q, k, v, params, do)
    S, hq, d = q.shape
    hk = k.shape[1]
    if ktbl.n_tiles != -(-S // KEY_TILE) or ktbl.order.numel() != hk * ktbl.n_tiles:
        raise ValueError("block_sparse_bwd_dkv_kernel: the key table is not this sequence's")
    parts = (ktbl.order, ktbl.ptr, ktbl.qblock, ktbl.mult)
    if any(t.device != q.device or t.dtype != torch.int32 or not t.is_contiguous() for t in parts):
        raise ValueError("block_sparse_bwd_dkv_kernel: the key table must be contiguous int32 on q's device")
    lse, delta = _row_stats(q, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    _launch(
        "block_sparse_bwd", "block_sparse_bwd_dkv", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in parts),
        dk.data_ptr(), dv.data_ptr(), hq, hk, d, params.block_size_q, S, params.d_stride,
        ktbl.slots, ktbl.n_tiles, params.softmax_scale,
    )
    block_sparse_bwd_dkv_kernel.launches += 1
    return dk, dv


def block_sparse_bwd_kernel(q, k, v, do, lse, delta, ctbl, params: BSPParams):
    """B14 on CUDA tensors: :func:`block_sparse_bwd_dq_kernel`, then
    :func:`key_table` and :func:`block_sparse_bwd_dkv_kernel`. Returns (dq
    ``[S, hq, d]``, dk, dv ``[S, hk, d]``), float32, bitwise reproducible
    (no atomics)."""
    dq = block_sparse_bwd_dq_kernel(q, k, v, do, lse, delta, ctbl, params)
    ktbl = key_table(ctbl, q.shape[0], params.d_stride)
    dk, dv = block_sparse_bwd_dkv_kernel(q, k, v, do, lse, delta, ktbl, params)
    return dq, dk, dv


block_sparse_fwd_kernel.launches = 0
block_sparse_bwd_dq_kernel.launches = 0
block_sparse_bwd_dkv_kernel.launches = 0


# ---------------------------------------------------------------------------
# plain versions: a gathered dense softmax over the same chunk table
# ---------------------------------------------------------------------------


def _gather(x: torch.Tensor, ctbl: torch.Tensor, ds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[S, hk, d]`` -> its table rows ``[hk, n_qb, L, d]`` float32
    (L = C * ds keys in table order), and their key rows ``[hk, n_qb, L]``."""
    hk = x.shape[1]
    keys = (ctbl.long()[..., None] * ds + torch.arange(ds, device=x.device)).flatten(2)
    heads = torch.arange(hk, device=x.device)[:, None, None]
    return x.float().permute(1, 0, 2)[heads, keys], keys


def _rows(t: torch.Tensor, hk: int, bq: int) -> torch.Tensor:
    """``[S, hq, ...]`` -> ``[hk, n_qb, bq, g, ...]`` (q head h * g + gi
    shares kv head h)."""
    S, hq = t.shape[:2]
    return t.reshape(S // bq, bq, hk, hq // hk, *t.shape[2:]).movedim(2, 0)


def _unrows(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_rows`."""
    hk, n_qb, bq, g = t.shape[:4]
    return t.movedim(0, 2).reshape(n_qb * bq, hk * g, *t.shape[4:])


def _probs(s: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """exp(s - lse), 0 on rows with lse = -inf (no key)."""
    finite = torch.isfinite(lse)[..., None]
    return torch.where(finite, torch.exp(s - torch.where(finite, lse[..., None], 0.0)), 0.0)


def block_sparse_fwd_plain(q, k, v, ctbl, params: BSPParams):
    """Plain version of :func:`block_sparse_fwd_kernel` (float32 math):
    (out ``[S, hq, d]`` in q's dtype, lse ``[S, hq]`` float32)."""
    block_sparse_fwd_plain.calls += 1
    hk, bq = k.shape[1], params.block_size_q
    kf, _ = _gather(k, ctbl, params.d_stride)
    vf, _ = _gather(v, ctbl, params.d_stride)
    s = torch.einsum("hbqgd,hbld->hbqgl", _rows(q.float(), hk, bq), kf) * params.softmax_scale
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("hbqgl,hbld->hbqgd", _probs(s, lse), vf)
    return _unrows(out).to(q.dtype), _unrows(lse)


def block_sparse_bwd_plain(q, k, v, do, lse, delta, ctbl, params: BSPParams):
    """Plain version of :func:`block_sparse_bwd_kernel`: (dq ``[S, hq, d]``,
    dk, dv ``[S, hk, d]``) float32, a key row selected several times
    summing every selection's share."""
    block_sparse_bwd_plain.calls += 1
    S, hk = k.shape[:2]
    bq, scale = params.block_size_q, params.softmax_scale
    kf, keys = _gather(k, ctbl, params.d_stride)
    vf, _ = _gather(v, ctbl, params.d_stride)
    qr = _rows(q.float(), hk, bq)
    dor = _rows(do.to(q.dtype).float(), hk, bq)
    p = _probs(torch.einsum("hbqgd,hbld->hbqgl", qr, kf) * scale, _rows(lse.float(), hk, bq))
    dp = torch.einsum("hbqgd,hbld->hbqgl", dor, vf)
    ds = p * (dp - _rows(delta.float(), hk, bq)[..., None])
    dq = _unrows(torch.einsum("hbqgl,hbld->hbqgd", ds, kf)) * scale
    flat = (keys + S * torch.arange(hk, device=k.device)[:, None, None]).reshape(-1)

    def scatter(sel):  # [hk, n_qb, L, w] -> [S, hk, w], summed per key row
        w = sel.shape[-1]
        acc = torch.zeros(hk * S, w, dtype=torch.float32, device=k.device)
        return acc.index_add_(0, flat, sel.reshape(-1, w)).reshape(hk, S, w).permute(1, 0, 2)

    dk = scatter(torch.einsum("hbqgl,hbqgd->hbld", ds, qr)) * scale
    dv = scatter(torch.einsum("hbqgl,hbqgd->hbld", p, dor))
    return dq, dk.contiguous(), dv.contiguous()


block_sparse_fwd_plain.calls = 0
block_sparse_bwd_plain.calls = 0


def block_sparse_fwd(q, k, v, ctbl, params: BSPParams):
    fn = block_sparse_fwd_kernel if q.is_cuda else block_sparse_fwd_plain
    return fn(q, k, v, ctbl, params)


def block_sparse_bwd(q, k, v, do, lse, delta, ctbl, params: BSPParams):
    fn = block_sparse_bwd_kernel if q.is_cuda else block_sparse_bwd_plain
    return fn(q, k, v, do, lse, delta, ctbl, params)


class _BSPCore(torch.autograd.Function):
    """B13 forward + B14 backward over one chunk table (the JAX package's
    ``_bsp_core`` custom VJP): kernels for CUDA tensors, plain versions for
    CPU ones. On CUDA, head dims other than d == dv in (64, 128, 256) run padded
    with zero columns to the kernels' width (:mod:`.head_dims`), once per
    call: q, k, v here, dO in the backward. delta = rowsum(dO * out) is a
    torch sum outside the kernel, as in the JAX package; gradients come
    back in the input dtypes and widths and the lse cotangent is ignored
    (lse feeds merges, not losses)."""

    @staticmethod
    def forward(ctx, q, k, v, ctbl, params: BSPParams):
        ctx.widths = (q.shape[-1], v.shape[-1])
        if q.is_cuda:
            q, k, v = pad_to_kernel_width(q, k, v)
        out, lse = block_sparse_fwd(q, k, v, ctbl, params)
        ctx.save_for_backward(q, k, v, ctbl, out, lse)
        ctx.params = params
        ctx.mark_non_differentiable(lse)
        dv = ctx.widths[1]
        return (out if out.shape[-1] == dv else out[..., :dv].contiguous()), lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, ctbl, out, lse = ctx.saved_tensors
        d, dv = ctx.widths
        dout = pad_head_dim(dout.to(q.dtype), out.shape[-1])
        delta = (out.float() * dout.float()).sum(-1)
        dq, dk, dvg = block_sparse_bwd(q, k, v, dout, lse, delta, ctbl, ctx.params)
        return (
            dq[..., :d].to(q.dtype), dk[..., :d].to(k.dtype), dvg[..., :dv].to(v.dtype),
            None, None,
        )


def block_sparse_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    block_idx: torch.Tensor,
    block_starts,
    *,
    block_len: int,
    block_size_q: int,
    d_stride: int | None = None,
    softmax_scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse attention over a top-k block index table,
    differentiable in q, k and v.

    Args:
        q: ``(S, hq, d)``; k: ``(S, hk, d)``; v: ``(S, hk, dv)``.
        block_idx: ``(hk, n_qb, top_k)`` int, the selected block ids per
            (kv head, q block). A table on the host is audited (in range,
            distinct per row); one on a card is trusted (e.g. from an
            on-device top-k) to spare a device-to-host copy.
        block_starts: ``(n_blocks,)`` host row offsets of the selectable
            blocks (``nsa._block_layout`` starts), each ``d_stride``-aligned
            and each block inside the sequence.
        block_len: rows per block; ``d_stride`` (default ``block_len``) is
            the block-start stride and the chunk size.
        block_size_q: q rows per table row; must divide ``S``.
        softmax_scale: defaults to ``d ** -0.5``.

    Returns:
        (out ``(S, hq, dv)`` in q's dtype, lse ``(S, hq)`` float32 natural
        log, ``-inf`` on rows that attend nothing; valid tables have none).
    """
    S, hq, d = q.shape
    _, hk, dv = v.shape
    if hq % hk:
        raise ValueError(f"hq={hq} not a multiple of kv heads hk={hk}")
    if d_stride is None:
        d_stride = block_len
    ds = int(d_stride)
    if block_len % ds:
        raise ValueError(f"block_len={block_len} not a multiple of ds={ds}")
    if S % ds:
        raise ValueError(f"S={S} not a multiple of d_stride={ds}")
    if S % block_size_q:
        raise ValueError(f"S={S} not a multiple of block_size_q={block_size_q}")
    if not (ds <= NUM_LANES or ds % NUM_LANES == 0):
        raise ValueError(
            f"d_stride={ds} must be <= {NUM_LANES} or a multiple of it "
            f"(lane-tiling rule shared with ffa.default_blocks)"
        )
    if softmax_scale is None:
        softmax_scale = float(d) ** -0.5

    starts = np.asarray(block_starts)
    block_idx = torch.as_tensor(block_idx, device=q.device)
    if not block_idx.is_cuda:
        validate_block_table(block_idx.numpy(), int(starts.shape[0]))
    if (starts % ds).any():
        raise ValueError(f"block_starts must be d_stride={ds} aligned")
    if starts.size and int(starts.max()) + block_len > S:
        raise ValueError("a block extends past the sequence end")

    ctbl = chunk_table(block_idx, starts, ds, block_len)
    params = BSPParams(
        softmax_scale=float(softmax_scale), d_stride=ds, block_size_q=int(block_size_q),
    )
    return _BSPCore.apply(q, k, v, ctbl, params)
