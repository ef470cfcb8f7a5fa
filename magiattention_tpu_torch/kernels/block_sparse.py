"""Block-sparse attention over a top-k block table: the NSA selected branch.

The port's counterpart of ``magiattention_tpu/kernels/block_sparse.py``.
Each q block of ``block_size_q`` rows attends, per kv head, the KV blocks
that its row of ``block_idx`` names. Selectable blocks start on a
``d_stride`` grid and may overlap (``d_stride < block_len``), so every
block is ``block_len // d_stride`` consecutive chunks of ``d_stride`` keys:
the chunk table (:func:`chunk_table`) lists them per (kv head, q block),
and a chunk named twice counts twice, as in the gathered dense reference.

Two hand-written Hopper kernels walk it, behind the
``torch.autograd.Function`` :class:`_BSPCore`:

- ``csrc/block_sparse_fwd.cu`` (B13): out and natural-log lse, one CTA per
  64 query rows of a (kv head, q block), the keys gathered 64 at a time;
- ``csrc/block_sparse_bwd.cu`` (B14): dq once per row, dk/dv by float32
  atomics into zeroed (S, hk, d) buffers (not bitwise reproducible).

Beside each, a plain PyTorch version (:func:`block_sparse_fwd_plain`,
:func:`block_sparse_bwd_plain`): a gathered dense softmax over the same
chunk table. CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise. ``validate_block_table``, ``modeled_slc_bytes`` and
``first_visit_flags`` are the JAX package's host functions (the last is
what its backward's revisit scheme needs; the CUDA backward has no use for
it).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import _build

# the JAX kernel's lane width: its d_stride rule (<= 128 or a multiple of
# 128) is kept for error parity, though the CUDA kernels take any stride
NUM_LANES = 128
KERNEL_HEAD_DIMS = (64, 128)

__all__ = [
    "BSPParams",
    "block_sparse_attn",
    "block_sparse_bwd_kernel",
    "block_sparse_bwd_plain",
    "block_sparse_fwd_kernel",
    "block_sparse_fwd_plain",
    "chunk_table",
    "first_visit_flags",
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


# ---------------------------------------------------------------------------
# the CUDA kernels (ctypes launchers)
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q k v tbl out lse | hq hk d bq n_qb C ds | scale | stream
    "block_sparse_fwd": [_P] * 6 + [_I] * 7 + [_F, _P],
    # q k v do lse delta tbl dq dk dv | hq hk d bq n_qb C ds | scale | stream
    "block_sparse_bwd": [_P] * 10 + [_I] * 7 + [_F, _P],
}


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    lib = _lib(name)
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}")
    code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, f"{name}_kernel")


def _kernel_inputs(name: str, q, k, v, ctbl, params: BSPParams, *rest):
    """Check what the kernels take; returns ``[q, k, v, *rest]`` contiguous
    in q's dtype (``rest``: tensors shaped like q, e.g. dO) and the table
    as contiguous int32."""
    S, hq, d = q.shape
    sk, hk, dv = v.shape
    tensors = (k, v, ctbl, *rest)
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if d != dv or d not in KERNEL_HEAD_DIMS or hq % hk or sk != S or k.shape != v.shape:
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k/v {tuple(k.shape)}: need one "
            f"sequence, equal head dims in {KERNEL_HEAD_DIMS}, hq a multiple of hk"
        )
    bq = params.block_size_q
    if S % bq or ctbl.dim() != 3 or tuple(ctbl.shape[:2]) != (hk, S // bq):
        raise ValueError(f"{name}: table {tuple(ctbl.shape)} is not (hk, S / block_size_q, C)")
    if any(t.shape != q.shape for t in rest):
        raise ValueError(f"{name}: dO must have q's shape {tuple(q.shape)}")
    out = [q.contiguous()] + [t.to(q.dtype).contiguous() for t in (k, v, *rest)]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    return out, ctbl.to(torch.int32).contiguous()


def _dims(q, k, ctbl, params: BSPParams) -> tuple[int, ...]:
    """hq hk d bq n_qb C ds of a launch."""
    S, hq, d = q.shape
    return (
        hq, k.shape[1], d, params.block_size_q, S // params.block_size_q,
        ctbl.shape[2], params.d_stride,
    )


def block_sparse_fwd_kernel(q, k, v, ctbl, params: BSPParams):
    """Launch ``csrc/block_sparse_fwd.cu`` (B13) on CUDA tensors ``q
    [S, hq, d]``, ``k/v [S, hk, d]`` of one dtype (float32 or bfloat16)
    and the chunk table ``ctbl [hk, S / block_size_q, C]``, whose entries
    the caller keeps in ``[0, S / d_stride)``. Returns (out ``[S, hq, d]``
    in q's dtype, lse ``[S, hq]`` float32). Adds one to
    ``block_sparse_fwd_kernel.launches`` per launch."""
    (q, k, v), tbl = _kernel_inputs("block_sparse_fwd_kernel", q, k, v, ctbl, params)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(
        "block_sparse_fwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tbl.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *_dims(q, k, tbl, params),
        params.softmax_scale,
    )
    block_sparse_fwd_kernel.launches += 1
    return out, lse


def block_sparse_bwd_kernel(q, k, v, do, lse, delta, ctbl, params: BSPParams):
    """Launch ``csrc/block_sparse_bwd.cu`` (B14): the one-pass backward of
    :func:`block_sparse_fwd_kernel` from dO ``[S, hq, d]``, the forward's
    lse and delta = rowsum(dO * out) ``[S, hq]``. Returns (dq ``[S, hq,
    d]``, dk, dv ``[S, hk, d]``), float32; dk and dv are summed with
    atomics, so they are not bitwise reproducible. Adds one to
    ``block_sparse_bwd_kernel.launches`` per launch."""
    (q, k, v, do), tbl = _kernel_inputs("block_sparse_bwd_kernel", q, k, v, ctbl, params, do)
    want = tuple(q.shape[:2])
    if any(tuple(s.shape) != want or s.device != q.device for s in (lse, delta)):
        raise ValueError(f"lse and delta must be [S, hq] = {want} on {q.device}")
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    _launch(
        "block_sparse_bwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), tbl.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_dims(q, k, tbl, params),
        params.softmax_scale,
    )
    block_sparse_bwd_kernel.launches += 1
    return dq, dk, dv


block_sparse_fwd_kernel.launches = 0
block_sparse_bwd_kernel.launches = 0


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
    S, hk, d = k.shape
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

    def scatter(sel):  # [hk, n_qb, L, d] -> [S, hk, d], summed per key row
        acc = torch.zeros(hk * S, d, dtype=torch.float32, device=k.device)
        return acc.index_add_(0, flat, sel.reshape(-1, d)).reshape(hk, S, d).permute(1, 0, 2)

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
    CPU ones. delta = rowsum(dO * out) is a torch sum outside the kernel,
    as in the JAX package; gradients come back in the input dtypes and the
    lse cotangent is ignored (lse feeds merges, not losses)."""

    @staticmethod
    def forward(ctx, q, k, v, ctbl, params: BSPParams):
        out, lse = block_sparse_fwd(q, k, v, ctbl, params)
        ctx.save_for_backward(q, k, v, ctbl, out, lse)
        ctx.params = params
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, ctbl, out, lse = ctx.saved_tensors
        delta = (out.float() * dout.to(q.dtype).float()).sum(-1)
        dq, dk, dv = block_sparse_bwd(q, k, v, dout, lse, delta, ctbl, ctx.params)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


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
