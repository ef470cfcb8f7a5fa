"""NSA (native sparse attention) on one device.

The port's counterpart of ``nsa_attn`` in
``magiattention_tpu/parallel/nsa.py`` (ref exps/dist_attn/baselines/nsa.py,
VarlenNSA). Three branches per query, mixed by a learned sigmoid gate:

  cmp: attention over MLP-compressed KV blocks (length ``l_cmp``, stride
       ``d_stride``), dense softmax per varlen segment;
  slc: attention over the ``slc_top_k`` selected KV blocks (length
       ``l_slc``), chosen per (kv head, q block) from the compressed
       scores summed over the GQA group and the q block's rows;
  win: sliding-window attention per segment.

All block bookkeeping (block starts, segment masks, the cmp -> slc
aggregation matrix) is host metadata derived from ``cu_seqlens``; top-k is
the only data-dependent step. The slc branch takes the block-sparse
kernels (B13/B14, :func:`..kernels.block_sparse.block_sparse_attn`) where
the geometry is feasible, unless MAGI_ATTENTION_BACKEND_NSA_SLC pins
``gathered_dense`` (the take-and-dense-softmax reference, under autograd);
the win branch is the FFA kernels (``kernels.ffa.ffa_attn`` over diagonal
bands: B1, B7 and the fused or split backward). CPU tensors take every
kernel's plain version. :func:`usp_nsa_attn` is the USP-sharded NSA over
a :class:`._mesh.ProcessMesh`.
"""

from __future__ import annotations

from functools import reduce

import numpy as np
import torch

from .. import telemetry
from ..comm.functional import all_gather, all_to_all
from ..device import resolve_device
from ..env import backend as env_backend
from ..kernels.block_sparse import NUM_LANES, block_sparse_attn, modeled_slc_bytes
from ..kernels.ffa import ffa_attn
from ..kernels.mask_utils import BAND_INF
from ._mesh import ProcessMesh

NEG_INF = float("-inf")
PARAM_NAMES = ("w_cmp_k", "b_cmp_k", "w_cmp_v", "b_cmp_v", "w_gate", "b_gate")


def init_nsa_params(
    generator: torch.Generator,
    head_dim: int,
    l_cmp: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> dict:
    """Learned parameters: block compressors (ref cmp_linear_k/v) and the
    3-way branch gate (ref gate_proj), uniform as the JAX package draws
    them (from ``generator``; the numbers differ from JAX's, whose
    parameters :func:`params_from_numpy` carries across). On the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return ((u * 2 - 1) * bound).to(device=device, dtype=dtype)

    s, sg = l_cmp ** -0.5, head_dim ** -0.5
    return {
        "w_cmp_k": uniform((l_cmp,), s),
        "b_cmp_k": torch.zeros((), dtype=dtype, device=device),
        "w_cmp_v": uniform((l_cmp,), s),
        "b_cmp_v": torch.zeros((), dtype=dtype, device=device),
        "w_gate": uniform((head_dim, 3), sg),
        "b_gate": torch.zeros((3,), dtype=dtype, device=device),
    }


def params_from_numpy(tree: dict, device: torch.device | str | None = None) -> dict:
    """The JAX package's NSA parameters as numpy arrays
    (``jax.tree.map(np.asarray, init_nsa_params(...))``), as tensors of the
    same dtype on ``device`` (None = the card)."""
    device = resolve_device(device)
    return {name: torch.tensor(np.asarray(tree[name]), device=device) for name in PARAM_NAMES}


def _block_layout(cu_seqlens: list[int], l: int, d: int):
    """Per-segment stride-d window starts (host). Returns (starts (n,),
    seg_id (n,), counts per segment)."""
    starts, seg_ids, counts = [], [], []
    for s in range(len(cu_seqlens) - 1):
        a, b = cu_seqlens[s], cu_seqlens[s + 1]
        n = max(0, (b - a - l) // d + 1)
        counts.append(n)
        for j in range(n):
            starts.append(a + j * d)
            seg_ids.append(s)
    return (
        np.asarray(starts, dtype=np.int32),
        np.asarray(seg_ids, dtype=np.int32),
        counts,
    )


def _p_slc_matrix(
    counts_cmp: list[int], counts_slc: list[int], l_slc: int, l_cmp: int,
    d: int,
) -> np.ndarray:
    """(n_cmp_total, n_slc_total) aggregation weights: P_slc = P_cmp @ M.

    Both block families are stride-``d`` windows (:func:`_block_layout`):
    cmp block i covers d-chunks ``[i, i + beta)`` and slc block j covers
    ``[j, j + alpha)`` (alpha = l_slc/d, beta = l_cmp/d). The weight is the
    number of chunks they share,

        M[i, j] = max(0, min(i + beta, j + alpha) - max(i, j)),

    a small integer, exact in float32; the identity at alpha == beta == 1.
    """
    alpha, beta = l_slc // d, l_cmp // d
    n_cmp, n_slc = sum(counts_cmp), sum(counts_slc)
    M = np.zeros((n_cmp, n_slc), dtype=np.float32)
    co = so = 0
    for nc, ns in zip(counts_cmp, counts_slc):
        t = np.arange(nc)[:, None] - np.arange(ns)[None, :]  # i - j
        cnt = np.minimum(alpha, t + beta) - np.maximum(0, t)
        M[co:co + nc, so:so + ns] = np.maximum(cnt, 0).astype(np.float32)
        co += nc
        so += ns
    return M


def slc_route(S: int, l_slc: int, d_stride: int, slc_starts: np.ndarray) -> str:
    """The slc branch's route: 'block_sparse_pallas' (the block-sparse
    kernels; the JAX package's name) where the chunk geometry is feasible
    (the JAX package's test) and no pin says otherwise, else
    'gathered_dense'. An infeasible geometry takes the gathered route
    whatever the pin."""
    feasible = (
        S % d_stride == 0
        and l_slc % d_stride == 0
        and (d_stride <= NUM_LANES or d_stride % NUM_LANES == 0)
        and not (slc_starts % d_stride).any()
    )
    if not feasible:
        return "gathered_dense"
    return env_backend.nsa_slc_pin() or "block_sparse_pallas"


def _einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """einsum in the promoted dtype of its operands (as ``jnp.einsum``)."""
    dtype = reduce(torch.promote_types, (x.dtype for x in xs))
    return torch.einsum(eq, *(x.to(dtype) for x in xs))


def _add(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x + b in their promoted dtype (torch would keep x's dtype for a
    0-dim b of another float type; JAX promotes)."""
    dtype = torch.promote_types(x.dtype, b.dtype)
    return x.to(dtype) + b.to(dtype)


def nsa_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    params: dict,
    cu_seqlens: list[int],
    *,
    l_cmp: int = 32,
    l_slc: int = 64,
    d_stride: int = 32,
    block_size_q: int = 16,
    slc_top_k: int = 2,
    window: tuple[int, int] = (128, 0),
    causal: bool = True,
    softmax_scale: float | None = None,
    return_selection: bool = False,
):
    """Single-device NSA (``(S, h, dh)`` packed varlen layout),
    differentiable in q, k, v and every parameter.

    cu_seqlens and the block geometry are host metadata; every segment
    must hold at least ``slc_top_k`` selection blocks and a multiple of
    ``block_size_q`` rows. With ``return_selection`` the selected block
    table ``(hk, S / block_size_q, slc_top_k)`` (int64, descending score,
    ties to the lower block index as ``jax.lax.top_k``) comes back beside
    the output, so two routes can be checked to have chosen the same
    blocks before their outputs are compared.
    """
    S, hq, dh = q.shape
    _, hk, _ = k.shape
    g = hq // hk
    scale = dh ** -0.5 if softmax_scale is None else softmax_scale
    cu = list(cu_seqlens)
    if cu[0] != 0 or cu[-1] != S:
        raise ValueError(f"cu_seqlens must run from 0 to S={S}: {cu}")
    dev = q.device

    # ---- static layout ---------------------------------------------------
    cmp_starts, cmp_seg, cmp_counts = _block_layout(cu, l_cmp, d_stride)
    slc_starts, slc_seg, slc_counts = _block_layout(cu, l_slc, d_stride)
    if min(slc_counts) < slc_top_k:
        raise ValueError(f"every segment needs >= slc_top_k={slc_top_k} blocks")
    row_seg = np.zeros(S, dtype=np.int32)
    for s in range(len(cu) - 1):
        row_seg[cu[s]: cu[s + 1]] = s
        if (cu[s + 1] - cu[s]) % block_size_q:
            raise ValueError(f"segment {s} is not a multiple of block_size_q={block_size_q}")
    n_qb = S // block_size_q
    qb_seg = row_seg.reshape(n_qb, block_size_q)[:, 0]

    # ---- compressed KV ---------------------------------------------------
    def blocks_of(x, starts, l):  # (S, h, dh) -> (n, l, h, dh)
        idx = torch.as_tensor(starts[:, None] + np.arange(l)[None, :], device=dev)
        return x[idx.reshape(-1).long()].reshape(len(starts), l, *x.shape[1:])

    k_cmp_blk = blocks_of(k, cmp_starts, l_cmp)  # (n_cmp, l, hk, dh)
    v_cmp_blk = blocks_of(v, cmp_starts, l_cmp)
    k_cmp = _add(_einsum("nlhd,l->nhd", k_cmp_blk, params["w_cmp_k"]), params["b_cmp_k"])
    v_cmp = _add(_einsum("nlhd,l->nhd", v_cmp_blk, params["w_cmp_v"]), params["b_cmp_v"])

    # ---- cmp branch (dense per-segment softmax) --------------------------
    seg_mask = torch.as_tensor(row_seg[:, None] == cmp_seg[None, :], device=dev)
    qg = q.reshape(S, hk, g, dh)
    logits = _einsum("shgd,nhd->shgn", qg, k_cmp).float() * scale
    logits = logits.masked_fill(~seg_mask[:, None, None, :], NEG_INF)
    p_cmp = torch.softmax(logits, dim=-1)  # (S, hk, g, n_cmp)
    out_cmp = _einsum("shgn,nhd->shgd", p_cmp.to(q.dtype), v_cmp).reshape(S, hq, dh)

    # ---- selection scores (ref compute_p_slc/gqa/blockq) -----------------
    with torch.no_grad():
        if l_slc == l_cmp == d_stride:
            p_slc = p_cmp  # (S, hk, g, n_slc)
        else:
            M = torch.as_tensor(
                _p_slc_matrix(cmp_counts, slc_counts, l_slc, l_cmp, d_stride), device=dev
            )
            p_slc = torch.einsum("shgn,nm->shgm", p_cmp, M)
        n_slc = len(slc_starts)
        score = p_slc.sum(dim=2).reshape(n_qb, block_size_q, hk, n_slc).sum(1)
        score = score.permute(1, 0, 2)  # (hk, n_qb, n_slc)
        qb_mask = torch.as_tensor(qb_seg[:, None] == slc_seg[None, :], device=dev)
        score = score.masked_fill(~qb_mask[None], NEG_INF)
        # stable descending sort: ties go to the lower index (jax.lax.top_k)
        idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :slc_top_k]

    # ---- slc branch: the block-sparse kernels or the gathered reference --
    slc_backend = slc_route(S, l_slc, d_stride, slc_starts)
    if slc_backend == "block_sparse_pallas":
        out_slc, _ = block_sparse_attn(
            q, k, v, idx, slc_starts,
            block_len=l_slc, d_stride=d_stride,
            block_size_q=block_size_q, softmax_scale=scale,
        )
    else:
        k_slc_blk = k_cmp_blk if l_slc == l_cmp else blocks_of(k, slc_starts, l_slc)
        v_slc_blk = v_cmp_blk if l_slc == l_cmp else blocks_of(v, slc_starts, l_slc)
        heads = torch.arange(hk, device=dev)[:, None, None]
        # (hk, n_qb, K, l, dh) -> (hk, n_qb, K * l, dh)
        k_sel = k_slc_blk.permute(2, 0, 1, 3)[heads, idx].reshape(hk, n_qb, -1, dh)
        v_sel = v_slc_blk.permute(2, 0, 1, 3)[heads, idx].reshape(hk, n_qb, -1, dh)
        qb = q.reshape(n_qb, block_size_q, hk, g, dh)
        s_logits = torch.einsum("bqhgd,hbld->hbgql", qb, k_sel).float() * scale
        p_s = torch.softmax(s_logits, dim=-1)
        out_slc = torch.einsum("hbgql,hbld->bqhgd", p_s.to(q.dtype), v_sel).reshape(S, hq, dh)
    if telemetry.enabled():
        slc_bytes = modeled_slc_bytes(
            hk=hk, n_qb=n_qb, top_k=slc_top_k, block_len=l_slc,
            d_stride=d_stride, block_size_q=block_size_q, g=g, d=dh,
            dv=dh, itemsize=q.element_size(),
        )
        telemetry.record_event(
            "nsa_step",
            slc_backend=slc_backend,
            top_k=slc_top_k,
            hk=hk,
            n_qb=n_qb,
            l_slc=l_slc,
            d_stride=d_stride,
            executed_bytes=slc_bytes["streamed_bytes"],
            gathered_bytes=slc_bytes["gathered_bytes"],
        )

    # ---- win branch: banded FFA per segment (ref flash varlen + window) --
    wl, wr = window
    d_hi = 0 if causal else (wr if wr >= 0 else BAND_INF)
    d_lo = -wl if wl >= 0 else -BAND_INF
    qr = np.array([[cu[s], cu[s + 1]] for s in range(len(cu) - 1)], np.int32)
    out_win, _ = ffa_attn(
        q, k, v, qr, qr.copy(), None,
        softmax_scale=scale,
        d_lo=np.full(len(qr), d_lo, np.int32),
        d_hi=np.full(len(qr), d_hi, np.int32),
    )

    # ---- gate mix (ref gate_proj + sigmoid) ------------------------------
    gate = torch.sigmoid(
        _add(torch.einsum("shd,dc->shc", q.float(), params["w_gate"].float()), params["b_gate"])
    ).to(q.dtype)
    out = (
        gate[..., 0:1] * out_cmp
        + gate[..., 1:2] * out_slc
        + gate[..., 2:3] * out_win
    )
    return (out, idx) if return_selection else out


def usp_nsa_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    params: dict,
    cu_seqlens: list[int],
    mesh: ProcessMesh,
    ring_axis: str = "rp",
    ulysses_axis: str = "sp",
    **nsa_kwargs,
) -> torch.Tensor:
    """USP-sharded NSA (ref usp_nsa.py:747 USPAllGatherNSA).

    q/k/v: this process's ``(S / (R * U), h, dh)`` shard of the natural
    order under ``P((ring_axis, ulysses_axis))``. The ulysses all-to-all
    turns it into head shards, a ring all-gather makes the whole sequence
    of them, and every rank computes :func:`nsa_attn` for its head subset
    over the whole sequence, then keeps its ring block's rows and returns
    them to sequence shards by the inverse all-to-all. Like the reference,
    every ring rank computes every query of its heads: R-fold redundant.

    ``params`` are replicated (the gate and compressors act per head
    dimension). Each process's parameter gradients are its partial: their
    ``all_reduce(SUM)`` over the mesh equals the single-device gradient, as
    the trainer sums its gradients. q/k/v's gradients come back to their
    shards through the collectives' adjoints (reduce-scatter, inverse
    all-to-all). Returns this process's ``(S / (R * U), hq, dh)`` rows.
    """
    hq, hk = q.shape[1], k.shape[1]
    U = mesh.shape[ulysses_axis]
    if hq % U or hk % U:
        raise ValueError(f"usp_nsa needs heads divisible by U ({hq}, {hk}, {U})")
    ug, rg = mesh.group(ulysses_axis), mesh.group(ring_axis)
    # (S / (R * U), h) -> (S / R, h / U) -> the whole sequence, h / U
    full = [all_gather(all_to_all(t, ug, 1, 0), rg) for t in (q, k, v)]
    out = nsa_attn(*full, params, cu_seqlens, **nsa_kwargs)
    blk = out.shape[0] // mesh.shape[ring_axis]
    r = mesh.coord(ring_axis)
    return all_to_all(out[r * blk:(r + 1) * blk], ug, 0, 1)
