"""The port's block-sparse attention (the NSA selected branch) against the
JAX package's on the CPU: the host functions (chunk table, first-visit
flags, table audit, modeled bytes), the argument checks, and
``block_sparse_attn`` forward and gradients (the port through its plain
versions, JAX through its Pallas kernels in interpret mode), at the shapes
of ``tests/test_attn/test_nsa_block_sparse.py``."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magiattention_tpu.kernels import block_sparse as jbs
from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.kernels import block_sparse as tbs
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

S, HK, DH = 256, 2, 32
L_SLC, D_STRIDE, BQ, TOP_K = 64, 32, 16, 2


def _table(rng, n_blocks: int, n_qb: int, hk: int = HK, top_k: int = TOP_K) -> np.ndarray:
    return np.stack([
        rng.choice(n_blocks, size=top_k, replace=False) for _ in range(hk * n_qb)
    ]).reshape(hk, n_qb, top_k).astype(np.int32)


def test_chunk_table_and_first_visit_flags_match_jax():
    """The chunk table is JAX's inline expression (block_sparse.py:607),
    and the first-visit flags are JAX's, on a table with repeats."""
    rng = np.random.default_rng(0)
    for ds, l_slc in ((32, 64), (16, 64), (64, 64)):
        starts = np.arange(0, S - l_slc + 1, ds, dtype=np.int32)
        idx = _table(rng, len(starts), S // BQ)
        want = (
            (starts // ds)[idx][..., None] + np.arange(l_slc // ds, dtype=np.int32)
        ).reshape(HK, S // BQ, -1)
        got = tbs.chunk_table(torch.from_numpy(idx), starts, ds, l_slc)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        n_chunks = S // ds
        np.testing.assert_array_equal(
            tbs.first_visit_flags(got.numpy(), n_chunks),
            np.asarray(jbs.first_visit_flags(jnp.asarray(want), n_chunks)),
        )
    tbl = np.array([[[0, 1, 1, 2], [1, 2, 3, 3]]], np.int32)
    assert tbs.first_visit_flags(tbl, 5).tolist() == [[[1, 1, 0, 1], [0, 0, 1, 0]]]


def test_modeled_slc_bytes_match_jax():
    kw = dict(hk=8, n_qb=512, top_k=16, block_len=64, d_stride=16,
              block_size_q=16, g=4, d=128, dv=128, itemsize=2)
    assert tbs.modeled_slc_bytes(**kw) == jbs.modeled_slc_bytes(**kw)


@pytest.mark.parametrize(
    "table, n_blocks",
    [
        (np.array([[[0, 2], [1, 3]]]), 4),
        (np.array([[[0, 4]]]), 4),
        (np.array([[[2, 2]]]), 4),
        (np.array([[[-1, 0]]]), 4),
        (np.zeros((1, 0, 2), np.int32), 4),
    ],
    ids=["valid", "out_of_range", "duplicate", "negative", "empty"],
)
def test_validate_block_table_matches_jax(table, n_blocks):
    def outcome(fn):
        try:
            fn(table, n_blocks)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(tbs.validate_block_table) == outcome(jbs.validate_block_table)


# (name, S, hq, hk, block_idx, starts, kwargs): each raises in both packages
_BAD_CALLS = {
    "heads": (64, 3, 2, [[[0, 1]] * 4] * 2, [0, 32], dict(block_len=32, block_size_q=16)),
    "block_len": (64, 2, 1, [[[0, 1]] * 4], [0, 32], dict(block_len=48, d_stride=32, block_size_q=16)),
    "seq_stride": (80, 2, 1, [[[0, 1]] * 5], [0, 32], dict(block_len=32, d_stride=32, block_size_q=16)),
    "seq_block_q": (64, 2, 1, [[[0, 1]] * 3], [0, 32], dict(block_len=32, block_size_q=24)),
    "lanes": (384, 2, 1, [[[0]] * 24], [0], dict(block_len=192, block_size_q=16)),
    "range": (64, 2, 1, [[[99, 0]] * 4], [0, 32], dict(block_len=32, block_size_q=16)),
    "duplicate": (64, 2, 1, [[[1, 1]] * 4], [0, 32], dict(block_len=32, block_size_q=16)),
    "aligned": (64, 2, 1, [[[0, 1]] * 4], [0, 16], dict(block_len=32, d_stride=32, block_size_q=16)),
    "past_end": (64, 2, 1, [[[0, 1]] * 4], [0, 48], dict(block_len=32, d_stride=16, block_size_q=16)),
}


@pytest.mark.parametrize("case", sorted(_BAD_CALLS))
def test_block_sparse_attn_errors_match_jax(case):
    seq, hq, hk, idx, starts, kw = _BAD_CALLS[case]
    idx, starts = np.asarray(idx, np.int32), np.asarray(starts, np.int32)
    with pytest.raises(ValueError) as want:
        jbs.block_sparse_attn(
            jnp.zeros((seq, hq, 32)), jnp.zeros((seq, hk, 32)), jnp.zeros((seq, hk, 32)),
            jnp.asarray(idx), starts, **kw,
        )
    with pytest.raises(ValueError) as got:
        tbs.block_sparse_attn(
            torch.zeros(seq, hq, 32), torch.zeros(seq, hk, 32), torch.zeros(seq, hk, 32),
            torch.from_numpy(idx), starts, **kw,
        )
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "g, dtype", [(1, "float32"), (4, "float32"), (4, "bfloat16")], ids=lambda x: str(x)
)
def test_block_sparse_attn_matches_jax(g, dtype):
    """Forward and vjp against the JAX package's block_sparse_attn (its
    Pallas kernels in interpret mode) on the same overlapping stride-32
    blocks; JAX's own bounds for its kernel against the gathered branch
    (float32 2e-5 / 5e-5, bf16 2e-2 / 1e-1). The CPU route is the plain
    versions, one call of each."""
    rng = np.random.default_rng(2)
    hq = HK * g
    starts = np.arange(0, S - L_SLC + 1, D_STRIDE, dtype=np.int32)
    idx = _table(rng, len(starts), S // BQ)
    q, k, v, do = (
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((S, hq, DH), (S, HK, DH), (S, HK, DH), (S, hq, DH))
    )
    kw = dict(block_len=L_SLC, d_stride=D_STRIDE, block_size_q=BQ, softmax_scale=DH ** -0.5)

    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    (out_j, lse_j), vjp = jax.vjp(
        lambda a, b, c: jbs.block_sparse_attn(a, b, c, jnp.asarray(idx), starts, **kw), jq, jk, jv
    )
    grads_j = vjp((jnp.asarray(do, jdt), jnp.zeros_like(lse_j)))

    tdt = getattr(torch, dtype)
    leaves = [torch.tensor(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    tbs.block_sparse_fwd_plain.calls = tbs.block_sparse_bwd_plain.calls = 0
    out_t, lse_t = tbs.block_sparse_attn(*leaves, torch.from_numpy(idx), starts, **kw)
    assert out_t.dtype == tdt and lse_t.dtype == torch.float32 and not lse_t.requires_grad
    grads_t = torch.autograd.grad(out_t, leaves, torch.tensor(do).to(tdt))
    assert (tbs.block_sparse_fwd_plain.calls, tbs.block_sparse_bwd_plain.calls) == (1, 1)

    tol, gtol = (2e-5, 5e-5) if dtype == "float32" else (2e-2, 1e-1)
    np.testing.assert_allclose(
        out_t.detach().float().numpy(), np.asarray(out_j, np.float32), atol=tol, rtol=tol
    )
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=tol, rtol=tol)
    for name, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert a.dtype == tdt, name
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b, np.float32), atol=gtol, rtol=gtol, err_msg=name
        )


def test_plain_versions_count_duplicate_chunks_twice():
    """A chunk named twice in a row doubles its keys' softmax mass: the
    plain forward equals a dense softmax whose logits carry + log 2 on
    those keys, and the plain backward's dk/dv equal autograd through the
    gathered reference (dense softmax over the gathered keys)."""
    rng = np.random.default_rng(4)
    seq, hk, g, d, ds = 64, 1, 2, 16, 16
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((seq, hk * g, d), (seq, hk, d), (seq, hk, d), (seq, hk * g, d))
    )
    ctbl = torch.tensor([[[0, 1, 1, 3]] * (seq // 16)], dtype=torch.int32)  # chunk 1 twice
    params = tbs.BSPParams(softmax_scale=d ** -0.5, d_stride=ds, block_size_q=16)
    out, lse = tbs.block_sparse_fwd_plain(q, k, v, ctbl, params)

    keys = torch.cat([torch.arange(c * ds, (c + 1) * ds) for c in (0, 1, 1, 3)])
    qf = q[:, :, None].expand(seq, hk * g, 1, d)
    s = (qf * k[keys].transpose(0, 1)[None]).sum(-1) * params.softmax_scale  # (seq, hq, L)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        out.numpy(), torch.einsum("shl,ld->shd", torch.softmax(s, -1), v[keys, 0]).numpy(),
        atol=1e-6,
    )

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sg = torch.einsum("shd,ld->shl", leaves[0], leaves[1][keys, 0]) * params.softmax_scale
    ref = torch.einsum("shl,ld->shd", torch.softmax(sg, -1), leaves[2][keys, 0])
    want = torch.autograd.grad(ref, leaves, do)
    delta = (out * do).sum(-1)
    got = tbs.block_sparse_bwd_plain(q, k, v, do, lse, delta, ctbl, params)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)


def test_block_sparse_sources_are_built_at_first_use():
    """B13 and B14 are CUDA C++ sources that kernels/_build.py compiles with
    nvcc for sm_90a; each names the TPU kernel it replaces."""
    for name, kernel in (("block_sparse_fwd", "_bsp_fwd_kernel"), ("block_sparse_bwd", "_bsp_bwd_kernel")):
        assert name in _build.SOURCES
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f"Replaces: magiattention_tpu/kernels/block_sparse.py:{kernel}" in src
        assert '#include "block_sparse.cuh"' in src and "__global__" in src
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


# ---------------------------------------------------------------------------
# B14's key-major dk/dv walk: the transposed table and its sum
# ---------------------------------------------------------------------------


def _chunk_rows(g: int, ds: int, seed: int, seq: int = 512, hk: int = 2):
    """A chunk table over clustered picks (overlapping blocks, so chunks
    named twice), with one row forced to name a chunk twice more; and the
    q, k, v, dO of a g-group at that size."""
    rng = np.random.default_rng(seed)
    starts = np.arange(0, seq - L_SLC + 1, ds, dtype=np.int32)
    n_qb = seq // BQ
    base = rng.integers(0, len(starts) - 8, size=(hk, n_qb, 1))
    offs = np.argsort(rng.random((hk, n_qb, 8)), axis=-1)[..., :4]
    idx = torch.from_numpy((base + offs).astype(np.int32))
    ctbl = tbs.chunk_table(idx, starts, ds, L_SLC).clone()
    ctbl[0, 0, :2] = ctbl[0, 0, 2]  # the first row names one chunk three times
    d = 16
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((seq, hk * g, d), (seq, hk, d), (seq, hk, d), (seq, hk * g, d))
    )
    return ctbl, seq, (q, k, v, do)


def _brute_key_table(ctbl: np.ndarray, seq: int, ds: int):
    """{(h, kt): [(q block, multiplicities per chunk slot)]}: every (kv
    head, key tile) and the rows naming a chunk that overlaps it, by
    looping over rows and tiles."""
    hk, n_qb, _ = ctbl.shape
    slots = tbs.chunk_slots(ds)
    out = {}
    for h in range(hk):
        for kt in range(-(-seq // 64)):
            lo, hi = 64 * kt, min(64 * kt + 64, seq)
            c0 = lo // ds
            visits = []
            for b in range(n_qb):
                mult = [0] * slots
                for c in ctbl[h, b]:
                    if c * ds < hi and (c + 1) * ds > lo:
                        mult[c - c0] += 1
                if any(mult):
                    visits.append((b, mult))
            out[(h, kt)] = visits
    return out


@pytest.mark.parametrize("g, ds", [(1, 16), (4, 16), (1, 32), (4, 32)])
def test_key_table_inverts_the_chunk_table(g, ds):
    """The transposed table equals a brute-force inversion of chunk_table's
    output: per (kv head, key tile) the visiting q blocks, ascending, and
    each one's multiplicities (a chunk named twice or three times counts
    so); pairs ordered by visit count, most first, ties by index."""
    ctbl, seq, _ = _chunk_rows(g, ds, seed=g * ds)
    kt = tbs.key_table(ctbl, seq, ds)
    want = _brute_key_table(ctbl.numpy(), seq, ds)
    hk = ctbl.shape[0]
    assert kt.n_tiles == seq // 64 and kt.slots == tbs.chunk_slots(ds)
    assert kt.mult.max() >= 3  # the forced row
    ptr = kt.ptr.tolist()
    for (h, t), visits in want.items():
        p = h * kt.n_tiles + t
        got = [
            (int(kt.qblock[r]), kt.mult[r].tolist()) for r in range(ptr[p], ptr[p + 1])
        ]
        assert got == visits, (h, t)
    counts = np.diff(ptr)
    assert kt.order.tolist() == sorted(range(hk * kt.n_tiles), key=lambda p: -counts[p])
    assert all(t.dtype == torch.int32 for t in (kt.order, kt.ptr, kt.qblock, kt.mult))


def test_key_table_over_chunks_wider_than_a_tile():
    """d_stride 48 and 128: a chunk overlaps two key tiles, a tile two
    chunks, and the table still inverts by brute force."""
    for ds, seq in ((48, 384), (128, 512)):
        rng = np.random.default_rng(ds)
        ctbl = torch.from_numpy(rng.integers(0, seq // ds, size=(2, 8, 5)).astype(np.int32))
        kt = tbs.key_table(ctbl, seq, ds)
        want = _brute_key_table(ctbl.numpy(), seq, ds)
        for (h, t), visits in want.items():
            p = h * kt.n_tiles + t
            got = [
                (int(kt.qblock[r]), kt.mult[r].tolist())
                for r in range(int(kt.ptr[p]), int(kt.ptr[p + 1]))
            ]
            assert got == visits, (ds, h, t)


def _key_major_dkv(q, k, v, do, lse, delta, kt, params, hk):
    """The dk/dv walk's sum, emulated in float32: per (kv head, key tile),
    per visiting q block, S^T and dP^T over the block's rows, each key row
    of P^T and dS^T weighted by its chunk's multiplicity."""
    S, hq, d = q.shape
    g, bq, ds, scale = hq // hk, params.block_size_q, params.d_stride, params.softmax_scale
    dk, dv = torch.zeros(S, hk, d), torch.zeros(S, hk, v.shape[-1])
    ptr = kt.ptr.tolist()
    for h in range(hk):
        for t in range(kt.n_tiles):
            k0 = 64 * t
            keys = torch.arange(k0, min(k0 + 64, S))
            chunk = keys // ds - k0 // ds
            p = h * kt.n_tiles + t
            for r in range(ptr[p], ptr[p + 1]):
                b = int(kt.qblock[r])
                w = kt.mult[r][chunk].float()  # (keys,)
                qs = slice(b * bq, (b + 1) * bq)
                heads = slice(h * g, (h + 1) * g)
                qq = q[qs, heads].reshape(-1, d)
                dd = do[qs, heads].reshape(-1, v.shape[-1])
                l = lse[qs, heads].reshape(-1)
                de = delta[qs, heads].reshape(-1)
                st = k[keys, h] @ qq.T * scale  # (keys, rows)
                pt = w[:, None] * torch.exp(st - l[None])
                dst = pt * (v[keys, h] @ dd.T - de[None])
                dv[keys, h] += pt @ dd
                dk[keys, h] += scale * dst @ qq
    return dk, dv


@pytest.mark.parametrize("g, ds", [(1, 16), (4, 32)])
def test_key_major_sum_equals_the_plain_backward(g, ds):
    """The key-major sum over the transposed table (the CUDA dk/dv walk's
    arithmetic, in float32 PyTorch) gives block_sparse_bwd_plain's dk and
    dv within float32 1e-5: the weights reproduce a chunk named twice
    counting twice."""
    ctbl, seq, (q, k, v, do) = _chunk_rows(g, ds, seed=40 + g)
    hk = k.shape[1]
    params = tbs.BSPParams(softmax_scale=16 ** -0.5, d_stride=ds, block_size_q=BQ)
    out, lse = tbs.block_sparse_fwd_plain(q, k, v, ctbl, params)
    delta = (out * do).sum(-1)
    _, dk, dv = tbs.block_sparse_bwd_plain(q, k, v, do, lse, delta, ctbl, params)
    kt = tbs.key_table(ctbl, seq, ds)
    got_dk, got_dv = _key_major_dkv(q, k, v, do, lse, delta, kt, params, hk)
    torch.testing.assert_close(got_dk, dk, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_dv, dv, rtol=1e-5, atol=1e-5)


def _extern_c(source: str) -> dict[str, int]:
    found = {}
    for m in re.finditer(r'extern "C" \w+\*? (\w+)\(([^)]*)\)', source):
        found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


@pytest.mark.parametrize("name", sorted(tbs._LIBRARIES))
def test_launch_symbols_are_exported(name):
    """Every ``<prefix>_{f32,bf16}`` the ctypes bindings look up is an
    ``extern "C"`` function of ``csrc/<name>.cu`` with the argument count
    bound (read from the source: nothing compiles here)."""
    exported = _extern_c((_build.CSRC / f"{name}.cu").read_text())
    for prefix in tbs._LIBRARIES[name]:
        for suffix in ("f32", "bf16"):
            assert exported.get(f"{prefix}_{suffix}") == len(tbs._ARGTYPES[prefix]), (prefix, suffix)
