"""ROADMAP C4 on the CPU: the padding that takes head dims other than 64
and 128 through the port's CUDA kernels (``kernels/head_dims.py``).

The kernels are compiled at head dims 64 and 128 with equal q/k and v
widths; a CUDA call with other ``d, dv <= 128`` pads with zero columns to
the smallest compiled width that holds both, runs the kernel and slices the
logical columns back. The kernels run on the card only; what the CPU checks
is the padding's arithmetic: the width per (d, dv), that the padded
problem through each family's plain version, sliced, equals the unpadded
one and the JAX package's ``ffa_attn``, with the true d's softmax scale,
that d == dv in (64, 128) is passed through with no copy, and that above
128 the helper raises naming the limit. The paged cache keeps its pages at
the kernels' width on the card; a padded cache built here by hand (the
layout ``PagedKVCache.create`` gives on the card) appends, gathers and
decodes as the logical one does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from magiattention_tpu.kernels import ffa as jffa
from magiattention_tpu_torch.kernels import block_sparse as tbs
from magiattention_tpu_torch.kernels import ffa as tffa
from magiattention_tpu_torch.kernels import paged_decode as tpd
from magiattention_tpu_torch.kernels.head_dims import (
    MAX_HEAD_DIM,
    kernel_head_dim,
    pad_head_dim,
    pad_to_kernel_width,
)
from magiattention_tpu_torch.kernels.paged_kv import (
    PagedKVCache,
    append_kv,
    assign_pages,
    gather_kv,
)
from magiattention_tpu_torch.kernels.sdpa import sdpa_attn
from tests.torch_port_cases import MASKS

# (d, dv) of ROADMAP C4's cases
DIMS = [(32, 32), (96, 96), (64, 128)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "d, dv, width",
    [(32, 32, 64), (96, 96, 128), (64, 128, 128), (128, 64, 128), (1, 1, 64),
     (64, 64, 64), (128, 128, 128), (65, 16, 128)],
)
def test_kernel_head_dim(d, dv, width):
    assert kernel_head_dim(d, dv) == width


@pytest.mark.parametrize("d, dv", [(192, 192), (64, 192), (129, 8)])
def test_above_the_limit_raises_naming_it(d, dv):
    with pytest.raises(ValueError, match=str(MAX_HEAD_DIM)):
        kernel_head_dim(d, dv)


def test_kernel_widths_pass_through_without_a_copy():
    for d in (64, 128):
        ts = [torch.zeros(8, 2, d) for _ in range(4)]
        assert all(a is b for a, b in zip(pad_to_kernel_width(*ts), ts))
    q = torch.ones(3, 2, 32)
    padded = pad_to_kernel_width(q, q, torch.ones(3, 2, 96))
    assert [t.shape[-1] for t in padded] == [128] * 3
    assert torch.equal(padded[0][..., :32], q) and not padded[0][..., 32:].any()


def _ffa_inputs(rng, d, dv, mask="varlen", hq=4, hk=2):
    qr, kr, lo, hi, sq, sk = MASKS[mask]
    q = rng.standard_normal((sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((sk, hk, dv)).astype(np.float32)
    do = rng.standard_normal((sq, hq, dv)).astype(np.float32)
    return (qr, kr, lo, hi, sq, sk), q, k, v, do


@pytest.mark.parametrize("d, dv", DIMS, ids=lambda x: str(x))
def test_ffa_padded_plain_equals_unpadded_and_jax(d, dv):
    """pad -> plain -> slice, forward and the backward's plain versions,
    against the unpadded plain versions and JAX's ffa_attn (its Pallas
    kernel in interpret mode), the scale the true d's."""
    rng = np.random.default_rng(d + dv)
    (qr, kr, lo, hi, sq, sk), q, k, v, do = _ffa_inputs(rng, d, dv)
    scale = d ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    width = kernel_head_dim(d, dv)
    pq, pk, pv, pdo = pad_to_kernel_width(tq, tk, tv, tdo)
    assert {t.shape[-1] for t in (pq, pk, pv, pdo)} == {width}
    kw = dict(softmax_scale=scale, d_lo=lo, d_hi=hi)

    out, lse = sdpa_attn(tq, tk, tv, qr, kr, **kw)
    pout, plse = sdpa_attn(pq, pk, pv, qr, kr, **kw)
    assert not pout[..., dv:].any()
    torch.testing.assert_close(pout[..., :dv], out, **TOL)
    torch.testing.assert_close(plse, lse, **TOL)
    jout, jlse = jffa.ffa_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qr, kr,
        softmax_scale=scale, d_lo=lo, d_hi=hi,
    )
    np.testing.assert_allclose(pout[..., :dv].numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), **TOL)

    plan, params = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, d, None, 0.0)
    assert params.softmax_scale == scale
    delta = tffa.ffa_delta_plain(out, tdo)
    torch.testing.assert_close(tffa.ffa_delta_plain(pout, pdo), delta, **TOL)
    want = tffa.ffa_bwd_fused_plain(tq, tk, tv, tdo, lse, delta, plan, params)
    got = tffa.ffa_bwd_fused_plain(pq, pk, pv, pdo, plse, delta, plan, params)
    for name, g, w, n in zip(("dq", "dk", "dv"), got, want, (d, d, dv)):
        assert not g[..., n:].any(), name
        torch.testing.assert_close(g[..., :n], w, **TOL, msg=name)
    # the route choice sees the padded width
    assert tffa.ffa_bwd_mode(plan, params, width, width, 4, 4, 2) in ("split", "fused")


@pytest.mark.parametrize("d, dv", DIMS, ids=lambda x: str(x))
def test_block_sparse_padded_plain_equals_unpadded(d, dv):
    """_BSPCore's padding on the plain versions: the padded forward and
    backward, sliced, equal the unpadded ones."""
    rng = np.random.default_rng(7 + d)
    seq, hk, g, ds = 128, 2, 2, 16
    starts = np.arange(0, seq - 32 + 1, ds, dtype=np.int32)
    idx = torch.from_numpy(np.stack([
        rng.choice(len(starts), size=2, replace=False) for _ in range(hk * seq // 16)
    ]).reshape(hk, seq // 16, 2).astype(np.int32))
    ctbl = tbs.chunk_table(idx, starts, ds, 32)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((seq, hk * g, d), (seq, hk, d), (seq, hk, dv), (seq, hk * g, dv))
    )
    params = tbs.BSPParams(softmax_scale=d ** -0.5, d_stride=ds, block_size_q=16)
    out, lse = tbs.block_sparse_fwd_plain(q, k, v, ctbl, params)
    pq, pk, pv, pdo = pad_to_kernel_width(q, k, v, do)
    pout, plse = tbs.block_sparse_fwd_plain(pq, pk, pv, ctbl, params)
    torch.testing.assert_close(pout[..., :dv], out, **TOL)
    torch.testing.assert_close(plse, lse, **TOL)
    delta = (out * do).sum(-1)
    want = tbs.block_sparse_bwd_plain(q, k, v, do, lse, delta, ctbl, params)
    got = tbs.block_sparse_bwd_plain(pq, pk, pv, pdo, plse, delta, ctbl, params)
    for name, gt, w, n in zip(("dq", "dk", "dv"), got, want, (d, d, dv)):
        assert not gt[..., n:].any(), name
        torch.testing.assert_close(gt[..., :n], w, **TOL, msg=name)


def _padded_cache(d, dv, dtype, width):
    """The layout PagedKVCache.create gives on the card: pages at the
    kernels' width, the logical dims kept."""
    num_pages, ps, hk, slots, P = 16, 8, 2, 3, 6
    scales = (torch.zeros((num_pages, hk)) if dtype == torch.int8 else None)
    return PagedKVCache(
        k_pages=torch.zeros((num_pages, ps, hk, width), dtype=dtype),
        v_pages=torch.zeros((num_pages, ps, hk, width), dtype=dtype),
        page_table=torch.full((slots, P), -1, dtype=torch.int32),
        lengths=torch.zeros((slots,), dtype=torch.int32),
        k_scales=scales, v_scales=None if scales is None else scales.clone(),
        head_dim=d, head_dim_v=dv,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8], ids=str)
@pytest.mark.parametrize("d, dv", DIMS, ids=lambda x: str(x))
def test_padded_pages_append_gather_and_decode_as_logical(d, dv, dtype):
    """A cache whose pages are wider than its head dims: appends write zero
    columns (int8 scales unchanged), gathers and the decode plain versions
    read the logical columns, equal to a logical-width cache's."""
    rng = np.random.default_rng(d * dv)
    logical = PagedKVCache.create(16, 8, 2, d, 3, 6, dtype=dtype, device="cpu", head_dim_v=dv)
    assert (logical.head_dim, logical.head_dim_v) == (d, dv)
    assert (logical.k_pages.shape[-1], logical.v_pages.shape[-1]) == (d, dv)
    padded = _padded_cache(d, dv, dtype, kernel_head_dim(d, dv))
    for cache in (logical, padded):
        for s, pages in enumerate(([0, 1, 2], [5, 6], [9, 10, 11])):
            assign_pages(cache, s, pages)
    for s, n in ((0, 19), (1, 9), (2, 1)):
        k_new = torch.from_numpy(rng.standard_normal((n, 2, d)).astype(np.float32))
        v_new = torch.from_numpy(rng.standard_normal((n, 2, dv)).astype(np.float32))
        for cache in (logical, padded):
            append_kv(cache, s, k_new, v_new)
    assert not padded.k_pages[..., d:].any() and not padded.v_pages[..., dv:].any()
    if dtype == torch.int8:
        assert torch.equal(padded.k_scales, logical.k_scales)
        assert torch.equal(padded.v_scales, logical.v_scales)
    for s in range(3):
        for a, b in zip(gather_kv(padded, s), gather_kv(logical, s)):
            assert torch.equal(a, b)
    q = torch.from_numpy(rng.standard_normal((3, 4, d)).astype(np.float32))
    q2 = torch.from_numpy(rng.standard_normal((3, 2, 4, d)).astype(np.float32))
    plains = (
        [(tpd.paged_decode_int8_plain, q)] if dtype == torch.int8
        else [(tpd.paged_decode_plain, q), (tpd.paged_decode_spec_plain, q2)]
    )
    for plain, qq in plains:
        got, want = plain(qq, padded), plain(qq, logical)
        assert got[0].shape[-1] == dv
        for a, b in zip(got, want):
            assert torch.equal(a, b), plain.__name__


def test_cache_create_raises_above_the_limit_only_on_the_card():
    """The CPU cache keeps any width (its plain versions take any); the
    card's pages are the kernels' width, so create raises above 128 there.
    The CPU sees the width it would allocate."""
    PagedKVCache.create(4, 8, 1, 192, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="128"):
        kernel_head_dim(192, 192)


def test_padding_helper_rejects_narrowing():
    with pytest.raises(ValueError):
        pad_head_dim(torch.zeros(2, 65), 64)
