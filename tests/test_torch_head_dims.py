"""ROADMAP C4 and C4b on the CPU: the padding that takes head dims other
than 64, 128 and 256 through the port's CUDA kernels
(``kernels/head_dims.py``).

The kernels are compiled at head dims 64, 128 and 256 with equal q/k and v
widths; a CUDA call with other ``d, dv <= 256`` pads with zero columns to
the smallest compiled width that holds both, runs the kernel and slices the
logical columns back. The kernels run on the card only; what the CPU checks
is the padding's arithmetic: the width per (d, dv), that the padded
problem through each family's plain version, sliced, equals the unpadded
one and the JAX package's ``ffa_attn``, with the true d's softmax scale,
that d == dv in (64, 128, 256) is passed through with no copy, and that
above 256 the helper raises naming the limit (ROADMAP C4c). The paged
cache keeps its pages at the kernels' width on the card; a padded cache
built here by hand (the layout ``PagedKVCache.create`` gives on the card)
appends, gathers and decodes as the logical one does. C4b's widths are
public models': d 256 (Gemma-2/3), d 192 with dv 128 (DeepSeek-V3's MLA),
and d 256 with dv 128."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magiattention_tpu.kernels import block_sparse as jbs
from magiattention_tpu.kernels import ffa as jffa
from magiattention_tpu.kernels import paged_decode as jpd
from magiattention_tpu.kernels import paged_kv as jpk
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

# (d, dv) of ROADMAP C4's and C4b's cases
DIMS = [(32, 32), (96, 96), (64, 128), (256, 256), (192, 128), (256, 128)]
C4B_DIMS = DIMS[3:]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "d, dv, width",
    [(32, 32, 64), (96, 96, 128), (64, 128, 128), (128, 64, 128), (1, 1, 64),
     (64, 64, 64), (128, 128, 128), (65, 16, 128), (129, 129, 256),
     (192, 192, 256), (200, 200, 256), (256, 256, 256), (192, 128, 256),
     (256, 128, 256), (8, 129, 256)],
)
def test_kernel_head_dim(d, dv, width):
    assert kernel_head_dim(d, dv) == width


@pytest.mark.parametrize("d, dv", [(257, 257), (64, 320), (512, 8)])
def test_above_the_limit_raises_naming_it(d, dv):
    assert MAX_HEAD_DIM == 256
    with pytest.raises(ValueError, match=str(MAX_HEAD_DIM)) as err:
        kernel_head_dim(d, dv)
    assert "C4c" in str(err.value)


def test_kernel_widths_pass_through_without_a_copy():
    for d in (64, 128, 256):
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
    card's pages are the kernels' width, so create raises above 256 there.
    The CPU sees the width it would allocate."""
    PagedKVCache.create(4, 8, 1, 320, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="256"):
        kernel_head_dim(320, 320)


def test_padding_helper_rejects_narrowing():
    with pytest.raises(ValueError):
        pad_head_dim(torch.zeros(2, 65), 64)


def _bsp_case(rng, d, dv, seq=128, hk=1, g=2, ds=16, top=2):
    starts = np.arange(0, seq - 32 + 1, ds, dtype=np.int32)
    idx = np.stack([
        rng.choice(len(starts), size=top, replace=False) for _ in range(hk * seq // 16)
    ]).reshape(hk, seq // 16, top).astype(np.int32)
    q, k, v, do = (
        rng.standard_normal(s).astype(np.float32)
        for s in ((seq, hk * g, d), (seq, hk, d), (seq, hk, dv), (seq, hk * g, dv))
    )
    return starts, idx, q, k, v, do


@pytest.mark.parametrize("d, dv", C4B_DIMS, ids=lambda x: str(x))
def test_block_sparse_padded_plain_equals_jax(d, dv):
    """C4b's widths through _BSPCore's padding on the plain pair (pad ->
    plain -> slice), forward and backward, against the JAX package's
    block_sparse_attn and its vjp (Pallas in interpret mode), which take
    these widths (d != dv included), float32 1e-5; 2 query heads."""
    rng = np.random.default_rng(11 + d + dv)
    starts, idx, q, k, v, do = _bsp_case(rng, d, dv)
    kw = dict(block_len=32, d_stride=16, block_size_q=16)
    params = tbs.BSPParams(softmax_scale=d ** -0.5, d_stride=16, block_size_q=16)
    ctbl = tbs.chunk_table(torch.from_numpy(idx), starts, 16, 32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    pq, pk, pv, pdo = pad_to_kernel_width(tq, tk, tv, tdo)
    assert {t.shape[-1] for t in (pq, pk, pv, pdo)} == {256}
    pout, plse = tbs.block_sparse_fwd_plain(pq, pk, pv, ctbl, params)
    delta = (pout[..., :dv] * tdo).sum(-1)
    grads = tbs.block_sparse_bwd_plain(pq, pk, pv, pdo, plse, delta, ctbl, params)
    (jout, jlse), vjp = jax.vjp(
        lambda a, b, c: jbs.block_sparse_attn(
            a, b, c, jnp.asarray(idx), starts, softmax_scale=d ** -0.5, interpret=True, **kw
        ),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    jgrads = vjp((jnp.asarray(do), jnp.zeros_like(jlse)))
    assert not pout[..., dv:].any()
    np.testing.assert_allclose(pout[..., :dv].numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse), **TOL)
    for name, g, jg, n in zip(("dq", "dk", "dv"), grads, jgrads, (d, d, dv)):
        assert not g[..., n:].any(), name
        np.testing.assert_allclose(g[..., :n].numpy(), np.asarray(jg), **TOL, err_msg=name)


@pytest.mark.parametrize("d, dv", C4B_DIMS, ids=lambda x: str(x))
def test_paged_decode_padded_256_cache(d, dv):
    """A 256-wide padded cache (the layout PagedKVCache.create gives on the
    card at C4b's widths) on the CPU path: appends leave the pad columns
    zero, and the decode plain walk, sliced, equals the unpadded one and,
    where d == dv, the JAX package's paged_decode_attn (interpret mode) on
    a logical cache: the JAX cache holds one head dim for k and v, so at
    d != dv the unpadded plain walk is the only reference."""
    rng = np.random.default_rng(d * 3 + dv)
    num_pages, ps, hk, lengths, P = 8, 8, 1, [0, 5, 19], 3
    logical = PagedKVCache.create(num_pages, ps, hk, d, 3, P, dtype=torch.float32, device="cpu",
                                  head_dim_v=dv)
    padded = PagedKVCache(
        k_pages=torch.zeros((num_pages, ps, hk, 256)),
        v_pages=torch.zeros((num_pages, ps, hk, 256)),
        page_table=torch.full((3, P), -1, dtype=torch.int32),
        lengths=torch.zeros((3,), dtype=torch.int32),
        head_dim=d, head_dim_v=dv,
    )
    jc = jpk.PagedKVCache.create(num_pages, ps, hk, d, 3, P, dtype=jnp.float32) if d == dv else None
    free = list(rng.permutation(num_pages))
    for s, n in enumerate(lengths):
        if n == 0:
            continue
        pages, free = np.asarray(free[: -(-n // ps)], np.int32), free[-(-n // ps):]
        k = rng.standard_normal((n, hk, d)).astype(np.float32)
        v = rng.standard_normal((n, hk, dv)).astype(np.float32)
        for cache in (logical, padded):
            assign_pages(cache, s, pages)
            append_kv(cache, s, torch.from_numpy(k), torch.from_numpy(v))
        if jc is not None:
            jc = jpk.assign_pages(jc, s, pages)
            jc = jpk.append_kv(jc, s, jnp.asarray(k), jnp.asarray(v))
    assert not padded.k_pages[..., d:].any() and not padded.v_pages[..., dv:].any()
    q = rng.standard_normal((3, 2 * hk, d)).astype(np.float32)
    got = tpd.paged_decode_plain(torch.from_numpy(q), padded, d ** -0.5)
    want = tpd.paged_decode_plain(torch.from_numpy(q), logical, d ** -0.5)
    assert got[0].shape[-1] == dv
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)
    if jc is not None:
        jout, jlse = jpd.paged_decode_attn(jnp.asarray(q), jc, softmax_scale=d ** -0.5,
                                           interpret=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize(
    "guard, args, want",
    [("fwd_pack_smem_bytes", (256, 1, 2), 99_344), ("fwd_pack_smem_bytes", (256, 2, 2), 197_664),
     ("fwd_pack_smem_bytes", (256, 1, 4), 230_416), ("dq_pack_smem_bytes", (256, 1, 2), 205_824),
     ("dq_pack_smem_bytes", (256, 1, 4), 155_648), ("dkv_smem_bytes", (256, 2), 231_424),
     ("dkv_smem_bytes", (256, 4), 176_640), ("fused_bwd_smem_bytes", (256, 2), 231_424),
     ("fwd_pack_heads", (8, 256, 256, 2), 2), ("fwd_pack_heads", (8, 256, 256, 4), 1),
     ("dq_pack_heads", (8, 256, 256, 2), 2), ("dq_pack_heads", (8, 256, 256, 4), 1),
     ("fused_bwd_feasible", (256, 256), True)],
    ids=lambda x: str(x),
)
def test_256_guards(guard, args, want):
    """The pack and mode guards at the 256 instances: each CTA's shared
    memory as the kernels' ``*_smem_bytes`` exports report it (the bf16
    forward's full-width v tiles, the bf16 dq pass's dS tile, the bf16
    k-major backward's four P^T / dS^T tiles, the float32 bodies' 128-wide
    chunks), packing where it fits (bf16 two heads, forward and dq), never
    raising."""
    assert getattr(tffa, guard)(*args) == want


def test_cost_model_prices_the_column_split():
    """At 256 a kernel that splits its columns (every float32 body) runs
    twice the CTAs, each doing its half's products beside S and dP over
    the full width: a CTA's per-(item, head) time is
    (2 * 256 + products * 128) / (128 * (2 + products)) of its time at 128;
    the bf16 dq, dk/dv and fused kernels run one CTA an SM. Every modeled time
    exceeds the 128 instance's, and ``column_halves`` without a family is
    the splitting kernels' (tests/test_torch_d256.py: per family)."""
    from magiattention_tpu_torch.kernels import tile_policy as tp

    assert tp.width_scale(128, (2, 1)) == 1.0 and tp.width_scale(64, (2, 4)) == 0.5
    assert tp.width_scale(256, (2, 1)) == pytest.approx(640 / 384)
    qr, kr, lo, hi, sq, sk = MASKS["causal"]
    plan, _ = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, 64, None, 0.0)
    for isz in (2, 4):
        t = {d: tp.kernel_ms(tffa.bwd_shape(plan, 4, 2, d, d, isz)) for d in (128, 256)}
        assert all(t[256][k] > t[128][k] for k in ("dq", "dkv", "fused")), t
    assert tp.column_halves(256) == 2 and tp.column_halves(128) == tp.column_halves(64) == 1
