"""The port's int8 KV cache against the JAX package's, on the CPU.

Quantized append (codes and per-(page, kv head) scales) must be EQUAL to
JAX's after a sequence of appends, a rollback and overwrite, and a release
with ``reset_page_scales`` then reuse; the wave-batched append the card
runs must be equal to the row-by-row loop; ``gather_kv``'s dequantization
must equal JAX's; ``paged_decode_int8_plain`` (the plain version of kernel
B12) must be within float32 1e-5 of JAX's ``paged_decode_attn_int8``
(Pallas in interpret mode); the page accounting must equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import paged_kv as jpk
from magiattention_tpu.kernels.paged_decode import (
    paged_decode_attn_int8 as jax_paged_decode_attn_int8,
)
from magiattention_tpu.serving import cache as jcache
from magiattention_tpu_torch.kernels import paged_kv as tpk
from magiattention_tpu_torch.kernels.paged_decode import (
    paged_decode_attn_int8,
    paged_decode_int8_plain,
)
from magiattention_tpu_torch.serving import cache as tcache
from magiattention_tpu_torch.serving.decode import decode_attn_step
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

HK, D, PS, NUM_PAGES, P = 2, 16, 8, 16, 5
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)


def _equal(t, j, msg):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def _assert_cache_equal(tc, jc, stage):
    for name in ("k_pages", "v_pages", "k_scales", "v_scales", "page_table", "lengths"):
        _equal(getattr(tc, name), getattr(jc, name), f"{stage}: {name}")


def _rows(rng, n, spread=1.0):
    """k/v rows whose magnitudes vary row to row, so later rows raise their
    page's scale and rescale the codes already stored."""
    mag = rng.uniform(0.25, 3.0, (n, 1, 1)) * spread
    k = (rng.standard_normal((n, HK, D)) * mag).astype(np.float32)
    v = (rng.standard_normal((n, HK, D)) * mag[::-1]).astype(np.float32)
    return k, v


def _append(tc, jc, slot, k, v):
    tc = tpk.append_kv(tc, slot, torch.from_numpy(k), torch.from_numpy(v))
    jc = jpk.append_kv(jc, slot, jnp.asarray(k), jnp.asarray(v))
    return tc, jc


def _int8_pair():
    tc = tpk.PagedKVCache.create(NUM_PAGES, PS, HK, D, 2, P, dtype=torch.int8, device="cpu")
    jc = jpk.PagedKVCache.create(NUM_PAGES, PS, HK, D, 2, P, dtype=jnp.int8)
    return tc, jc


def test_create_int8_cache():
    tc, jc = _int8_pair()
    assert tc.quantized and jc.quantized
    assert tc.k_pages.dtype == torch.int8
    _assert_cache_equal(tc, jc, "create")
    f32 = tpk.PagedKVCache.create(4, PS, HK, D, 1, 2, dtype=torch.float32, device="cpu")
    assert not f32.quantized and f32.k_scales is None


def test_quantized_sequence_equals_jax():
    """Codes and scales equal JAX's at every stage of a slot's life."""
    rng = np.random.default_rng(0)
    tc, jc = _int8_pair()
    pages = np.array([9, 2, 14, 5, 11], np.int32)
    tc, jc = tpk.assign_pages(tc, 0, pages), jpk.assign_pages(jc, 0, pages)
    # a prefill chunk that starts mid-page and crosses two page boundaries
    tc, jc = _append(tc, jc, 0, *_rows(rng, 3))
    tc, jc = _append(tc, jc, 0, *_rows(rng, 19))
    _assert_cache_equal(tc, jc, "prefill")
    for i in range(4):  # single-row decode appends, one of them larger
        tc, jc = _append(tc, jc, 0, *_rows(rng, 1, spread=4.0 if i == 2 else 1.0))
    _assert_cache_equal(tc, jc, "decode")
    # rollback into the previous page, then overwrite the rejected rows
    tc, jc = tpk.rollback_kv(tc, 0, 21), jpk.rollback_kv(jc, 0, 21)
    tc, jc = _append(tc, jc, 0, *_rows(rng, 6, spread=0.5))
    _assert_cache_equal(tc, jc, "rollback + overwrite")
    for stage in ("decode", "rollback + overwrite"):
        for max_pages in (None, 2):
            tk, tv = tpk.gather_kv(tc, 0, max_pages)
            jk, jv = jpk.gather_kv(jc, 0, max_pages)
            assert tk.dtype == torch.float32
            _equal(tk, jk, f"gather k {stage}")
            _equal(tv, jv, f"gather v {stage}")
    # release: scales reset, then the pages serve another slot
    tc = tcache.reset_page_scales(tc, pages.tolist())
    tc = tcache.release_slot(tc, 0)
    jc = jcache.reset_page_scales(jc, pages.tolist())
    jc = jcache.release_slot(jc, 0)
    _assert_cache_equal(tc, jc, "release")
    assert not tc.k_scales[pages].any()
    reuse = pages[[3, 0]]
    tc, jc = tpk.assign_pages(tc, 1, reuse), jpk.assign_pages(jc, 1, reuse)
    tc, jc = _append(tc, jc, 1, *_rows(rng, 11))
    _assert_cache_equal(tc, jc, "reuse")


@pytest.mark.parametrize("start,t", [(0, 1), (5, 1), (0, 16), (3, 29), (7, 40), (13, 9)])
def test_wave_append_equals_the_loop(start, t):
    """The card's wave-batched quantized append gives the row-by-row
    loop's bits, for appends that start mid-page and span pages."""
    rng = np.random.default_rng(start * 100 + t)
    pages = torch.from_numpy(rng.integers(-127, 128, (NUM_PAGES, PS, HK, D)).astype(np.int8))
    # old scales around what the rows need, so some rows raise them
    scales = torch.from_numpy(rng.uniform(0.0, 5e-4, (NUM_PAGES, HK)).astype(np.float32))
    scales[3] = 0.0  # a fresh page among used ones
    table = torch.from_numpy(rng.permutation(NUM_PAGES)[:8].astype(np.int64))
    pos = start + torch.arange(t)
    page_idx, row = table[pos // PS], pos % PS
    x = torch.from_numpy(_rows(rng, t, spread=0.02)[0])
    waves = tpk.append_waves(start, t, PS)
    assert len(waves) <= min(t, PS)
    assert sorted(i for w in waves for i in w) == list(range(t))
    for w in waves:  # a wave's pages are distinct
        assert len(set(page_idx[w].tolist())) == len(w)
    loop_pages, loop_scales = pages.clone(), scales.clone()
    scales_before = scales.clone()
    tpk._quantize_append(loop_pages, loop_scales, page_idx, row, x)
    tpk._quantize_append_waves(pages, scales, page_idx, row, x, start)
    assert (loop_scales > scales_before).any()  # some row raised a scale
    torch.testing.assert_close(pages, loop_pages, rtol=0, atol=0)
    torch.testing.assert_close(scales, loop_scales, rtol=0, atol=0)


def _decode_pair(seed):
    rng = np.random.default_rng(seed)
    lengths = [0, 5, 8, 19, 33]
    tc = tpk.PagedKVCache.create(24, PS, HK, D, len(lengths), P, dtype=torch.int8, device="cpu")
    jc = jpk.PagedKVCache.create(24, PS, HK, D, len(lengths), P, dtype=jnp.int8)
    free = list(rng.permutation(24))
    for s, length in enumerate(lengths):
        if length == 0:
            continue
        n = -(-length // PS)
        pages, free = np.asarray(free[:n], np.int32), free[n:]
        tc, jc = tpk.assign_pages(tc, s, pages), jpk.assign_pages(jc, s, pages)
        k, v = _rows(rng, length)
        for a, b in zip([0, 6, 9], [6, 9, length]):
            if b > a:
                tc, jc = _append(tc, jc, s, k[a:b], v[a:b])
    _assert_cache_equal(tc, jc, "decode cache")
    return tc, jc, lengths


@pytest.mark.parametrize("g", [1, 4])
def test_int8_plain_matches_jax(g):
    tc, jc, lengths = _decode_pair(seed=g)
    q = np.random.default_rng(10 + g).standard_normal(
        (len(lengths), g * HK, D)
    ).astype(np.float32)
    calls = paged_decode_int8_plain.calls
    out, lse = paged_decode_attn_int8(torch.from_numpy(q), tc)
    assert paged_decode_int8_plain.calls == calls + 1  # CPU -> plain version
    jout, jlse = jax_paged_decode_attn_int8(jnp.asarray(q), jc, interpret=True)
    assert not out[0].any() and torch.isneginf(lse[0]).all()  # empty slot
    np.testing.assert_array_equal(torch.isneginf(lse).numpy(), np.isneginf(np.asarray(jlse)))
    assert_close(out, np.asarray(jout), msg="int8 decode out", **TOL)
    assert_close(lse, np.asarray(jlse), msg="int8 decode lse", **TOL)
    # decode_attn_step routes an int8 cache to the int8 version
    calls = paged_decode_int8_plain.calls
    step_out, _ = decode_attn_step(torch.from_numpy(q), tc)
    assert paged_decode_int8_plain.calls == calls + 1
    torch.testing.assert_close(step_out, out, rtol=0, atol=0)


def test_page_accounting_equals_jax():
    for args in (dict(page_size=16, n_kv_heads=8, head_dim=128),
                 dict(page_size=8, n_kv_heads=2, head_dim=16, head_dim_v=32)):
        for dt in ("float32", "bfloat16", "int8"):
            got = tcache.kv_page_bytes(kv_dtype=dt, **args)
            assert got == jcache.kv_page_bytes(kv_dtype=dt, **args), (args, dt)
            for budget, per_slot in ((64 << 20, 64), (80 << 30, 256), (1000, 3)):
                assert tcache.slot_residency(budget, got, per_slot) == (
                    jcache.slot_residency(budget, got, per_slot)
                )
