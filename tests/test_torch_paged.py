"""The port's paged KV cache and paged attention against the JAX package's.

The cache operations (assign_pages, append_kv, rollback_kv, gather_kv) must
give arrays equal to JAX's; paged_attn (CPU: the plain FFA version) and the
plain paged decode must be close to JAX's paged_attn and paged_decode_attn
(Pallas interpret mode). Cases: an empty slot, ragged lengths, -1 table
tails, g in {1, 4}. float32 tolerance 1e-5 (different summation orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import paged_kv as jpk
from magiattention_tpu.kernels.paged_decode import (
    paged_decode_attn as jax_paged_decode_attn,
)
from magiattention_tpu_torch.kernels import paged_kv as tpk
from magiattention_tpu_torch.kernels.paged_decode import (
    paged_decode_attn,
    paged_decode_plain,
)
from magiattention_tpu_torch.serving.decode import (
    _dense_decode,
    _gather_ffa_decode,
    decode_attn_step,
)
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

HK, D, PS, NUM_PAGES, P = 2, 16, 8, 16, 4
LENGTHS = [0, 5, 8, 19]  # empty, ragged, page boundary, three pages
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)


def _equal(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def _assert_cache_equal(tc, jc):
    _equal(tc.k_pages, jc.k_pages, "k_pages")
    _equal(tc.v_pages, jc.v_pages, "v_pages")
    _equal(tc.page_table, jc.page_table, "page_table")
    _equal(tc.lengths, jc.lengths, "lengths")


def _build_pair(seed=0):
    """The same pages, table (-1 tails) and ragged lengths in both caches,
    filled by appends in uneven chunks that cross page boundaries."""
    rng = np.random.default_rng(seed)
    tc = tpk.PagedKVCache.create(
        NUM_PAGES, PS, HK, D, len(LENGTHS), P, dtype=torch.float32,
        device="cpu",
    )
    jc = jpk.PagedKVCache.create(
        NUM_PAGES, PS, HK, D, len(LENGTHS), P, dtype=jnp.float32
    )
    free = list(rng.permutation(NUM_PAGES))
    for s, length in enumerate(LENGTHS):
        if length == 0:
            continue
        n = -(-length // PS)
        pages, free = np.asarray(free[:n], np.int32), free[n:]
        tc = tpk.assign_pages(tc, s, pages)
        jc = jpk.assign_pages(jc, s, pages)
        k = rng.standard_normal((length, HK, D)).astype(np.float32)
        v = rng.standard_normal((length, HK, D)).astype(np.float32)
        for a, b in zip([0, 3, 7, 11], [3, 7, 11, length]):
            if b > a:
                tc = tpk.append_kv(tc, s, torch.from_numpy(k[a:b]), torch.from_numpy(v[a:b]))
                jc = jpk.append_kv(jc, s, jnp.asarray(k[a:b]), jnp.asarray(v[a:b]))
    return tc, jc


def test_cache_ops_equal_jax():
    tc, jc = _build_pair()
    _assert_cache_equal(tc, jc)
    # rollback then overwrite in place
    tc = tpk.rollback_kv(tc, 3, 10)
    jc = jpk.rollback_kv(jc, 3, 10)
    _assert_cache_equal(tc, jc)
    rng = np.random.default_rng(5)
    k = rng.standard_normal((4, HK, D)).astype(np.float32)
    tc = tpk.append_kv(tc, 3, torch.from_numpy(k), torch.from_numpy(-k))
    jc = jpk.append_kv(jc, 3, jnp.asarray(k), jnp.asarray(-k))
    _assert_cache_equal(tc, jc)
    for s in range(len(LENGTHS)):
        for max_pages in (None, 2):
            tk, tv = tpk.gather_kv(tc, s, max_pages)
            jk, jv = jpk.gather_kv(jc, s, max_pages)
            _equal(tk, jk, f"gather k slot {s}")
            _equal(tv, jv, f"gather v slot {s}")


def test_cache_is_updated_in_place():
    tc, _ = _build_pair()
    pages = tc.k_pages
    same = tpk.append_kv(tc, 1, torch.ones(1, HK, D), torch.ones(1, HK, D))
    assert same is tc and tc.k_pages is pages
    assert int(tc.lengths[1]) == LENGTHS[1] + 1


@pytest.mark.parametrize("g", [1, 4])
def test_paged_attn_matches_jax(g):
    tc, jc = _build_pair(seed=1)
    rng = np.random.default_rng(2)
    for s, length in enumerate(LENGTHS):
        if length == 0:
            continue
        t = min(3, length)  # a 3-row chunk ending at the slot's length
        q = rng.standard_normal((t, g * HK, D)).astype(np.float32)
        got = tpk.paged_attn(torch.from_numpy(q), tc, s, length - t, P)
        want = jpk.paged_attn(jnp.asarray(q), jc, s, length - t, P)
        assert_close(got[0], np.asarray(want[0]), msg=f"out slot {s}", **TOL)
        assert_close(got[1], np.asarray(want[1]), msg=f"lse slot {s}", **TOL)


@pytest.mark.parametrize("g", [1, 4])
def test_plain_paged_decode_matches_jax(g):
    tc, jc = _build_pair(seed=3)
    q = np.random.default_rng(4).standard_normal(
        (len(LENGTHS), g * HK, D)
    ).astype(np.float32)
    calls = paged_decode_plain.calls
    out, lse = paged_decode_attn(torch.from_numpy(q), tc)
    assert paged_decode_plain.calls == calls + 1  # CPU -> plain version
    jout, jlse = jax_paged_decode_attn(jnp.asarray(q), jc, interpret=True)
    np.testing.assert_array_equal(
        torch.isneginf(lse).numpy(), np.isneginf(np.asarray(jlse))
    )
    assert not out[0].any() and torch.isneginf(lse[0]).all()  # empty slot
    assert_close(out, np.asarray(jout), msg="decode out", **TOL)
    assert_close(lse, np.asarray(jlse), msg="decode lse", **TOL)
    for s, length in enumerate(LENGTHS):  # and the per-slot gather+FFA path
        if length == 0:
            continue
        ro, rl = jpk.paged_attn(jnp.asarray(q[s : s + 1]), jc, s, length - 1, P)
        assert_close(out[s : s + 1], np.asarray(ro), msg=f"vs gather {s}", **TOL)
        assert_close(lse[s : s + 1], np.asarray(rl), msg=f"vs gather {s}", **TOL)


def test_decode_helpers_agree_with_the_plain_decode():
    """decode_attn_step (CPU: plain version) against the per-slot
    gather+FFA and dense helpers the oracle and tests may call."""
    tc, _ = _build_pair(seed=6)
    q = torch.from_numpy(
        np.random.default_rng(7).standard_normal((len(LENGTHS), 4 * HK, D))
        .astype(np.float32)
    )
    out, lse = decode_attn_step(q, tc)
    for helper in (_gather_ffa_decode, _dense_decode):
        ho, hl = helper(q, tc, LENGTHS)
        assert_close(out, ho, msg=helper.__name__, **TOL)
        assert_close(lse, hl, msg=helper.__name__, **TOL)


def test_dead_pages_never_contribute():
    """Poisoning every page a slot does not own leaves the plain decode's
    output unchanged (the -1 tails clamp to page 0, masked by length)."""
    tc, _ = _build_pair(seed=8)
    q = torch.randn(len(LENGTHS), 2 * HK, D, generator=torch.Generator().manual_seed(0))
    clean = paged_decode_plain(q, tc)
    owned = set(tc.page_table[tc.page_table >= 0].tolist())
    for pid in range(NUM_PAGES):
        if pid not in owned:
            tc.k_pages[pid] = 1e9
            tc.v_pages[pid] = 1e9
    poisoned = paged_decode_plain(q, tc)
    for a, b in zip(clean, poisoned):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
