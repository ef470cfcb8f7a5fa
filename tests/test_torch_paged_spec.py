"""The port's speculative-verify decode against the JAX package's, on the CPU.

``paged_decode_spec_plain`` (the plain version of kernel B11) against JAX's
``paged_decode_attn_spec`` (Pallas in interpret mode), out and lse, for
g in {1, 2, 4} and spec_k in {1, 2, 3} on pages of 8, with slot lengths
covering 0, lengths below spec_k (empty leading rows) and page boundaries;
then the port's verify routes against the plain version. float32 tolerance
1e-5 (the two packages sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import paged_kv as jpk
from magiattention_tpu.kernels.paged_decode import (
    paged_decode_attn_spec as jax_paged_decode_attn_spec,
)
from magiattention_tpu_torch.kernels import _build
from magiattention_tpu_torch.kernels import paged_kv as tpk
from magiattention_tpu_torch.kernels.paged_decode import (
    paged_decode_attn_spec,
    paged_decode_int8_kernel,
    paged_decode_plain,
    paged_decode_spec_kernel,
    paged_decode_spec_plain,
)
from magiattention_tpu_torch.serving.decode import (
    _dense_verify,
    _gather_ffa_verify,
    verify_attn_step,
)
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

HK, D, PS, NUM_PAGES, P = 2, 16, 8, 24, 4
LENGTHS = [0, 1, 2, 8, 16, 19, 32]  # empty, below spec_k, page boundaries
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)


def _build_pair(seed, dtype="float32"):
    """The same pages, table (-1 tails) and lengths in both packages'
    caches, filled by appends of uneven size that cross page boundaries."""
    rng = np.random.default_rng(seed)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "int8": (torch.int8, jnp.int8)}[dtype]
    tc = tpk.PagedKVCache.create(
        NUM_PAGES, PS, HK, D, len(LENGTHS), P, dtype=tdt, device="cpu"
    )
    jc = jpk.PagedKVCache.create(NUM_PAGES, PS, HK, D, len(LENGTHS), P, dtype=jdt)
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
        for a, b in zip([0, 5, 11], [5, 11, length]):
            if b > a:
                tc = tpk.append_kv(tc, s, torch.from_numpy(k[a:b]), torch.from_numpy(v[a:b]))
                jc = jpk.append_kv(jc, s, jnp.asarray(k[a:b]), jnp.asarray(v[a:b]))
    return tc, jc


def _q(seed, spec_k, g):
    return np.random.default_rng(seed).standard_normal(
        (len(LENGTHS), spec_k, g * HK, D)
    ).astype(np.float32)


@pytest.mark.parametrize("spec_k", [1, 2, 3])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_spec_plain_matches_jax(g, spec_k):
    tc, jc = _build_pair(seed=10 + g)
    q = _q(20 + spec_k, spec_k, g)
    calls = paged_decode_spec_plain.calls
    out, lse = paged_decode_attn_spec(torch.from_numpy(q), tc)
    assert paged_decode_spec_plain.calls == calls + 1  # CPU -> plain version
    jout, jlse = jax_paged_decode_attn_spec(jnp.asarray(q), jc, interpret=True)
    np.testing.assert_array_equal(
        torch.isneginf(lse).numpy(), np.isneginf(np.asarray(jlse))
    )
    for s, length in enumerate(LENGTHS):  # rows with nothing live: (0, -inf)
        for t in range(spec_k):
            empty = length - (spec_k - 1 - t) <= 0
            assert bool(torch.isneginf(lse[s, t]).all()) == empty
            if empty:
                assert not out[s, t].any()
    assert_close(out, np.asarray(jout), msg="spec out", **TOL)
    assert_close(lse, np.asarray(jlse), msg="spec lse", **TOL)


def test_spec_plain_at_one_draft_row_is_the_decode():
    tc, _ = _build_pair(seed=3)
    q = torch.from_numpy(_q(4, 1, 4))
    out, lse = paged_decode_spec_plain(q, tc)
    dout, dlse = paged_decode_plain(q[:, 0], tc)
    torch.testing.assert_close(out[:, 0], dout, rtol=0, atol=0)
    torch.testing.assert_close(lse[:, 0], dlse, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("spec_k", [2, 3])
def test_verify_routes_agree_with_the_plain_version(spec_k, dtype):
    """verify_attn_step (CPU, float cache: the spec plain version; int8
    cache: the dequantized gather + FFA route), _gather_ffa_verify and
    _dense_verify against the spec plain version, which reads int8 pages
    dequantized as the others do."""
    tc, _ = _build_pair(seed=6, dtype=dtype)
    q = torch.from_numpy(_q(7, spec_k, 2))
    want = paged_decode_spec_plain(q, tc)
    calls = paged_decode_spec_plain.calls
    got = verify_attn_step(q, tc, tuple(LENGTHS))
    assert paged_decode_spec_plain.calls == calls + (dtype == "float32")
    for name, (o, l) in (
        ("verify_attn_step", got),
        ("_gather_ffa_verify", _gather_ffa_verify(q, tc, LENGTHS)),
        ("_dense_verify", _dense_verify(q, tc, LENGTHS)),
    ):
        np.testing.assert_array_equal(torch.isneginf(l), torch.isneginf(want[1]))
        assert_close(o, want[0], msg=f"{name} out", **TOL)
        assert_close(l, want[1], msg=f"{name} lse", **TOL)


def test_spec_and_int8_kernels_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise before any build; the
    entry points take the plain versions instead."""
    tc, _ = _build_pair(seed=8)
    qc, _ = _build_pair(seed=8, dtype="int8")
    q = torch.zeros(len(LENGTHS), 2, 2 * HK, D)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_spec_kernel(q, tc, D ** -0.5)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_int8_kernel(q[:, 0], qc, D ** -0.5)
    with pytest.raises(ValueError, match="int8 cache"):
        paged_decode_int8_kernel(q[:, 0], tc, D ** -0.5)


@pytest.mark.parametrize(
    "name,kernel",
    [("paged_decode", "_paged_decode_kernel"),
     ("paged_decode_spec", "_paged_decode_spec_kernel"),
     ("paged_decode_int8", "_paged_decode_int8_kernel")],
)
def test_decode_sources_share_one_body(name, kernel):
    """Each paged-decode kernel is built from its own source over the one
    body, and names the TPU kernel it replaces."""
    assert name in _build.SOURCES
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert f"Replaces: magiattention_tpu/kernels/paged_decode.py:{kernel}" in src
    assert '#include "paged_decode.cuh"' in src
