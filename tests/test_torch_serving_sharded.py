"""The head-sharded decode rung against the JAX package's.

- ``paged_decode_attn_sharded`` (the kv heads split into 2 or 4 shards,
  each shard's plain version on the CPU) against JAX's on a CPU mesh (its
  Pallas kernel in interpret mode under ``shard_map``) within float32
  1e-5, and equal to the port's unsharded ``paged_decode_attn`` to the
  bit; JAX's argument checks.
- The route: ``shards > 1`` starts at the sharded rung where JAX's
  feasibility admits it (float cache, one row, ``hk % shards == 0``),
  the next feasible rung otherwise; the ``paged_decode_sharded`` pin.
- ``ServeEngine`` with ``decode_shards=2, pool_shards=2`` equal to the
  single-device engine to the bit (the JAX package's
  ``tests/test_serving/test_serving_scale.py`` sharded case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import paged_kv as jpk
from magiattention_tpu.kernels.paged_decode import (
    paged_decode_attn_sharded as jax_paged_decode_attn_sharded,
)
from magiattention_tpu_torch.kernels import paged_kv as tpk
from magiattention_tpu_torch.kernels.paged_decode import (
    paged_decode_attn,
    paged_decode_attn_sharded,
    paged_decode_plain,
)
from magiattention_tpu_torch.serving import ServeConfig, ServeEngine, ServeRequest, ToyModel
from magiattention_tpu_torch.serving.decode import decode_attn_step, decode_route
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

HK, D, PS, NUM_PAGES, P = 4, 16, 8, 16, 4
LENGTHS = [0, 5, 8, 19]
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
NEW = "MAGI_ATTENTION_BACKEND_SERVE_DECODE"


def _caches(seed=0, dtype="float32"):
    """The same pages, table and ragged lengths in the port's cache and
    JAX's."""
    rng = np.random.default_rng(seed)
    tdt, jdt = (torch.int8, jnp.int8) if dtype == "int8" else (torch.float32, jnp.float32)
    tc = tpk.PagedKVCache.create(NUM_PAGES, PS, HK, D, len(LENGTHS), P, dtype=tdt, device="cpu")
    jc = jpk.PagedKVCache.create(NUM_PAGES, PS, HK, D, len(LENGTHS), P, dtype=jdt)
    free = list(rng.permutation(NUM_PAGES))
    for s, length in enumerate(LENGTHS):
        if length == 0:
            continue
        n = -(-length // PS)
        pages, free = np.asarray(free[:n], np.int32), free[n:]
        tc, jc = tpk.assign_pages(tc, s, pages), jpk.assign_pages(jc, s, pages)
        k, v = (rng.standard_normal((length, HK, D)).astype(np.float32) for _ in range(2))
        tc = tpk.append_kv(tc, s, torch.from_numpy(k), torch.from_numpy(v))
        jc = jpk.append_kv(jc, s, jnp.asarray(k), jnp.asarray(v))
    return tc, jc


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("g", [1, 4])
def test_sharded_decode_matches_jax_and_unsharded(g, shards):
    tc, jc = _caches(seed=g + shards)
    q = np.random.default_rng(3).standard_normal((len(LENGTHS), g * HK, D)).astype(np.float32)
    calls = paged_decode_plain.calls
    out, lse = paged_decode_attn_sharded(torch.from_numpy(q), tc, shards)
    assert paged_decode_plain.calls == calls + shards  # one launch per shard
    jout, jlse = jax_paged_decode_attn_sharded(
        jnp.asarray(q), jc, shards, devices=jax.devices("cpu")[:shards])
    np.testing.assert_array_equal(torch.isneginf(lse).numpy(), np.isneginf(np.asarray(jlse)))
    assert_close(out, np.asarray(jout), msg="out", **TOL)
    assert_close(lse, np.asarray(jlse), msg="lse", **TOL)
    want = paged_decode_attn(torch.from_numpy(q), tc)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])


def test_sharded_decode_checks():
    tc, _ = _caches()
    q = torch.zeros((len(LENGTHS), 2 * HK, D))
    with pytest.raises(ValueError, match="not divisible by num_shards"):
        paged_decode_attn_sharded(q, tc, 3)
    with pytest.raises(ValueError, match="not a multiple"):
        paged_decode_attn_sharded(q[:, :HK + 1], tc, 2)
    with pytest.raises(ValueError, match="need 4 devices"):
        paged_decode_attn_sharded(q, tc, 4, devices=["cpu", "cpu"])
    out = paged_decode_attn_sharded(q, tc, 2, devices=["cpu", "cpu", "cpu"])[0]
    assert out.shape == (len(LENGTHS), 2 * HK, D)


@pytest.mark.parametrize(
    "pin,dtype,multi_row,shards,want",
    [
        (None, "float32", False, 2, "paged_decode_sharded"),
        (None, "float32", False, 4, "paged_decode_sharded"),
        (None, "float32", False, 1, "paged_decode"),
        (None, "float32", False, 3, "paged_decode"),  # hk % 3
        (None, "int8", False, 2, "paged_decode_int8"),
        (None, "float32", True, 2, "paged_decode_spec"),
        ("paged_decode_sharded", "float32", False, 1, "paged_decode"),
        ("paged_decode_sharded", "float32", True, 2, "paged_decode_spec"),
        ("paged_decode_sharded", "int8", True, 2, "gather_ffa"),
        ("paged_decode", "float32", False, 2, "paged_decode"),
    ],
)
def test_sharded_route(monkeypatch, pin, dtype, multi_row, shards, want):
    monkeypatch.delenv("MAGI_ATTENTION_SERVE_DECODE_KERNEL", raising=False)
    if pin is None:
        monkeypatch.delenv(NEW, raising=False)
    else:
        monkeypatch.setenv(NEW, pin)
    assert decode_route(_caches(dtype=dtype)[0], multi_row, shards) == want


def test_decode_step_takes_the_sharded_rung(monkeypatch):
    monkeypatch.delenv(NEW, raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_SERVE_DECODE_KERNEL", raising=False)
    tc, _ = _caches(seed=5)
    q = torch.from_numpy(np.random.default_rng(6).standard_normal((len(LENGTHS), HK, D))
                         .astype(np.float32))
    calls = paged_decode_plain.calls
    got = decode_attn_step(q, tc, shards=4)
    assert paged_decode_plain.calls == calls + 4
    want = decode_attn_step(q, tc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the JAX package's test_serving_scale.py configs and workload
F32_CONFIG = dict(page_size=8, num_pages=12, max_slots=3, max_pages_per_seq=4, prefill_chunk=8)
WORKLOAD = [(5, 3), (8, 2), (17, 2), (1, 4), (9, 3)]


def test_sharded_engine_bitwise_vs_single_device(monkeypatch):
    monkeypatch.delenv(NEW, raising=False)
    monkeypatch.delenv("MAGI_ATTENTION_SERVE_DECODE_KERNEL", raising=False)
    model = ToyModel.create(device="cpu")

    def requests():
        return [ServeRequest(i, model.prompt(n, seed=i), new) for i, (n, new) in enumerate(WORKLOAD)]

    single = requests()
    ServeEngine(model, ServeConfig(**F32_CONFIG)).run(single)
    sharded = requests()
    engine = ServeEngine(model, ServeConfig(**F32_CONFIG, decode_shards=2, pool_shards=2))
    for req in sharded:
        engine.submit(req)
    stats = [engine.step() for _ in iter(engine.scheduler.has_work, False)]
    assert stats and all(s["shards"] == 2 for s in stats)
    assert decode_route(engine.cache, False, 2) == "paged_decode_sharded"
    for a, b in zip(single, sharded):
        assert len(a.generated) == len(b.generated) == a.max_new_tokens
        for x, y in zip(a.generated, b.generated):
            np.testing.assert_array_equal(x, y, err_msg=str(a.req_id))


def test_kernels_raise_their_shared_memory_on_every_device():
    """The head-sharded step launches B10 on several cards from one
    process, and ``cudaFuncSetAttribute`` raises a kernel's shared-memory
    limit on the current device only: every kernel source keeps its
    opt-in per device (``magi::SmemAllowed``), never once per process
    (the CPU reads the sources; nothing compiles here)."""
    import re
    from pathlib import Path

    csrc = Path(__file__).resolve().parents[1] / "magiattention_tpu_torch" / "csrc"
    sources = {p.name: p.read_text() for p in csrc.glob("*.cu*")}
    common = sources["common.cuh"]
    assert "cudaGetDevice(&dev)" in common and "SmemAllowed* done" in common
    calls = 0
    for name, text in sources.items():
        assert "static bool smem_ok" not in text, name
        for flag in re.findall(r"allow_smem\([^;]*?&(\w+)\)", text, re.S):
            calls += 1
            assert re.search(rf"static magi::SmemAllowed {flag};", text), (name, flag)
    assert calls >= 10
