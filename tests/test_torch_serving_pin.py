"""The serve-decode pin in the port (ROADMAP C2).

``serve_decode_pin`` reads the JAX package's keys to the same values
(MAGI_ATTENTION_BACKEND_SERVE_DECODE, legacy
MAGI_ATTENTION_SERVE_DECODE_KERNEL). The decode and verify steps start at
the pinned rung and take the first one feasible for the cache (JAX's
``_feasibility``); unpinned they stay on the kernel rungs. Under
``gather_ffa`` the engine runs the replay oracle's own calls, so on the
CPU its rows equal the replay's to the bit and the oracle draft is always
accepted."""

import numpy as np
import pytest
import torch

from magiattention_tpu.env import backend as jax_backend
from magiattention_tpu_torch.env import backend as port_backend
from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache
from magiattention_tpu_torch.serving import (
    ServeConfig, ServeEngine, ServeRequest, ToyModel, oracle_draft_fn, run_reference,
)
from magiattention_tpu_torch.serving.decode import decode_route
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

NEW, LEGACY = "MAGI_ATTENTION_BACKEND_SERVE_DECODE", "MAGI_ATTENTION_SERVE_DECODE_KERNEL"


@pytest.mark.parametrize(
    "new, legacy",
    [
        (None, None), ("gather_ffa", None), ("DENSE", None), ("paged_decode_spec", None),
        ("paged_decode_int8", None), ("paged_decode", None), ("paged_decode_sharded", None),
        ("bogus", None), (None, "0"), (None, "1"), (None, "auto"), ("dense", "1"), ("bogus", "0"),
    ],
)
def test_serve_decode_pin_matches_jax(monkeypatch, new, legacy):
    for key, val in ((NEW, new), (LEGACY, legacy)):
        if val is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, val)
    assert port_backend.serve_decode_pin() == jax_backend.serve_decode_pin()


def _cache(quantized: bool) -> PagedKVCache:
    return PagedKVCache.create(
        4, 16, 2, 16, 1, 2, dtype=torch.int8 if quantized else torch.float32, device="cpu"
    )


# pin -> (float decode, float verify, int8 decode, int8 verify)
_ROUTES = {
    None: ("paged_decode", "paged_decode_spec", "paged_decode_int8", "gather_ffa"),
    "paged_decode_spec": ("paged_decode", "paged_decode_spec", "paged_decode_int8", "gather_ffa"),
    "paged_decode_int8": ("paged_decode", "gather_ffa", "paged_decode_int8", "gather_ffa"),
    "paged_decode": ("paged_decode", "gather_ffa", "gather_ffa", "gather_ffa"),
    "gather_ffa": ("gather_ffa",) * 4,
    "dense": ("dense",) * 4,
}


@pytest.mark.parametrize("pin", list(_ROUTES), ids=str)
def test_decode_route(monkeypatch, pin):
    monkeypatch.delenv(LEGACY, raising=False)
    if pin is None:
        monkeypatch.delenv(NEW, raising=False)
    else:
        monkeypatch.setenv(NEW, pin)
    got = tuple(
        decode_route(_cache(quantized), multi_row)
        for quantized in (False, True) for multi_row in (False, True)
    )
    assert got == _ROUTES[pin]


def test_sharded_pin_raises(monkeypatch):
    """The ``paged_decode_sharded`` pin (it raised before the rung was
    ported; the name is kept) routes by JAX's feasibility: the sharded
    rung for a float one-row step with shards that split the kv heads,
    the first feasible rung below it otherwise."""
    monkeypatch.delenv(LEGACY, raising=False)
    monkeypatch.setenv(NEW, "paged_decode_sharded")
    assert decode_route(_cache(False), False, 2) == "paged_decode_sharded"
    got = tuple(
        decode_route(_cache(quantized), multi_row)
        for quantized in (False, True) for multi_row in (False, True)
    )
    assert got == _ROUTES[None]


_REQUESTS = [(5, 8), (17, 12), (40, 4), (1, 8)]  # (prompt, new tokens): multiples of 4


@pytest.mark.parametrize(
    "kv_dtype, spec, oracle",
    [("float32", 1, False), ("float32", 4, False), ("float32", 4, True), ("int8", 1, False)],
    ids=["serve", "spec_greedy", "spec_oracle", "int8"],
)
def test_pinned_engine_equals_replay_bitwise(monkeypatch, kv_dtype, spec, oracle):
    monkeypatch.delenv(LEGACY, raising=False)
    monkeypatch.setenv(NEW, "gather_ffa")
    model = ToyModel.create(device="cpu")

    def requests():
        return [ServeRequest(i, model.prompt(n, seed=10 + i), new)
                for i, (n, new) in enumerate(_REQUESTS)]

    config = ServeConfig(kv_dtype=kv_dtype, spec_tokens=spec)
    replay = run_reference(model, requests(), config)
    reqs = requests()
    engine = ServeEngine(model, config, draft_fn=oracle_draft_fn(replay) if oracle else None)
    for r in reqs:
        engine.submit(r)
    stats = []
    while engine.scheduler.has_work():
        stats.append(engine.step())
    for r in reqs:
        assert np.array_equal(np.stack(r.generated), np.stack(replay[r.req_id])), r.req_id
    rate = sum(s["draft_accepted"] for s in stats) / sum(s["draft_attempted"] for s in stats)
    if oracle or spec == 1:
        assert rate == 1.0
    else:
        assert rate < 1.0  # the greedy draft is rejected, rollback runs


def test_unpinned_engine_is_not_held_to_the_bit(monkeypatch):
    """Unpinned, the engine batches its products over slots (a row of a
    multi-row product may differ from the same row alone in its last bit):
    the rows agree with the replay in float32 tolerance."""
    monkeypatch.delenv(LEGACY, raising=False)
    monkeypatch.delenv(NEW, raising=False)
    model = ToyModel.create(device="cpu")
    reqs = [ServeRequest(i, model.prompt(n, seed=10 + i), new) for i, (n, new) in enumerate(_REQUESTS)]
    config = ServeConfig()
    replay = run_reference(model, reqs, config)
    ServeEngine(model, config).run(reqs)
    for r in reqs:
        np.testing.assert_allclose(np.stack(r.generated), np.stack(replay[r.req_id]), atol=1e-5)
