"""The port's serving engine against the JAX package's, on the CPU.

Same model weights (drawn from one numpy seed, or carried across with
``ToyModel.from_numpy``), same prompts, same scheduler decisions. The port's
engine runs its plain versions here; the JAX engine runs its default decode
rung (the Pallas paged-decode kernel in interpret mode). Generated rows are
compared at float32 tolerance (atol 1e-5, rel-norm 1e-5): the two packages
sum in different orders.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels.paged_kv import PagedKVCache as JaxCache
from magiattention_tpu.resilience.errors import (
    PageExhaustedError as JaxPageExhaustedError,
)
from magiattention_tpu.serving import PagePool as JaxPagePool
from magiattention_tpu.serving import Scheduler as JaxScheduler
from magiattention_tpu.serving import ServeConfig as JaxServeConfig
from magiattention_tpu.serving import ServeEngine as JaxServeEngine
from magiattention_tpu.serving import ServeRequest as JaxServeRequest
from magiattention_tpu.serving import ToyModel as JaxToyModel
from magiattention_tpu_torch.env.general import scoped_env
from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache
from magiattention_tpu_torch.resilience.errors import PageExhaustedError
from magiattention_tpu_torch.serving import (
    PagePool,
    Scheduler,
    ServeConfig,
    ServeEngine,
    ServeRequest,
    ToyModel,
    run_reference,
)
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)


def _serve_smoke_workload():
    """``WORKLOAD`` of scripts/serve_smoke.py, read without running it."""
    path = os.path.join(REPO, "scripts", "serve_smoke.py")
    src = open(path).read()
    start = src.index("WORKLOAD = [")
    end = src.index("]", start) + 1
    scope: dict = {}
    exec(src[start:end], scope)
    return scope["WORKLOAD"]


WORKLOAD = _serve_smoke_workload()
SMOKE_CONFIG = dict(
    page_size=16, num_pages=24, max_slots=4, max_pages_per_seq=8,
    prefill_chunk=16,
)


def _port_requests(model, spec, seed):
    return [
        ServeRequest(i, model.prompt(length, seed=seed + i), new)
        for i, (length, new) in enumerate(spec)
    ]


def _assert_rows_close(got_reqs, want_rows, msg):
    for req in got_reqs:
        want = want_rows[req.req_id]
        assert len(req.generated) == len(want) == req.max_new_tokens
        assert_close(
            np.stack(req.generated), np.stack(want),
            msg=f"{msg} request {req.req_id}", **TOL,
        )


@pytest.fixture(scope="module")
def jax_model():
    return JaxToyModel.create()


@pytest.fixture(scope="module")
def port_model(jax_model):
    params = {n: np.asarray(getattr(jax_model, n)) for n in ("wq", "wk", "wv", "wo")}
    return ToyModel.from_numpy(
        params, jax_model.n_heads, jax_model.n_kv_heads, jax_model.head_dim,
        device="cpu",
    )


@pytest.fixture(scope="module")
def jax_smoke_rows(jax_model):
    requests = [
        JaxServeRequest(i, jax_model.prompt(length, seed=100 + i), new)
        for i, (length, new) in enumerate(WORKLOAD)
    ]
    engine = JaxServeEngine(jax_model, JaxServeConfig(**SMOKE_CONFIG))
    assert len(engine.run(requests)) == len(WORKLOAD)
    return {r.req_id: r.generated for r in requests}, engine.step_count


def test_create_draws_the_jax_weights_and_prompts():
    port = ToyModel.create(seed=3, device="cpu")
    ref = JaxToyModel.create(seed=3)
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        )
    np.testing.assert_array_equal(
        port.prompt(7, seed=11).numpy(), np.asarray(ref.prompt(7, seed=11))
    )


def test_from_numpy_model_maps_like_jax(jax_model, port_model):
    x = np.random.default_rng(0).standard_normal((5, jax_model.d_model)).astype(np.float32)
    tq, tk, tv = port_model.qkv(torch.from_numpy(x))
    jq, jk, jv = jax_model.qkv(jnp.asarray(x))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        assert_close(a, np.asarray(b), **TOL)
    hidden = port_model.project(tq)
    assert_close(hidden, np.asarray(jax_model.project(jq)), **TOL)
    assert_close(
        port_model.next_input(hidden),
        np.asarray(jax_model.next_input(jnp.asarray(hidden.numpy()))),
        **TOL,
    )


def test_engine_matches_jax_engine_and_replay(port_model, jax_smoke_rows):
    jax_rows, jax_steps = jax_smoke_rows
    config = ServeConfig(**SMOKE_CONFIG)
    requests = _port_requests(port_model, WORKLOAD, seed=100)
    engine = ServeEngine(port_model, config)
    assert len(engine.run(requests)) == len(WORKLOAD)
    assert engine.step_count == jax_steps
    _assert_rows_close(requests, jax_rows, "port vs JAX engine")
    _assert_rows_close(
        requests, run_reference(port_model, requests, config), "port vs replay"
    )


def test_eviction_is_output_transparent(port_model):
    """A pool tight enough to force eviction/restart still gives the
    replay's outputs (restarts recompute exactly)."""
    config = ServeConfig(
        page_size=4, num_pages=6, max_slots=3, max_pages_per_seq=6,
        prefill_chunk=8,
    )
    requests = _port_requests(port_model, [(6, 5), (4, 4), (9, 6), (3, 8)], seed=50)
    engine = ServeEngine(port_model, config)
    assert len(engine.run(requests)) == len(requests)
    assert sum(r.evictions for r in requests) > 0
    _assert_rows_close(
        requests, run_reference(port_model, requests, config), "evicting engine"
    )


def _scheduler_trace(pkg):
    """Drive one package's scheduler through admission, growth on a tight
    pool (forcing evictions) and completion; record every decision."""
    if pkg == "jax":
        cache = JaxCache.create(6, 4, 1, 8, 3, 8, dtype=jnp.float32)
        sched = JaxScheduler(JaxPagePool(6), 3, 4)

        def req(i, n):
            return JaxServeRequest(i, jnp.zeros((n, 4), jnp.float32), 2)
    else:
        cache = PagedKVCache.create(6, 4, 1, 8, 3, 8, dtype=torch.float32, device="cpu")
        sched = Scheduler(PagePool(6), 3, 4)

        def req(i, n):
            return ServeRequest(i, torch.zeros((n, 4)), 2)

    trace = []
    reqs = [req(i, n) for i, n in enumerate([5, 4, 3, 6])]
    for r in reqs:
        sched.submit_request(r)
    cache, admitted = sched.admit(cache)
    trace.append(("admit", [(r.req_id, r.slot, list(r.page_ids), r.admit_seq) for r in admitted]))
    for r in admitted:
        r.length = r.prompt_len
    for step in range(3):
        for slot in range(3):
            r = sched.slots[slot]
            if r is None:
                continue
            cache, n_ev = sched.ensure_capacity(cache, r, r.length + 4)
            r.length += 4
            trace.append(("grow", step, r.req_id, list(r.page_ids), n_ev))
    trace.append(("waiting", [r.req_id for r in sched.waiting]))
    trace.append(("evictions", [r.evictions for r in reqs]))
    trace.append(("table", np.asarray(cache.page_table).tolist()))
    trace.append(("lengths", np.asarray(cache.lengths).tolist()))
    cache = sched.finish(cache, sched.active[0])
    cache, admitted = sched.admit(cache)
    trace.append(("readmit", [(r.req_id, r.slot, list(r.page_ids)) for r in admitted]))
    with pytest.raises((PageExhaustedError, JaxPageExhaustedError)) as ei:
        for _ in range(8):
            r = sched.active[-1]
            cache, _ = sched.ensure_capacity(cache, r, r.length + 4)
            r.length += 4
    trace.append(("exhausted", type(ei.value).__name__, ei.value.requested, ei.value.free))
    return trace


def test_scheduler_decisions_equal_jax():
    assert _scheduler_trace("port") == _scheduler_trace("jax")


def test_unservable_request_raises_typed(port_model):
    """One request alone outgrowing the whole pool raises the typed error,
    as in the JAX engine (tests/test_serving/test_engine.py)."""
    config = ServeConfig(
        page_size=4, num_pages=2, max_slots=2, max_pages_per_seq=4,
        prefill_chunk=8,
    )
    engine = ServeEngine(port_model, config)
    with pytest.raises(PageExhaustedError):
        engine.run(_port_requests(port_model, [(8, 4)], seed=60))


@pytest.mark.parametrize(
    "field,value,item",
    [("decode_shards", 2, "sharded")],
)
def test_unported_options_raise(port_model, field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        ServeEngine(port_model, ServeConfig(**{field: value}))


@pytest.mark.parametrize(
    "field,value,stat", [("spec_tokens", 2, "spec_k"), ("kv_dtype", "int8", "kv_dtype")]
)
def test_scale_options_run_on_the_cpu(port_model, field, value, stat):
    """The speculative and int8 options build an engine on the CPU, and the
    first tick's stats carry them."""
    engine = ServeEngine(port_model, ServeConfig(**{field: value}))
    engine.submit(ServeRequest(0, port_model.prompt(5, seed=7), 2))
    stats = engine.step()
    assert stats[stat] == value
    assert engine.cache.quantized == (field == "kv_dtype")


def test_config_from_env_reads_the_jax_variables():
    env = {
        "MAGI_ATTENTION_SERVE_MAX_SLOTS": "3",
        "MAGI_ATTENTION_SERVE_PAGES": "40",
        "MAGI_ATTENTION_SERVE_PAGE_SIZE": "8",
        "MAGI_ATTENTION_SERVE_PREFILL_CHUNK": "32",
        "MAGI_ATTENTION_SERVE_POOL_SHARDS": "2",
    }
    with scoped_env(env):
        port, ref = ServeConfig.from_env(), JaxServeConfig.from_env()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.num_pages == 40 and port.pool_shards == 2
