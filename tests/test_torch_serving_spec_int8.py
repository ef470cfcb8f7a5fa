"""The port's speculative and int8 serving engines against the JAX
package's, on the CPU.

The workload and configurations are the JAX package's own
(``tests/test_serving/test_serving_scale.py``: ``SPEC_CONFIG``,
``INT8_CONFIG``, ``WORKLOAD``). The JAX engine is pinned to its gather rung
(``MAGI_ATTENTION_SERVE_DECODE_KERNEL=0``); the port's engine runs its plain
versions (spec, int8 decode, gather + FFA for verify on an int8 cache).
Rows are compared at float32 tolerance (atol 1e-5, rel-norm 1e-5) unless a
test says otherwise.
"""

import dataclasses

import numpy as np
import pytest

from magiattention_tpu.serving import ServeEngine as JaxServeEngine
from magiattention_tpu.serving import ToyModel as JaxToyModel
from magiattention_tpu_torch.serving import (
    ServeConfig,
    ServeEngine,
    ServeRequest,
    ToyModel,
    generate_reference,
    oracle_draft_fn,
    run_reference,
)
from magiattention_tpu_torch.testing import assert_close
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)
from tests.test_serving.test_engine import make_requests as jax_requests
from tests.test_serving.test_serving_scale import (
    INT8_CONFIG,
    SPEC_CONFIG,
    WORKLOAD,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
# JAX's bound on the int8 engine's rows against float32
# (tests/test_serving/test_serving_scale.py:test_int8_within_tolerance_of_f32)
INT8_VS_F32 = 0.1


def _port_config(jax_config, **changes):
    return ServeConfig(**{**dataclasses.asdict(jax_config), **changes})


def _run(engine, requests):
    """engine.run() keeping every tick's stats dict."""
    for req in requests:
        engine.submit(req)
    stats = []
    while engine.scheduler.has_work():
        stats.append(engine.step())
        assert engine.step_count < 10_000
    assert len(engine.finished) == len(requests)
    return stats


def _requests(model):
    return [
        ServeRequest(i, model.prompt(length, seed=100 + i), new)
        for i, (length, new) in enumerate(WORKLOAD)
    ]


def _worst(requests, rows):
    return max(
        float(np.abs(np.stack(r.generated) - np.stack(rows[r.req_id])).max())
        for r in requests
    )


def _assert_rows_close(requests, rows, msg, **tol):
    for req in requests:
        want = rows[req.req_id]
        assert len(req.generated) == len(want) == req.max_new_tokens
        assert_close(
            np.stack(req.generated), np.stack(want),
            msg=f"{msg} request {req.req_id}", **(tol or TOL),
        )


@pytest.fixture(scope="module")
def jax_model():
    return JaxToyModel.create()


@pytest.fixture(scope="module")
def port_model():
    return ToyModel.create(device="cpu")  # the JAX model's weights


@pytest.fixture(scope="module")
def jax_runs(jax_model):
    """The JAX engine's rows and stats under SPEC_CONFIG and INT8_CONFIG."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGI_ATTENTION_SERVE_DECODE_KERNEL", "0")
    try:
        runs = {}
        for name, config in (("spec", SPEC_CONFIG), ("int8", INT8_CONFIG)):
            requests = jax_requests(jax_model, WORKLOAD)
            stats = _run(JaxServeEngine(jax_model, config), requests)
            runs[name] = ({r.req_id: r.generated for r in requests}, stats)
        return runs
    finally:
        mp.undo()


def test_spec_greedy_engine_matches_jax_and_replay(port_model, jax_runs):
    """spec_tokens = 2 with the greedy self-draft: rows within tolerance of
    the JAX engine's and of the port's replay, real rollbacks, and the
    stats keys of JAX's."""
    config = _port_config(SPEC_CONFIG)
    requests = _requests(port_model)
    stats = _run(ServeEngine(port_model, config), requests)
    jax_rows, jax_stats = jax_runs["spec"]
    _assert_rows_close(requests, jax_rows, "port vs JAX spec engine")
    _assert_rows_close(
        requests, run_reference(port_model, requests, config), "port spec vs replay"
    )
    attempted = sum(s["draft_attempted"] for s in stats)
    accepted = sum(s["draft_accepted"] for s in stats)
    assert 1 <= accepted < attempted, "rollback path not exercised"
    assert [sorted(s) for s in stats] == [sorted(s) for s in jax_stats]
    for s in stats:
        assert s["spec_k"] == 2 and s["kv_dtype"] == "float32" and s["shards"] == 1
        assert 0.0 <= s["accept_rate"] <= 1.0


def test_spec_oracle_draft_rows_match_replay(port_model):
    """The oracle draft (the replay's true next inputs): every committed row
    within tolerance of the replay. Which drafts are accepted is not
    determined here (the engine's verify and the replay sum in different
    orders, and a draft is accepted only on exact equality), so only the
    bookkeeping is asserted: every decoded token was an accepted draft."""
    config = _port_config(SPEC_CONFIG)
    reference = run_reference(port_model, _requests(port_model), config)
    requests = _requests(port_model)
    stats = _run(
        ServeEngine(port_model, config, draft_fn=oracle_draft_fn(reference)),
        requests,
    )
    _assert_rows_close(requests, reference, "oracle-draft spec vs replay")
    decoding = [s for s in stats if s["draft_attempted"]]
    assert decoding
    for s in decoding:
        assert s["draft_accepted"] == s["decode_tokens"] > 0


def test_int8_engine_matches_jax_and_replay(port_model, jax_runs):
    """kv_dtype = 'int8': within tolerance of the JAX int8 engine and of the
    port's int8 replay; against the float32 replay, the quantization error:
    nonzero and below JAX's bound."""
    config = _port_config(INT8_CONFIG)
    requests = _requests(port_model)
    stats = _run(ServeEngine(port_model, config), requests)
    assert all(s["kv_dtype"] == "int8" for s in stats)
    _assert_rows_close(requests, jax_runs["int8"][0], "port vs JAX int8 engine")
    _assert_rows_close(
        requests, run_reference(port_model, requests, config), "port int8 vs int8 replay"
    )
    forced = {  # the replay fed the engine's rows: the same codes
        r.req_id: generate_reference(port_model, r, config, forced=r.generated)
        for r in requests
    }
    _assert_rows_close(requests, forced, "port int8 vs forced int8 replay")
    f32 = run_reference(port_model, requests, _port_config(INT8_CONFIG, kv_dtype="float32"))
    worst = _worst(requests, f32)
    assert 0.0 < worst < INT8_VS_F32, worst


def test_spec_int8_engine_within_tolerance_of_int8_replay(port_model):
    """spec_tokens = 2 on an int8 cache (verify through the dequantized
    gather + FFA). Rejected rows leave their raised scales in the page they
    shared with committed rows, as in the JAX package, so the committed rows
    differ from the int8 replay by re-quantization: held to the int8 bound."""
    config = _port_config(INT8_CONFIG, spec_tokens=2)
    requests = _requests(port_model)
    stats = _run(ServeEngine(port_model, config), requests)
    attempted = sum(s["draft_attempted"] for s in stats)
    assert sum(s["draft_accepted"] for s in stats) < attempted
    reference = run_reference(port_model, requests, config)
    for req in requests:
        assert len(req.generated) == req.max_new_tokens
    assert _worst(requests, reference) < INT8_VS_F32
