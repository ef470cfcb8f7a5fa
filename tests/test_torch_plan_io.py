"""The port's plan wire format (``meta/plan_io.py``) against the JAX
package's, on the same plans.

- For plans both planners build from one corpus (static at cp 1, 2 and 4,
  a two-level (dcn 2, ici 2) plan, qo-comm dynamic plans, a cache entry
  with its configs), the port's ``encode_value`` payload and its
  ``encode_plan(obj, env_sig=())`` blob are byte-equal to JAX's.
- JAX's blob decodes in the port to objects field-equal to the port's own
  solve (the two-level plan's per-pair row counts read back from its
  receive selections), keeps the self-attention back-reference, and
  ``encode(decode(blob)) == blob``.
- Truncation, a bit flip, a wrong wire version, an env mismatch and a
  signature mismatch each raise their typed ``PlanDecodeError`` subclass,
  the one JAX raises on the same bytes.
"""

import struct

import numpy as np
import pytest

from magiattention_tpu.meta import plan_io as j_io
from magiattention_tpu_torch.meta import plan_io as p_io
from tests.test_torch_verifier import _dynamic, _pkg, _static
from tests.torch_port_cases import assert_same_fields, warm_jax_native


@pytest.fixture(scope="module", autouse=True)
def _warm_jax_native():
    warm_jax_native()


@pytest.fixture(scope="module")
def pkgs():
    return {"port": _pkg("magiattention_tpu_torch"), "jax": _pkg("magiattention_tpu")}


def _entry(plan):
    """A plan-cache entry, as the manager persists it."""
    return {"dispatch": (plan["mq"], plan["mkv"], plan["bucket"]),
            "static": (plan["comm"], plan["calc"])}


CASES = [("causal", 1, None), ("two_docs", 2, None), ("window", 4, None), ("two_docs", 4, (2, 2))]


def _pair(pkgs, mask, cp, mesh_shape):
    return _static(pkgs["port"], mask, cp, mesh_shape), _static(pkgs["jax"], mask, cp, mesh_shape)


@pytest.mark.parametrize("mask,cp,mesh_shape", CASES)
def test_payloads_equal_jax(pkgs, mask, cp, mesh_shape):
    port, ref = _pair(pkgs, mask, cp, mesh_shape)
    for what in ("mq", "bucket", "comm", "calc", "cfg"):
        assert p_io.encode_value(port[what]) == j_io.encode_value(ref[what]), what
    assert p_io.encode_plan(_entry(port), env_sig=()) == j_io.encode_plan(_entry(ref), env_sig=())
    env = (("MAGI_ATTENTION_FFA_GQA_PACK", "1"),)
    assert p_io.encode_plan(_entry(port), env, "ab12") == j_io.encode_plan(_entry(ref), env, "ab12")
    assert p_io.env_sig_digest(env) == j_io.env_sig_digest(env)


@pytest.mark.parametrize("cp", [2, 4])
def test_dynamic_payloads_equal_jax(pkgs, cp):
    port, ref = _dynamic(pkgs["port"], "two_docs", cp), _dynamic(pkgs["jax"], "two_docs", cp)
    assert p_io.encode_value(port) == j_io.encode_value(ref)
    blob = j_io.encode_plan({"dynamic": ref}, env_sig=())
    got = p_io.decode_plan(blob)["dynamic"]
    assert got.solver_state is None  # in-process carryover, never on the wire
    port.solver_state = None
    assert_same_fields(got, port, f"dynamic cp{cp}")
    assert p_io.encode_plan({"dynamic": got}, env_sig=()) == blob


@pytest.mark.parametrize("mask,cp,mesh_shape", CASES)
def test_jax_blob_decodes_field_equal(pkgs, mask, cp, mesh_shape):
    port, ref = _pair(pkgs, mask, cp, mesh_shape)
    blob = j_io.encode_plan(_entry(ref), env_sig=("env",), sig_digest="d")
    got = p_io.decode_plan(blob, env_sig=("env",), expect_digest="d")
    (mq, mkv, bucket), (comm, calc) = got["dispatch"], got["static"]
    assert mkv is mq  # self-attention: one DispatchMeta, as solved
    for name, a, b in (("mq", mq, port["mq"]), ("bucket", bucket, port["bucket"]),
                       ("comm", comm, port["comm"]), ("calc", calc, port["calc"])):
        assert type(a) is type(b)
        assert_same_fields(a, b, f"{mask} cp{cp} {name}")
    for stage, want in zip(comm.kv_stages, port["comm"].kv_stages):
        if want.hier_plan is not None:  # the port's own counts, read back
            assert np.array_equal(stage.hier_plan.a_pair_rows, want.hier_plan.a_pair_rows)
            assert np.array_equal(stage.hier_plan.b_pair_rows, want.hier_plan.b_pair_rows)
    assert p_io.encode_plan(got, env_sig=("env",), sig_digest="d") == blob


def test_decoded_two_level_plan_runs_the_same_casts(pkgs):
    """The per-rank cast plans of a decoded two-level stage equal the
    solved stage's (what the runtime derives from the pair counts)."""
    from magiattention_tpu_torch.comm.hier import HierCastPlan

    port = _static(pkgs["port"], "causal", 4, (2, 2))
    got = p_io.decode_plan(p_io.encode_plan(_entry(port)))["static"][0]
    for stage, want in zip(got.kv_stages, port["comm"].kv_stages):
        for r in range(4):
            a, b = HierCastPlan.from_plan(stage.hier_plan, r), HierCastPlan.from_plan(want.hier_plan, r)
            for f in ("a_send_rows", "a_send_splits", "a_recv_splits", "b_send_rows",
                      "b_send_splits", "b_recv_splits", "b_order", "shard_len", "buf_len"):
                assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f


def _corruptions(blob):
    hdr = p_io.HEADER.size
    flipped = bytearray(blob)
    flipped[hdr + 3] ^= 0x40
    return {
        "truncated": (blob[:-4], {}, "PlanChecksumError"),
        "header_cut": (blob[:10], {}, "PlanChecksumError"),
        "bit_flip": (bytes(flipped), {}, "PlanChecksumError"),
        "magic": (b"NOTMAGIC" + blob[8:], {}, "PlanSchemaError"),
        "version": (blob[:8] + struct.pack("<I", 99) + blob[12:], {}, "PlanSchemaError"),
        "env": (blob, {"env_sig": ("env-b",)}, "PlanEnvMismatchError"),
        "signature": (blob, {"expect_digest": "other"}, "PlanSigMismatchError"),
    }


@pytest.mark.parametrize(
    "case", ["truncated", "header_cut", "bit_flip", "magic", "version", "env", "signature"]
)
def test_corruptions_raise_typed_like_jax(pkgs, case):
    port = _static(pkgs["port"], "two_docs", 2)
    blob = p_io.encode_plan(_entry(port), env_sig=("env-a",), sig_digest="mine")
    bad, kw, name = _corruptions(blob)[case]
    kw = {"env_sig": ("env-a",), **kw}
    with pytest.raises(getattr(p_io, name)) as got:
        p_io.decode_plan(bad, **kw)
    assert isinstance(got.value, p_io.PlanDecodeError)
    with pytest.raises(getattr(j_io, name)):
        j_io.decode_plan(bad, **kw)


def test_unbound_blob_skips_the_signature_check():
    blob = p_io.encode_plan({"x": 1}, env_sig=("e",))
    assert p_io.decode_plan(blob, env_sig=("e",), expect_digest="any") == {"x": 1}


def test_unregistered_object_refuses_to_encode():
    with pytest.raises(p_io.PlanDecodeError, match="register"):
        p_io.encode_value(object())


def test_plan_serialize_site_is_armed(monkeypatch):
    from magiattention_tpu_torch.resilience import inject
    from magiattention_tpu_torch.resilience.errors import InjectedFault

    inject.reset()
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", "plan_serialize:count=1")
    try:
        with pytest.raises(InjectedFault, match="plan_serialize"):
            p_io.encode_plan({"x": 1})
        assert p_io.decode_plan(p_io.encode_plan({"x": 1})) == {"x": 1}  # count spent
    finally:
        inject.reset()
