"""The port's plan tiers (``meta/plan_store.py``, ``meta/plan_broadcast.py``
and the manager's load and persist path) against the JAX package's.

As ``tests/test_api/test_plan_store.py`` and
``tests/test_resilience/test_plan_chaos.py`` drive JAX's:

- the disk tier: a cold manager persists its plan; after the memory tiers
  are dropped a second manager loads it (``plan_source == "disk"``, no
  solver call), field-equal to JAX's solve of the same mask, and its CPU
  fwd+bwd equals the cold one bitwise; every corruption of a store file
  is a typed miss; a corrupted file is rejected and cold-solved (and the
  write-through heals it); an entry the verifier rejects goes back to a
  cold solve;
- the runtime key's six repaired flags: each flip changes
  ``snapshot_env()``, the runtime key and the plan-signature digest, and
  misses the store;
- the three armed chaos sites (``plan_serialize``, ``plan_cache_read``,
  ``plan_broadcast``) raise typed without MAGI_ATTENTION_FALLBACK and are a
  recorded miss with it, bitwise the cold step;
- a collective transport exchanges exactly once per resolution, failures
  included; a blob delivered for another signature is rejected;
- the file transport across two processes, with the leader's heal of a
  torn publish, and one cp 2 gloo world over ``DistTransport``: rank 0
  solves, rank 1 receives (``plan_source == "broadcast"``, no solver
  call), both bitwise a cold solve; a fault there still pairs.
"""

import os
import struct
import tempfile

import numpy as np
import pytest
import torch.multiprocessing as mp

from magiattention_tpu.env import general as j_general
from magiattention_tpu_torch import dist_attn_runtime_mgr as mgr_mod
from magiattention_tpu_torch import telemetry
from magiattention_tpu_torch.api.magi_attn_interface import _mgr, clear_cache
from magiattention_tpu_torch.dist_attn_runtime_mgr import _PLAN_CACHE, _plan_signature
from magiattention_tpu_torch.env import general
from magiattention_tpu_torch.meta import plan_broadcast, plan_io, plan_store
from magiattention_tpu_torch.resilience import inject
from magiattention_tpu_torch.resilience.errors import InjectedFault
from tests.torch_port_cases import (
    CP_CHUNK, CP_SEQ, PLAN_DOCS, PLAN_TIER_ENV, assert_same_fields, count_solves, forget_plans,
    plan_key, plan_step, warm_jax_native,
)

SIX_KEYS = {
    "MAGI_ATTENTION_FFA_GQA_PACK": "1",
    "MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1",
    "MAGI_ATTENTION_FFA_GQA_PACK_DKV": "0",
    "MAGI_ATTENTION_FFA_MIXED_BLOCKS": "0",
    "MAGI_ATTENTION_BACKEND_MIXED_BLOCKS": "single",
    "MAGI_ATTENTION_BACKEND_NSA_SLC": "gathered_dense",
}


@pytest.fixture(scope="module", autouse=True)
def _warm_jax_native():
    warm_jax_native()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in (*PLAN_TIER_ENV, *SIX_KEYS, "MAGI_ATTENTION_TELEMETRY", "MAGI_ATTENTION_QO_COMM"):
        monkeypatch.delenv(var, raising=False)
    forget_plans()
    inject.reset()
    telemetry.reset()
    yield
    forget_plans()
    inject.reset()
    telemetry.reset()


def _store(monkeypatch, tmp_path, name="store"):
    d = tmp_path / name
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_STORE", "1")
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_STORE_DIR", str(d))
    plan_store.reset()
    return d


def _broadcast(monkeypatch, tmp_path, role, name="bcast"):
    d = tmp_path / name
    for var, val in (("MAGI_ATTENTION_PLAN_BROADCAST", "1"), ("MAGI_ATTENTION_PLAN_BROADCAST_TRANSPORT", "file"),
                     ("MAGI_ATTENTION_PLAN_BROADCAST_DIR", str(d)), ("MAGI_ATTENTION_PLAN_BROADCAST_ROLE", role),
                     ("MAGI_ATTENTION_PLAN_BROADCAST_RETRIES", "1"),
                     ("MAGI_ATTENTION_PLAN_BROADCAST_BACKOFF_MS", "1"),
                     ("MAGI_ATTENTION_PLAN_BROADCAST_DEADLINE_MS", "250")):
        monkeypatch.setenv(var, val)
    return d


def _counting(monkeypatch):
    return count_solves(mgr_mod, monkeypatch.setattr)


def _jax_plan():
    """JAX's solve of the plan tiers' mask, planned as the port's key is."""
    from magiattention_tpu import meta
    from magiattention_tpu.common.enum import AttnMaskType
    from magiattention_tpu.common.ranges import AttnRanges
    from magiattention_tpu.config import DistAttnConfig

    cfg = DistAttnConfig()
    mq, mkv, bucket = meta.make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(PLAN_DOCS), AttnRanges.from_ranges(PLAN_DOCS),
        [AttnMaskType.CAUSAL] * 2, CP_SEQ, CP_SEQ, CP_CHUNK, 1, cfg.dispatch_config,
    )
    return (mq, mkv, bucket), meta.make_attn_meta_from_dispatch_meta(bucket, mq, cfg, dispatch_meta_kv=mkv)


# ---------------------------------------------------------------------------
# the disk tier
# ---------------------------------------------------------------------------


def test_disk_warm_start_is_bitwise_the_cold_step(monkeypatch, tmp_path):
    d = _store(monkeypatch, tmp_path)
    key = plan_key()
    assert _mgr(key).plan_source == "cold"
    cold = plan_step(key)
    assert len(list(d.glob("plan-*.bin"))) == 1
    forget_plans()
    calls = _counting(monkeypatch)
    key = plan_key()
    mgr = _mgr(key)
    assert mgr.plan_source == "disk" and calls == {"dispatch": 0, "static": 0}
    assert mgr.dispatch_meta_kv is mgr.dispatch_meta_q
    (jmq, _, jbucket), (jcomm, jcalc) = _jax_plan()
    for got, want in ((mgr.dispatch_meta_q, jmq), (mgr.bucket, jbucket),
                      (mgr.comm_meta, jcomm), (mgr.calc_meta, jcalc)):
        assert_same_fields(got, want, "disk-loaded vs JAX's solve")
    assert np.array_equal(plan_step(key), cold)


def test_store_read_miss_matrix(tmp_path):
    store = plan_store.PlanStore(str(tmp_path / "s"))
    env = ("env-a",)
    blob = plan_io.encode_plan({"x": 1}, env_sig=env)
    assert store.write("d1", blob)
    path = store.path_for("d1")
    assert store.read("d1", env_sig=env) == ({"x": 1}, None)
    assert store.read("nope", env_sig=env)[1].reason == plan_store.MISS_ABSENT
    flipped = bytearray(blob)
    flipped[plan_io.HEADER.size] ^= 0x01
    for bad, reason, sig in (
        (blob[:-6], plan_store.MISS_CHECKSUM, env),
        (bytes(flipped), plan_store.MISS_CHECKSUM, env),
        (blob[:8] + struct.pack("<I", 99) + blob[12:], plan_store.MISS_SCHEMA, env),
        (blob, plan_store.MISS_ENV_MISMATCH, ("env-b",)),
        (plan_io.encode_plan({"x": 1}, env_sig=env, sig_digest="other"), plan_store.MISS_SIG_MISMATCH, env),
    ):
        with open(path, "wb") as f:
            f.write(bad)
        entry, miss = store.read("d1", env_sig=sig)
        assert entry is None and miss.reason == reason


def test_orphan_tmp_cleanup(tmp_path):
    import time

    d = tmp_path / "s"
    os.makedirs(d)
    orphan, live = d / "plan-dead.bin.tmp-9999-0", d / "plan-live.bin.tmp-1234-1"
    orphan.write_bytes(b"half a write")
    live.write_bytes(b"in flight")
    stale = time.time() - plan_store.ORPHAN_TMP_TTL_S - 5
    os.utime(orphan, (stale, stale))
    plan_store.PlanStore(str(d))
    assert not orphan.exists() and live.exists()


def test_corrupt_file_is_rejected_and_healed(monkeypatch, tmp_path):
    d = _store(monkeypatch, tmp_path)
    cold = plan_step(plan_key())
    (path,) = d.glob("plan-*.bin")
    pristine = path.read_bytes()
    mutated = bytearray(pristine)
    mutated[len(mutated) // 2] ^= 0x10
    path.write_bytes(bytes(mutated))
    forget_plans()
    calls = _counting(monkeypatch)
    key = plan_key()
    assert _mgr(key).plan_source == "cold" and calls == {"dispatch": 1, "static": 1}
    assert path.read_bytes() == pristine  # the write-through healed it
    assert np.array_equal(plan_step(key), cold)


def test_unverifiable_entry_is_rejected(monkeypatch, tmp_path):
    _store(monkeypatch, tmp_path)
    plan_key()
    forget_plans()
    monkeypatch.setattr(mgr_mod, "_verify_loaded_entry", lambda entry, key: False)
    calls = _counting(monkeypatch)
    assert _mgr(plan_key()).plan_source == "cold" and calls == {"dispatch": 1, "static": 1}
    assert telemetry.counters("resilience.").get("resilience.reject", 0) == 1


def test_verifier_catches_semantic_corruption():
    key = plan_key()
    entry = _PLAN_CACHE.lookup(_plan_signature(key))
    wire = {k: v for k, v in entry.items() if k in ("dispatch", "static")}
    got = plan_io.decode_plan(plan_io.encode_plan(wire, env_sig=key.env_snapshot), env_sig=key.env_snapshot)
    assert mgr_mod._verify_loaded_entry(got, key)
    got["dispatch"][0].partitions[0].pop()  # a dropped chunk: coverage breaks
    assert not mgr_mod._verify_loaded_entry(got, key)


# ---------------------------------------------------------------------------
# the six flags the runtime key lacked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag", sorted(SIX_KEYS))
def test_repaired_key_flips_key_digest_and_store(monkeypatch, tmp_path, flag):
    assert flag in general.ENV_KEYS_AFFECTING_RUNTIME
    assert flag in j_general.ENV_KEYS_AFFECTING_RUNTIME  # JAX's list carries it
    d = _store(monkeypatch, tmp_path)
    snap, key = general.snapshot_env(), plan_key()
    digest = plan_io.plan_signature_digest(_plan_signature(key))
    assert (d / f"plan-{digest}.bin").exists()
    monkeypatch.setenv(flag, SIX_KEYS[flag])
    assert general.snapshot_env() != snap
    forget_plans()
    flipped = plan_key()
    assert flipped != key
    assert plan_io.plan_signature_digest(_plan_signature(flipped)) != digest
    assert _mgr(flipped).plan_source == "cold"  # the store holds no entry for it
    # and the old entry, read under the flipped snapshot, is a typed miss
    _, miss = plan_store.get_store().read(digest, env_sig=flipped.env_snapshot)
    assert miss.reason == plan_store.MISS_ENV_MISMATCH


# ---------------------------------------------------------------------------
# the armed chaos sites
# ---------------------------------------------------------------------------


def _site_env(monkeypatch, tmp_path, site):
    """Arm the tiers a site needs; for ``plan_cache_read`` populate the
    store first and forget the memory tiers."""
    if site == "plan_cache_read":
        d = _store(monkeypatch, tmp_path)
        plan_key()
        forget_plans()
        return d
    if site == "plan_broadcast":
        return _broadcast(monkeypatch, tmp_path, role="follower")
    return _store(monkeypatch, tmp_path)


@pytest.mark.parametrize("site", ["plan_serialize", "plan_cache_read", "plan_broadcast"])
def test_site_raises_typed_without_fallback(monkeypatch, tmp_path, site):
    _site_env(monkeypatch, tmp_path, site)
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", site)
    with pytest.raises(InjectedFault, match=site):
        plan_key()


@pytest.mark.parametrize("site", ["plan_serialize", "plan_cache_read", "plan_broadcast"])
def test_site_is_a_recorded_miss_with_fallback(monkeypatch, tmp_path, site):
    cold = plan_step(plan_key())
    forget_plans()
    d = _site_env(monkeypatch, tmp_path, site)
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", site)
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    key = plan_key()
    assert _mgr(key).plan_source == "cold"
    assert np.array_equal(plan_step(key), cold)
    counts = telemetry.counters("resilience.")
    assert counts.get("resilience.injected", 0) >= 1 and counts.get("resilience.fallback", 0) >= 1
    if site == "plan_serialize":  # nothing unserializable landed in the store
        assert not list(d.glob("plan-*.bin"))


def test_leader_broadcast_fault_skips_the_publish(monkeypatch, tmp_path):
    d = _broadcast(monkeypatch, tmp_path, role="leader")
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", "plan_broadcast")
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    assert _mgr(plan_key()).plan_source == "cold"
    assert not list(d.glob("bcast-*.bin"))


def test_every_site_down_still_solves_bitwise(monkeypatch, tmp_path):
    cold = plan_step(plan_key())
    forget_plans()
    d = _store(monkeypatch, tmp_path)
    _broadcast(monkeypatch, tmp_path, role="follower")
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT",
                       "plan_cache_read:p=1.0,plan_broadcast:p=1.0,plan_serialize:p=1.0")
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    assert np.array_equal(plan_step(plan_key()), cold)
    counts = telemetry.counters("resilience.")
    assert counts.get("resilience.injected", 0) >= 3 and counts.get("resilience.fallback", 0) >= 3
    assert not list(d.glob("plan-*.bin"))


# ---------------------------------------------------------------------------
# a collective transport: one exchange a resolution
# ---------------------------------------------------------------------------


class _FakeCollective:
    """A collective transport that records its exchanges (one process)."""

    collective = True

    def __init__(self):
        self.calls = []

    def exchange(self, digest, blob):
        self.calls.append(blob)
        return plan_broadcast.BroadcastResult(blob if blob else None)


@pytest.fixture
def fake(monkeypatch):
    transport = _FakeCollective()
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST_ROLE", "leader")
    monkeypatch.setattr(plan_broadcast, "get_transport", lambda group=None: transport)
    return transport


def test_leader_exchanges_once_per_resolution(monkeypatch, fake):
    """A memory hit whose entry lacks the dynamic plan (a static fallback
    under MAGI_ATTENTION_QO_COMM): the publish on the hit is the
    resolution's one exchange, and the dynamic re-solve's persist does not
    exchange again."""
    from magiattention_tpu_torch.meta import _make_attn_meta

    monkeypatch.setenv("MAGI_ATTENTION_QO_COMM", "1")
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")

    def failing(*a, **kw):
        raise RuntimeError("transient dynamic-solve failure")

    monkeypatch.setattr(mgr_mod, "make_dynamic_attn_plan", failing)
    assert _mgr(plan_key()).dynamic_plan is None
    assert len(fake.calls) == 1
    clear_cache()  # the plan memory tier stays warm
    monkeypatch.setattr(mgr_mod, "make_dynamic_attn_plan", _make_attn_meta.make_dynamic_attn_plan)
    assert _mgr(plan_key()).dynamic_plan is not None
    assert len(fake.calls) == 2


@pytest.mark.parametrize("fallback", [True, False])
@pytest.mark.parametrize("site", ["plan_serialize", "plan_broadcast"])
def test_leader_failure_still_completes_the_exchange(monkeypatch, fake, site, fallback):
    """Followers already wait in their receive when a cold leader persists:
    an encode failure, or a fault at the exchange, still completes it once,
    with a zero-length blob (under a typed raise too)."""
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", site)
    if fallback:
        monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
        plan_key()
    else:
        with pytest.raises(InjectedFault, match=site):
            plan_key()
    assert fake.calls == [b""]


def test_follower_fault_still_receives_once(monkeypatch, fake):
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST_ROLE", "follower")
    monkeypatch.setenv("MAGI_ATTENTION_FAULT_INJECT", "plan_broadcast")
    monkeypatch.setenv("MAGI_ATTENTION_FALLBACK", "1")
    assert _mgr(plan_key()).plan_source == "cold"
    assert fake.calls == [None]


def test_genuine_persist_error_is_recorded(monkeypatch, tmp_path):
    _store(monkeypatch, tmp_path)

    def boom(*a, **kw):
        raise ValueError("genuine encode failure")

    monkeypatch.setattr(mgr_mod.plan_io, "encode_plan", boom)
    plan_key()  # must not raise
    assert telemetry.counters("resilience.").get("resilience.fallback", 0) >= 1


def test_blob_for_another_signature_is_rejected(monkeypatch, tmp_path):
    d = _broadcast(monkeypatch, tmp_path, role="leader")
    plan_key()
    (blob_a,) = d.glob("bcast-*.bin")
    from magiattention_tpu_torch import api

    forget_plans()
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST_ROLE", "follower")
    other = [(0, CP_SEQ)]
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST", "0")
    key_b = api.magi_attn_flex_key(other, other, [1], CP_SEQ, CP_SEQ, device="cpu", chunk_size=CP_CHUNK)
    digest_b = plan_io.plan_signature_digest(_plan_signature(key_b))
    (d / f"bcast-{digest_b}.bin").write_bytes(blob_a.read_bytes())
    forget_plans()
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST", "1")
    assert _mgr(api.magi_attn_flex_key(other, other, [1], CP_SEQ, CP_SEQ, device="cpu",
                                       chunk_size=CP_CHUNK)).plan_source == "cold"
    assert telemetry.counters("resilience.").get("resilience.reject", 0) == 1


def test_transport_choice(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST", "1")
    assert isinstance(plan_broadcast.get_transport(None), plan_broadcast.FileTransport)
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST_TRANSPORT", "dist")
    assert plan_broadcast.get_transport(None) is None  # cp 1: nothing to send
    assert plan_broadcast.is_leader(None)
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST_ROLE", "follower")
    assert not plan_broadcast.is_leader(None)
    monkeypatch.setenv("MAGI_ATTENTION_PLAN_BROADCAST", "0")
    assert plan_broadcast.get_transport(None) is None


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------


def test_file_transport_across_two_processes(tmp_path):
    """The leader's process publishes, heals a torn publish on its next
    (warm) resolution; a follower's process then receives the plan, and its
    step is bitwise the leader's."""
    ctx = mp.get_context("spawn")
    directory = str(tmp_path / "bcast")
    from tests.torch_port_cases import plan_file_worker

    for role in ("leader", "follower"):
        proc = ctx.Process(target=plan_file_worker, args=(role, directory, str(tmp_path)))
        proc.start()
        proc.join(300)
        assert proc.exitcode == 0, role
    leader, follower = (np.load(tmp_path / f"{r}.npz") for r in ("leader", "follower"))
    assert list(leader["sources"]) == ["cold", "memory"] and bool(leader["healed"])
    assert list(follower["sources"]) == ["broadcast"]
    assert np.array_equal(follower["out"], leader["out"])


def test_cp2_broadcast_over_gloo():
    from tests.torch_port_cases import plan_bcast_worker

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(plan_bcast_worker, args=(2, os.path.join(d, "init"), d), nprocs=2,
                           start_method="spawn", join=True)
        outs = [np.load(os.path.join(d, f"rank{r}.npz")) for r in range(2)]
    assert [list(o["sources"]) for o in outs] == [
        ["cold", "cold", "memory", "cold"], ["cold", "broadcast", "memory", "cold"],
    ]
    assert list(outs[1]["solves"]) == [0, 0]  # the follower solved nothing
    for o in outs:
        assert np.array_equal(o["bcast"], o["cold"]) and np.array_equal(o["faulted"], o["cold"])


@pytest.mark.parametrize("flag", ["MAGI_ATTENTION_VERIFY_PLANS", "MAGI_ATTENTION_PLAN_STORE",
                                  "MAGI_ATTENTION_PLAN_BROADCAST"])
@pytest.mark.parametrize("args", [[], ["--cp4"]])
def test_chip_smoke_refuses_a_plan_flag(flag, args):
    """chip_smoke.py sets the plan tiers' flags only inside its own phases
    (over a fresh directory): started with one set, it refuses before
    touching the card."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, **{flag: "1"}, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and flag in proc.stderr, proc.stderr
    assert proc.stdout == ""
