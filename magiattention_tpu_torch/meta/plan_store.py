"""Crash-safe on-disk plan store — the durable tier of the plan control
plane (the port's copy of ``magiattention_tpu/meta/plan_store.py``).

A :class:`PlanStore` is a flat directory of ``plan-<digest>.bin`` blobs,
keyed by the hex sha256 of the mask signature
(``plan_io.plan_signature_digest``), shared by every process pointed at the
same directory (``MAGI_ATTENTION_PLAN_STORE_DIR``). Its two contracts:

- **Writes never corrupt readers.** Every write goes to a process-unique
  ``.tmp-<pid>-<n>`` sibling and lands via ``os.replace`` — the same atomic
  snapshot idiom as ``telemetry/store.py`` — so a concurrent reader sees
  either the old complete blob or the new complete blob, never a torn one.
  A crash mid-write leaves only an orphan ``.tmp`` file, which the next
  store open garbage-collects once it is older than
  :data:`ORPHAN_TMP_TTL_S` (the TTL keeps a live writer's in-flight tmp
  safe from a concurrently opening process).
- **Reads never raise.** Absent file, I/O error, truncation, bit flip,
  stale wire schema, mismatched env signature — every failure mode decodes
  to a typed :class:`PlanStoreMiss` the caller treats as a cache miss and
  cold-solves through. The single deliberate exception is
  :class:`~..resilience.errors.InjectedFault` from the ``plan_cache_read``
  chaos site, which follows the standard recover-or-typed-raise contract in
  the manager layer.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Any

from .. import telemetry
from ..env import general as env_general
from . import plan_io

# an orphan .tmp older than this is a crash leftover, not an in-flight write
ORPHAN_TMP_TTL_S = 600.0

MISS_ABSENT = "absent"
MISS_IO_ERROR = "io_error"
MISS_SCHEMA = "schema"
MISS_CHECKSUM = "checksum"
MISS_ENV_MISMATCH = "env_mismatch"
MISS_SIG_MISMATCH = "sig_mismatch"
MISS_DECODE = "decode_error"
MISS_VERIFY = "verify_reject"  # recorded by the manager after R1-R5 rejects

_tmp_counter = itertools.count()


@dataclass(frozen=True)
class PlanStoreMiss:
    """Typed read miss: why the store had no usable plan for a digest."""

    reason: str
    detail: str = ""


class PlanStore:
    """One shared plan directory. Construction never raises: an unusable
    directory just makes every read a miss and every write a no-op."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._usable = True
        try:
            os.makedirs(directory, exist_ok=True)
        except OSError:
            self._usable = False
            return
        self._cleanup_orphans()

    # -- paths -------------------------------------------------------------

    def path_for(self, digest: str) -> str:
        return os.path.join(self.directory, f"plan-{digest}.bin")

    def _cleanup_orphans(self) -> None:
        """Remove crash leftovers: ``*.tmp-*`` siblings past the TTL."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        now = time.time()
        removed = 0
        for name in names:
            if ".tmp-" not in name:
                continue
            path = os.path.join(self.directory, name)
            try:
                if now - os.path.getmtime(path) >= ORPHAN_TMP_TTL_S:
                    os.remove(path)
                    removed += 1
            except OSError:
                continue
        if removed and telemetry.enabled():
            telemetry.record_event(
                "plan_store", op="cleanup", outcome="ok", removed=removed,
            )

    # -- read / write ------------------------------------------------------

    def read(
        self, digest: str, env_sig: Any = ()
    ) -> tuple[Any | None, PlanStoreMiss | None]:
        """Load + integrity-check one entry. Returns ``(entry, None)`` on a
        hit and ``(None, PlanStoreMiss)`` on ANY failure; only the
        ``plan_cache_read`` injection site may raise (chaos contract)."""
        from ..resilience.inject import maybe_inject

        maybe_inject("plan_cache_read")
        miss: PlanStoreMiss
        if not self._usable:
            miss = PlanStoreMiss(MISS_IO_ERROR, "store directory unusable")
            self._record("read", miss=miss)
            return None, miss
        try:
            with open(self.path_for(digest), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            miss = PlanStoreMiss(MISS_ABSENT)
            self._record("read", miss=miss)
            return None, miss
        except OSError as e:
            miss = PlanStoreMiss(MISS_IO_ERROR, type(e).__name__)
            self._record("read", miss=miss)
            return None, miss
        try:
            entry = plan_io.decode_plan(
                blob, env_sig=env_sig, expect_digest=digest
            )
        except plan_io.PlanEnvMismatchError as e:
            miss = PlanStoreMiss(MISS_ENV_MISMATCH, str(e))
        except plan_io.PlanSigMismatchError as e:
            miss = PlanStoreMiss(MISS_SIG_MISMATCH, str(e))
        except plan_io.PlanSchemaError as e:
            miss = PlanStoreMiss(MISS_SCHEMA, str(e))
        except plan_io.PlanChecksumError as e:
            miss = PlanStoreMiss(MISS_CHECKSUM, str(e))
        except plan_io.PlanDecodeError as e:
            miss = PlanStoreMiss(MISS_DECODE, str(e))
        else:
            self._record("read", outcome="hit", bytes=len(blob))
            return entry, None
        self._record("read", miss=miss)
        return None, miss

    def write(self, digest: str, blob: bytes) -> bool:
        """Atomically publish one encoded entry; returns success. Never
        raises — a failed persist costs durability, not the step."""
        if not self._usable:
            return False
        path = self.path_for(digest)
        tmp = f"{path}.tmp-{os.getpid()}-{next(_tmp_counter)}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as e:
            try:
                os.remove(tmp)
            except OSError:
                pass
            self._record(
                "write", outcome="error",
                miss=PlanStoreMiss(MISS_IO_ERROR, type(e).__name__),
            )
            return False
        self._record("write", outcome="ok", bytes=len(blob))
        return True

    def _record(
        self,
        op: str,
        outcome: str | None = None,
        miss: PlanStoreMiss | None = None,
        **extra,
    ) -> None:
        if not telemetry.enabled():
            return
        payload: dict[str, Any] = dict(extra)
        if miss is not None:
            outcome = outcome or "miss"
            payload["reason"] = miss.reason
            if miss.detail:
                payload["detail"] = miss.detail
        telemetry.record_event(
            "plan_store", op=op, outcome=outcome or "ok", **payload,
        )
        telemetry.inc(f"plan_store.{op}_{outcome or 'ok'}")


_stores: dict[str, PlanStore] = {}


def get_store() -> PlanStore | None:
    """The env-configured store, or None when the disk tier is off
    (``MAGI_ATTENTION_PLAN_STORE=1`` + ``MAGI_ATTENTION_PLAN_STORE_DIR``).
    One instance per directory per process — orphan cleanup runs on first
    open only."""
    if not env_general.is_plan_store_enable():
        return None
    directory = env_general.plan_store_dir()
    store = _stores.get(directory)
    if store is None:
        store = PlanStore(directory)
        _stores[directory] = store
    return store


def reset() -> None:
    """Drop per-process store handles (tests: fresh orphan cleanup)."""
    _stores.clear()
