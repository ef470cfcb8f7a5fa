"""Solve-once-broadcast transport — the wire tier of the plan control
plane (the port's counterpart of ``magiattention_tpu/meta/plan_broadcast.py``).

One rank (the leader — rank 0 of the key's cp group unless overridden by
``MAGI_ATTENTION_PLAN_BROADCAST_ROLE``) solves each plan; every other rank
of the group receives the serialized blob instead of solving it again. Two
transports behind one ``exchange`` interface:

- :class:`DistTransport` — a ``torch.distributed`` broadcast over the key's
  cp group (the JAX package's ``MultihostTransport`` over its distributed
  client). Collective by nature: every rank calls ``exchange`` at the same
  program point (the manager does, once per plan resolution, hits
  included), the leader contributes its blob, everyone receives it. Two
  collectives: the blob's length (with the source's group rank, one
  ``all_reduce(MAX)``, so a role override needs no agreement beforehand),
  then the ``uint8`` payload broadcast from the source; a zero length ends
  the exchange after the first. On NCCL the tensors live on the current
  card, on gloo on the CPU.
- :class:`FileTransport` — shared-directory publish/poll
  (``MAGI_ATTENTION_PLAN_BROADCAST_DIR``), kept as the JAX package wrote
  it. The leader atomically publishes ``bcast-<digest>.bin`` (tmp + fsync
  + rename, as plan_store), and on warm resolutions re-publishes any blob
  that went missing or corrupt (:meth:`FileTransport.published_ok`, the
  heal probe); followers poll with bounded retry and exponential backoff
  under a hard deadline (``..._RETRIES`` / ``..._BACKOFF_MS`` /
  ``..._DEADLINE_MS``).

Degradation contract: a follower that exhausts its retries (or receives a
zero-length blob) gets ``blob=None`` back — the manager records a
``resilience`` event and solves locally; nothing is raised. The
``plan_broadcast`` injection site arms once per exchange and follows the
standard recover-or-typed-raise chaos contract in the manager layer. On a
collective transport a fired injection still completes its side of the
exchange (the leader with a zero-length blob, a follower by receiving and
dropping the blob) before it raises, so no rank is left waiting inside a
collective its peer skipped.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .. import telemetry
from ..env import comm as env_comm
from . import plan_io


@dataclass
class BroadcastResult:
    """Outcome of one exchange: the blob (None = degraded to a local
    solve) plus the retry/backoff telemetry counters."""

    blob: bytes | None
    attempts: int = 1
    backoff_ms: float = 0.0


def is_leader(group=None) -> bool:
    """The leader solves and publishes; followers receive. ``auto``
    resolves to rank 0 of ``group`` (the key's cp group; a key at cp 1 is
    always its own leader)."""
    role = env_comm.plan_broadcast_role()
    if role == "leader":
        return True
    if role == "follower":
        return False
    if group is None:
        return True
    return dist.get_rank(group) == 0


class FileTransport:
    """Shared-directory publish/poll transport."""

    collective = False

    def __init__(self, directory: str) -> None:
        self.directory = directory

    def path_for(self, digest: str) -> str:
        return os.path.join(self.directory, f"bcast-{digest}.bin")

    def exchange(self, digest: str, blob: bytes | None) -> BroadcastResult:
        if blob is not None:  # leader: publish, keep own blob
            self._publish(digest, blob)
            return BroadcastResult(blob)
        return self._receive(digest)

    def _publish(self, digest: str, blob: bytes) -> None:
        path = self.path_for(digest)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            os.makedirs(self.directory, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            telemetry.inc("plan_broadcast.publish_error")

    def published_ok(self, digest: str, env_sig: Any = ()) -> bool:
        """Whether the follower-observable blob for ``digest`` exists and
        decodes cleanly under its binding — the warm leader's heal probe:
        a missing or corrupt publish is re-published on the next warm
        resolution instead of starving followers forever. Never raises."""
        try:
            with open(self.path_for(digest), "rb") as f:
                plan_io.decode_plan(
                    f.read(), env_sig=env_sig, expect_digest=digest
                )
            return True
        except Exception:
            return False

    def _receive(self, digest: str) -> BroadcastResult:
        path = self.path_for(digest)
        retries = max(env_comm.plan_broadcast_retries(), 0)
        backoff_s = max(env_comm.plan_broadcast_backoff_ms(), 1) / 1000.0
        deadline = time.monotonic() + (
            max(env_comm.plan_broadcast_deadline_ms(), 0) / 1000.0
        )
        backoff_total = 0.0
        for attempt in range(retries + 1):
            try:
                with open(path, "rb") as f:
                    return BroadcastResult(
                        f.read(), attempts=attempt + 1,
                        backoff_ms=backoff_total * 1000.0,
                    )
            except OSError:
                pass
            if attempt >= retries:
                break
            wait = min(backoff_s * (2**attempt), 2.0)
            if time.monotonic() + wait > deadline:
                break
            telemetry.inc("plan_broadcast.retry")
            time.sleep(wait)
            backoff_total += wait
        return BroadcastResult(
            None, attempts=attempt + 1, backoff_ms=backoff_total * 1000.0
        )


class DistTransport:
    """A broadcast over one ``torch.distributed`` group. Collective: every
    rank of the group must reach ``exchange`` exactly once per plan
    resolution, in the same order — the manager guarantees that by
    exchanging on every resolution while this transport is active (hits
    included) and never more than once (a leader that already exchanged
    on a hit skips the persist path's publish). A leader whose blob could
    not be built still exchanges, with a zero-length blob, so followers
    waiting in their receive go on to a local solve."""

    collective = True

    def __init__(self, group) -> None:
        self.group = group

    def _device(self) -> torch.device:
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def exchange(self, digest: str, blob: bytes | None) -> BroadcastResult:
        # ``blob is not None`` is the leader's side: it sources the payload,
        # whatever its group rank (MAGI_ATTENTION_PLAN_BROADCAST_ROLE may put
        # the solver on a rank other than 0)
        dev = self._device()
        me = dist.get_rank(self.group)
        head = torch.tensor(
            [len(blob), me] if blob is not None else [0, -1], dtype=torch.int64, device=dev
        )
        dist.all_reduce(head, op=dist.ReduceOp.MAX, group=self.group)
        length, src = (int(x) for x in head.tolist())
        if length == 0:
            return BroadcastResult(None)
        if blob is not None:
            buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
        else:
            buf = torch.empty(length, dtype=torch.uint8, device=dev)
        dist.broadcast(buf, src=dist.get_global_rank(self.group, src), group=self.group)
        return BroadcastResult(blob if blob is not None else buf.cpu().numpy().tobytes())


def get_transport(group=None):
    """The env-configured transport for a key over ``group`` (its cp
    group, None at cp 1), or None when the broadcast tier is off or has
    nothing to do (``dist`` at cp 1). ``auto``: :class:`DistTransport` for
    a group of more than one rank, else the file transport. Never
    raises."""
    if not env_comm.is_plan_broadcast_enable():
        return None
    kind = env_comm.plan_broadcast_transport()
    multi = group is not None and dist.get_world_size(group) > 1
    if kind == "dist":
        return DistTransport(group) if multi else None
    if kind == "file" or not multi:
        return FileTransport(env_comm.plan_broadcast_dir())
    return DistTransport(group)


def exchange_plan(transport, digest: str, blob: bytes | None) -> BroadcastResult:
    """One broadcast exchange over ``transport``; arms the
    ``plan_broadcast`` chaos site. ``blob is not None`` marks the caller
    as the publishing leader. On a collective transport a fired injection
    completes this rank's side of the exchange first (see the module's
    docstring)."""
    from ..resilience.errors import InjectedFault
    from ..resilience.inject import maybe_inject

    try:
        maybe_inject("plan_broadcast")
    except InjectedFault:
        if transport.collective:
            transport.exchange(digest, b"" if blob is not None else None)
        raise
    result = transport.exchange(digest, blob)
    if telemetry.enabled():
        telemetry.record_event(
            "plan_broadcast",
            role="leader" if blob is not None else "follower",
            outcome="ok" if result.blob is not None else "exhausted",
            attempts=result.attempts,
            backoff_ms=result.backoff_ms,
        )
    return result
