"""Communication toggles.

The port's copy of the getters of ``magiattention_tpu/env/comm.py`` that the
CP planners and runtime read; the flag names are the same.
"""

from __future__ import annotations

import os

from .general import _get_bool, _get_int, _get_str


def is_hierarchical_comm_enable() -> bool:
    """Two-level (inter-node x intra-node) group-collective planning: a
    key over a pair ``cp_axis`` of a mesh plans and runs each GroupCast in
    two phases (``comm/hier.py``); a flat cp group is unaffected."""
    return _get_bool("MAGI_ATTENTION_HIERARCHICAL_COMM")


def is_qo_comm_enable() -> bool:
    """Move q/o/do instead of (only) kv — the dynamic solver."""
    return _get_bool("MAGI_ATTENTION_QO_COMM")


def is_fwd_high_precision_reduce_enable() -> bool:
    """Return partial out rows to their owner ranks in float32 instead of
    the compute dtype (default off, as in the reference). Only the qo-comm
    runtime sends partial out (functional/dynamic_dist_attn.py); the
    static runtime never does, so it is a no-op there. Doubles that wire
    volume for a more precise lse merge."""
    return _get_bool("MAGI_ATTENTION_FWD_HIGH_PRECISION_REDUCE")


def is_bwd_high_precision_reduce_enable() -> bool:
    """Send partial dk/dv (and, on the qo-comm runtime, dq) back to their
    owner ranks in float32 instead of the compute dtype (default off, as in
    the reference). Doubles the backward's GroupReduce bytes; the partials
    are summed in float32 either way (the kernels emit float32)."""
    return _get_bool("MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE")


def split_alignment() -> int:
    """Pad the planned receive buffers to a multiple of this; the default
    of ``GrpCollConfig.split_alignment`` (config.py)."""
    return _get_int("MAGI_ATTENTION_SPLIT_ALIGNMENT", 128)


def is_ragged_grpcoll_enable() -> bool:
    """Plan the ``ragged`` wire lowering (true per-pair splits) for the
    stages. ``auto`` (the default) resolves to the portable tiers, as the
    JAX package does on a CPU backend, so plans compare field by field.
    The port executes every planned lowering the same way: one
    ``all_to_all_single`` with the true per-pair splits."""
    v = os.environ.get("MAGI_ATTENTION_RAGGED_GRPCOLL", "auto").lower()
    return v in ("1", "true", "on")


def is_plan_broadcast_enable() -> bool:
    """The solve-once-broadcast tier of the plan control plane
    (``meta/plan_broadcast.py``): the leader (rank 0 of the key's cp
    group) solves, every other rank receives the serialized plan instead
    of solving it again. Reuse is byte-exact (every received plan is
    checksum-checked and verified, R1-R5), so, like
    MAGI_ATTENTION_PLAN_CACHE and _PLAN_STORE, not a runtime-key flag."""
    return _get_bool("MAGI_ATTENTION_PLAN_BROADCAST")


def plan_broadcast_transport() -> str:
    """Broadcast transport: ``auto`` (``dist`` for a key whose cp group
    has more than one rank, else the file transport) | ``dist`` (a
    ``torch.distributed`` broadcast over the key's cp group) | ``file``
    (shared-directory publish/poll)."""
    return _get_str("MAGI_ATTENTION_PLAN_BROADCAST_TRANSPORT", "auto").lower()


def plan_broadcast_dir() -> str:
    """Shared directory of the ``file`` broadcast transport."""
    return _get_str("MAGI_ATTENTION_PLAN_BROADCAST_DIR", "plan_broadcast")


def plan_broadcast_role() -> str:
    """Role override of the broadcast tier: ``auto`` (leader iff rank 0 of
    the key's cp group) | ``leader`` | ``follower``."""
    return _get_str("MAGI_ATTENTION_PLAN_BROADCAST_ROLE", "auto").lower()


def plan_broadcast_retries() -> int:
    """Receive attempts after the first before the file transport gives up
    and the follower solves locally."""
    return _get_int("MAGI_ATTENTION_PLAN_BROADCAST_RETRIES", 3)


def plan_broadcast_backoff_ms() -> int:
    """Initial retry backoff of the file transport (doubles per attempt,
    capped by the deadline)."""
    return _get_int("MAGI_ATTENTION_PLAN_BROADCAST_BACKOFF_MS", 50)


def plan_broadcast_deadline_ms() -> int:
    """Hard wall-clock budget of one file-transport receive, retries
    included; running out is a recorded degradation, never a raise."""
    return _get_int("MAGI_ATTENTION_PLAN_BROADCAST_DEADLINE_MS", 5000)
