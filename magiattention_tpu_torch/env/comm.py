"""Communication toggles.

The port's copy of the getters of ``magiattention_tpu/env/comm.py`` that the
CP planners and runtime read; the flag names are the same.
"""

from __future__ import annotations

import os

from .general import _get_bool, _get_int


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
