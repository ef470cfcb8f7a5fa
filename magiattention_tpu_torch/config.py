"""Structured per-call configuration (ref: magi_attention/config.py:54-71).

The port's copy of ``magiattention_tpu/config.py`` (numpy only, imports
rewired).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .common.enum import (
    AttnOverlapMode,
    DispatchAlgType,
    DynamicAttnAlgType,
    OverlapAlgType,
)
from .env.comm import split_alignment as _env_split_alignment


@dataclass(frozen=True)
class DispatchConfig:
    """Config for the load-balance dispatch solver (ref dispatch_solver.py:359).

    Attributes:
        alg: chunk->rank assignment algorithm.
        chunk_size: sequence chunk granularity; None = auto-derive.
        top_p: candidate-pool fraction for the TOPP_HEAP algorithms.
        max_backtracks: node budget for BACKTRACKING_PRUNING.
        uneven_shard: allow ranks to own different chunk counts (shards are
            padded to the max on-device; ref DispatchConfig.uneven_shard).
        auto_comm_area_per_row: AUTO-mode cost model — attention-area units
            one remote-KV row costs in wall-clock. Default derived for v5e
            ICI: a K|V row (hk=8, d=dv=128, bf16 = 4 KiB) at ~90 GB/s is
            ~45 ns, one area unit (fwd+bwd ~28 kFLOP at hq=16, d=128) at
            197 TFLOP/s is ~0.15 ns -> ~300. Raise for DCN-dominated
            meshes, lower for small heads.
        auto_tol: AUTO-mode relative cost tolerance within which the
            candidate moving fewer total rows wins the tie.
    """

    alg: DispatchAlgType = DispatchAlgType.MIN_HEAP
    chunk_size: int | None = None
    top_p: float = 0.25
    max_backtracks: int = 10_000
    uneven_shard: bool = False
    auto_comm_area_per_row: float = 300.0
    auto_tol: float = 0.05


@dataclass(frozen=True)
class OverlapConfig:
    """Config for multi-stage compute/comm overlap.

    Attributes:
        enable: False collapses to the single-stage (no-overlap) path.
        mode: static (fixed degree) or dynamic (solver-chosen).
        degree: number of remote stages when static; None = solver decides.
        min_chunk_size / max_num_chunks: remote-workload chunking bounds.
        alg: stage-grouping algorithm.
    """

    enable: bool = True
    mode: AttnOverlapMode = AttnOverlapMode.STATIC
    degree: int | None = 1
    min_chunk_size: int = 512
    max_num_chunks: int = 64
    alg: OverlapAlgType = OverlapAlgType.UNIFORM


@dataclass(frozen=True)
class GrpCollConfig:
    """Config for the group-collective lowering.

    Attributes:
        split_alignment: pad per-destination split sizes to this multiple so
            `jax.lax.all_to_all` sees equal static splits (TPU lane = 128).
            Defaults from ``MAGI_ATTENTION_SPLIT_ALIGNMENT``
            (env.comm.split_alignment); an explicit value here wins.
    """

    split_alignment: int = field(default_factory=_env_split_alignment)


@dataclass(frozen=True)
class DynamicAttnConfig:
    """Config for the dynamic (qo-comm) solver.

    Active when ``MAGI_ATTENTION_QO_COMM=1`` (env.comm.is_qo_comm_enable);
    the reference forces overlap degree 1 under qo-comm (ref config.py:67-71)
    and so do we — the dynamic plan is single-stage by construction.
    """

    alg: DynamicAttnAlgType = DynamicAttnAlgType.BINARY_GREEDY


@dataclass(frozen=True)
class DistAttnConfig:
    """Top-level distributed-attention config (passed per key-init)."""

    dispatch_config: DispatchConfig = field(default_factory=DispatchConfig)
    overlap_config: OverlapConfig = field(default_factory=OverlapConfig)
    grpcoll_config: GrpCollConfig = field(default_factory=GrpCollConfig)
    dynamic_config: DynamicAttnConfig = field(
        default_factory=DynamicAttnConfig
    )
