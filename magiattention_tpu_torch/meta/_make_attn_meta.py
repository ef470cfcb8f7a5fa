"""Attn meta construction (ref: magi_attention/meta/_make_attn_meta.py:40-133).

The port's copy of ``magiattention_tpu/meta/_make_attn_meta.py`` (numpy only, imports
rewired).

Runs the static CP planner (DistAttnSolver). The dynamic qo-comm planner
is not ported yet (ROADMAP queue A6).
"""

from __future__ import annotations

from ..config import DistAttnConfig
from .collection.calc_meta import CalcMeta
from .collection.comm_meta import CommMeta
from .collection.dispatch_meta import DispatchMeta
from .container.bucket import AttnBucket
from .solver.dist_attn_solver import DistAttnSolver
from ..resilience.inject import maybe_inject
from ..utils.profiling import instrument_host


@instrument_host
def make_attn_meta_from_dispatch_meta(
    bucket: AttnBucket,
    dispatch_meta: DispatchMeta,
    config: DistAttnConfig | None = None,
    dispatch_meta_kv: DispatchMeta | None = None,
    mesh_shape: tuple[int, int] | None = None,
) -> tuple[CommMeta, CalcMeta]:
    maybe_inject("comm_plan_build")
    config = config or DistAttnConfig()
    solver = DistAttnSolver(
        bucket=bucket,
        dispatch_meta=dispatch_meta,
        overlap_config=config.overlap_config,
        split_alignment=config.grpcoll_config.split_alignment,
        dispatch_meta_kv=dispatch_meta_kv,
        mesh_shape=mesh_shape,
    )
    return solver.solve()


def make_dynamic_attn_plan(*args, **kwargs):
    """The qo-comm (dynamic) plan: not ported yet (ROADMAP queue A6)."""
    raise NotImplementedError(
        "MAGI_ATTENTION_QO_COMM=1 (the dynamic qo-comm planner and runtime) "
        "is not ported yet: ROADMAP queue A6"
    )
