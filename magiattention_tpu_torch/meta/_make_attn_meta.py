"""Attn meta construction (ref: magi_attention/meta/_make_attn_meta.py:40-133).

The port's copy of ``magiattention_tpu/meta/_make_attn_meta.py`` (numpy only, imports
rewired).

Picks the CP planner: the static DistAttnSolver, or the dynamic qo-comm
DynamicAttnSolver when qo-comm is on (ref :62), and runs solve().
"""

from __future__ import annotations

from ..common.rectangle import AttnRectangles
from ..config import DistAttnConfig
from .collection.calc_meta import CalcMeta
from .collection.comm_meta import CommMeta
from .collection.dispatch_meta import DispatchMeta
from .collection.dynamic_meta import DynamicAttnPlan
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


def make_dynamic_attn_plan(
    q_ranges,
    k_ranges,
    attn_mask_type,
    dispatch_meta: DispatchMeta,
    config: DistAttnConfig | None = None,
    dispatch_meta_kv: DispatchMeta | None = None,
    prev_state=None,
) -> DynamicAttnPlan:
    """Build the qo-comm plan from global mask metadata (ref
    dynamic_attn_solver.py:236 solve — rectangles-based global assignment).

    ``prev_state`` (a DynSolveState from a previous step's solve) enables
    the incremental re-solve: rectangles unchanged since the previous mask
    keep their rank assignment and only new ones run the algorithm.
    """
    from .solver.dynamic_attn_solver import DynamicAttnSolver

    maybe_inject("dynamic_plan_solve")
    config = config or DistAttnConfig()
    rects = AttnRectangles.from_ranges(q_ranges, k_ranges, attn_mask_type)
    solver = DynamicAttnSolver(
        rects=rects,
        dispatch_meta_q=dispatch_meta,
        dispatch_meta_kv=dispatch_meta_kv,
        alg=config.dynamic_config.alg,
        split_alignment=config.grpcoll_config.split_alignment,
    )
    return solver.solve(prev_state=prev_state)
