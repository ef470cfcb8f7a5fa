"""Group collectives over ``torch.distributed``: the CP runtime's
GroupCast/GroupReduce (:mod:`.primitives`) and the baselines'
differentiable subgroup collectives (:mod:`.functional`)."""

from .primitives import (  # noqa: F401
    CastPlan,
    all_gather_v,
    group_cast_all,
    group_cast_rows,
    group_reduce_rows,
)
