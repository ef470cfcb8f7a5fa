"""Group collectives over ``torch.distributed``."""

from .primitives import (  # noqa: F401
    CastPlan,
    all_gather_v,
    group_cast_all,
    group_cast_rows,
    group_reduce_rows,
)
