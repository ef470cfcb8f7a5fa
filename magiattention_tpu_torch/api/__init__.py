"""User-facing API: the key / dispatch / calc_attn / undispatch functions,
the mask compilers and the data-structure and config re-exports used in
their signatures."""

from ..common.enum import AttnMaskType, AttnOverlapMode  # noqa: F401
from ..common.forward_meta import AttnForwardMeta  # noqa: F401
from ..common.ranges import AttnRanges  # noqa: F401
from ..config import (  # noqa: F401
    DispatchConfig,
    DistAttnConfig,
    GrpCollConfig,
    OverlapConfig,
)
from ..dist_attn_runtime_mgr import DistAttnRuntimeKey  # noqa: F401
from ..functional.flex_flash_attn import flex_flash_attn_func  # noqa: F401
from .functools import (  # noqa: F401
    infer_attn_mask_from_cu_seqlens,
    infer_attn_mask_from_sliding_window,
)
from .magi_attn_interface import (  # noqa: F401
    calc_attn,
    clear_cache,
    dispatch,
    get_position_ids,
    magi_attn_flex_key,
    magi_attn_varlen_key,
    undispatch,
)
