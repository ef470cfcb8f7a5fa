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
    apply_padding,
    compute_pad_size,
    full_attention_mask,
    infer_attn_mask_from_cu_seqlens,
    infer_attn_mask_from_sliding_window,
    infer_varlen_mask_from_batch,
    pad_at_dim,
    squash_batch_dim,
    unpad_at_dim,
)
from .magi_attn_interface import (  # noqa: F401
    calc_attn,
    clear_cache,
    dispatch,
    get_most_recent_key,
    get_position_ids,
    init_dist_attn_runtime_key,
    init_dist_attn_runtime_mgr,
    magi_attn_flex_dispatch,
    magi_attn_flex_key,
    magi_attn_varlen_dispatch,
    magi_attn_varlen_key,
    make_flex_key_for_new_mask_after_dispatch,
    make_varlen_key_for_new_mask_after_dispatch,
    roll,
    roll_simple,
    undispatch,
)
