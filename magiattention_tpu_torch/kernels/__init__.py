"""Device compute: the hand-written Hopper kernels, their plain versions,
the host plan and the paged KV cache."""

from .block_sparse import (  # noqa: F401
    block_sparse_attn,
    block_sparse_bwd_dkv_kernel,
    block_sparse_bwd_dq_kernel,
    block_sparse_bwd_kernel,
    block_sparse_bwd_plain,
    block_sparse_fwd_kernel,
    block_sparse_fwd_plain,
)
from .ffa import (  # noqa: F401
    ffa_attn,
    ffa_attn_with_plan,
    ffa_bwd_dkv_kernel,
    ffa_bwd_dkv_plain,
    ffa_bwd_dq_gqa_kernel,
    ffa_bwd_dq_kernel,
    ffa_bwd_dq_plain,
    ffa_bwd_fused_kernel,
    ffa_bwd_fused_plain,
    ffa_bwd_mode,
    ffa_delta_kernel,
    ffa_delta_plain,
    ffa_fwd_gqa_kernel,
    ffa_fwd_kernel,
)
from .paged_decode import (  # noqa: F401
    paged_decode_attn,
    paged_decode_attn_int8,
    paged_decode_attn_sharded,
    paged_decode_attn_spec,
    paged_decode_int8_kernel,
    paged_decode_int8_plain,
    paged_decode_kernel,
    paged_decode_plain,
    paged_decode_spec_kernel,
    paged_decode_spec_plain,
)
from .paged_kv import (  # noqa: F401
    PagedKVCache,
    append_kv,
    assign_pages,
    gather_kv,
    paged_attn,
)
from .sdpa import dense_max_logits, sdpa_attn  # noqa: F401
from .sdpa_online import sdpa_online_attn  # noqa: F401

# name -> kernel wrapper (``.launches``) / plain version (``.calls``)
_KERNELS = {
    "ffa_fwd": ffa_fwd_kernel,
    "paged_decode": paged_decode_kernel,
    "ffa_bwd_delta": ffa_delta_kernel,
    "ffa_bwd_dq": ffa_bwd_dq_kernel,
    "ffa_bwd_dkv": ffa_bwd_dkv_kernel,
    "ffa_bwd_fused": ffa_bwd_fused_kernel,
    "ffa_fwd_gqa": ffa_fwd_gqa_kernel,
    "ffa_bwd_dq_gqa": ffa_bwd_dq_gqa_kernel,
    "paged_decode_spec": paged_decode_spec_kernel,
    "paged_decode_int8": paged_decode_int8_kernel,
    "block_sparse_fwd": block_sparse_fwd_kernel,
    "block_sparse_bwd_dq": block_sparse_bwd_dq_kernel,
    "block_sparse_bwd_dkv": block_sparse_bwd_dkv_kernel,
}
_PLAINS = {
    "sdpa_attn": sdpa_attn,
    "sdpa_online_attn": sdpa_online_attn,
    "paged_decode_plain": paged_decode_plain,
    "ffa_delta_plain": ffa_delta_plain,
    "ffa_bwd_dq_plain": ffa_bwd_dq_plain,
    "ffa_bwd_dkv_plain": ffa_bwd_dkv_plain,
    "ffa_bwd_fused_plain": ffa_bwd_fused_plain,
    "paged_decode_spec_plain": paged_decode_spec_plain,
    "paged_decode_int8_plain": paged_decode_int8_plain,
    "block_sparse_fwd_plain": block_sparse_fwd_plain,
    "block_sparse_bwd_plain": block_sparse_bwd_plain,
}

PLAIN_NAMES = tuple(_PLAINS)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel and calls of each plain version so far."""
    return {
        **{name: fn.launches for name, fn in _KERNELS.items()},
        **{name: fn.calls for name, fn in _PLAINS.items()},
    }


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "tile_launches"):
            fn.tile_launches.clear()
    for fn in _PLAINS.values():
        fn.calls = 0


def tile_launch_counts() -> dict[str, dict[str, int]]:
    """Launches of each tiled FFA kernel so far, by dtype and tiles
    (``"bfloat16 BQxBK"``)."""
    return {
        name: {
            f"{str(dt).removeprefix('torch.')} {bq}x{bk}": n
            for (dt, bq, bk), n in sorted(fn.tile_launches.items(), key=str)
        }
        for name, fn in _KERNELS.items() if hasattr(fn, "tile_launches")
    }


__all__ = [
    "PLAIN_NAMES",
    "PagedKVCache",
    "append_kv",
    "assign_pages",
    "block_sparse_attn",
    "block_sparse_bwd_dkv_kernel",
    "block_sparse_bwd_dq_kernel",
    "block_sparse_bwd_kernel",
    "block_sparse_bwd_plain",
    "block_sparse_fwd_kernel",
    "block_sparse_fwd_plain",
    "dense_max_logits",
    "ffa_attn",
    "ffa_attn_with_plan",
    "ffa_bwd_dkv_kernel",
    "ffa_bwd_dkv_plain",
    "ffa_bwd_dq_gqa_kernel",
    "ffa_bwd_dq_kernel",
    "ffa_bwd_dq_plain",
    "ffa_bwd_fused_kernel",
    "ffa_bwd_fused_plain",
    "ffa_bwd_mode",
    "ffa_delta_kernel",
    "ffa_delta_plain",
    "ffa_fwd_gqa_kernel",
    "ffa_fwd_kernel",
    "gather_kv",
    "launch_counts",
    "paged_attn",
    "paged_decode_attn",
    "paged_decode_attn_int8",
    "paged_decode_attn_sharded",
    "paged_decode_attn_spec",
    "paged_decode_int8_kernel",
    "paged_decode_int8_plain",
    "paged_decode_kernel",
    "paged_decode_plain",
    "paged_decode_spec_kernel",
    "paged_decode_spec_plain",
    "reset_launch_counts",
    "sdpa_attn",
    "tile_launch_counts",
    "sdpa_online_attn",
]
