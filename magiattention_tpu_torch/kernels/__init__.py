"""Device compute: the hand-written Hopper kernels, their plain versions,
the host plan and the paged KV cache."""

from .ffa import (  # noqa: F401
    ffa_attn,
    ffa_attn_with_plan,
    ffa_bwd_dkv_kernel,
    ffa_bwd_dkv_plain,
    ffa_bwd_dq_kernel,
    ffa_bwd_dq_plain,
    ffa_bwd_mode,
    ffa_delta_kernel,
    ffa_delta_plain,
    ffa_fwd_kernel,
)
from .paged_decode import (  # noqa: F401
    paged_decode_attn,
    paged_decode_kernel,
    paged_decode_plain,
)
from .paged_kv import (  # noqa: F401
    PagedKVCache,
    append_kv,
    assign_pages,
    gather_kv,
    paged_attn,
)
from .sdpa import sdpa_attn  # noqa: F401
from .sdpa_online import sdpa_online_attn  # noqa: F401

# name -> kernel wrapper (``.launches``) / plain version (``.calls``)
_KERNELS = {
    "ffa_fwd": ffa_fwd_kernel,
    "paged_decode": paged_decode_kernel,
    "ffa_bwd_delta": ffa_delta_kernel,
    "ffa_bwd_dq": ffa_bwd_dq_kernel,
    "ffa_bwd_dkv": ffa_bwd_dkv_kernel,
}
_PLAINS = {
    "sdpa_attn": sdpa_attn,
    "paged_decode_plain": paged_decode_plain,
    "ffa_delta_plain": ffa_delta_plain,
    "ffa_bwd_dq_plain": ffa_bwd_dq_plain,
    "ffa_bwd_dkv_plain": ffa_bwd_dkv_plain,
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
    for fn in _PLAINS.values():
        fn.calls = 0


__all__ = [
    "PLAIN_NAMES",
    "PagedKVCache",
    "append_kv",
    "assign_pages",
    "ffa_attn",
    "ffa_attn_with_plan",
    "ffa_bwd_dkv_kernel",
    "ffa_bwd_dkv_plain",
    "ffa_bwd_dq_kernel",
    "ffa_bwd_dq_plain",
    "ffa_bwd_mode",
    "ffa_delta_kernel",
    "ffa_delta_plain",
    "ffa_fwd_kernel",
    "gather_kv",
    "launch_counts",
    "paged_attn",
    "paged_decode_attn",
    "paged_decode_kernel",
    "paged_decode_plain",
    "reset_launch_counts",
    "sdpa_attn",
    "sdpa_online_attn",
]
