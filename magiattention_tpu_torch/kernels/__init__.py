"""Device compute: the hand-written Hopper kernels, their plain versions,
the host plan and the paged KV cache."""

from .ffa import ffa_attn, ffa_attn_with_plan, ffa_fwd_kernel  # noqa: F401
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


def launch_counts() -> dict[str, int]:
    """Launches of each kernel and calls of each plain version so far."""
    return {
        "ffa_fwd": ffa_fwd_kernel.launches,
        "paged_decode": paged_decode_kernel.launches,
        "sdpa_attn": sdpa_attn.calls,
        "paged_decode_plain": paged_decode_plain.calls,
    }


def reset_launch_counts() -> None:
    ffa_fwd_kernel.launches = 0
    paged_decode_kernel.launches = 0
    sdpa_attn.calls = 0
    paged_decode_plain.calls = 0


__all__ = [
    "PagedKVCache",
    "append_kv",
    "assign_pages",
    "ffa_attn",
    "ffa_attn_with_plan",
    "ffa_fwd_kernel",
    "gather_kv",
    "launch_counts",
    "paged_attn",
    "paged_decode_attn",
    "paged_decode_kernel",
    "paged_decode_plain",
    "reset_launch_counts",
    "sdpa_attn",
]
