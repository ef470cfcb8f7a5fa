"""FFA kernel tile flags.

Same names as ``magiattention_tpu/env/kernel.py``; the defaults are
Hopper's. The TPU package defaults to 256 x 512 tiles because a TPU core has
megabytes of VMEM. The port's forward kernel keeps its q tile, k tile and v
tile in shared memory as float32 (3 x 64 x 128 x 4 B = 96 KB at head_dim
128, plus a 64 x 68 probability tile), so two CTAs fit in the 227 KB an SM
offers; 64 x 64 is the one tile shape the kernel is compiled for.
"""

from __future__ import annotations

from .general import _get_int


def ffa_block_q() -> int:
    """Q tile rows per CTA step."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_Q", 64)


def ffa_block_k() -> int:
    """K tile rows per work item."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_K", 64)
