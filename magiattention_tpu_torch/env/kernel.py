"""FFA kernel tile and GQA-packing flags.

Same names as ``magiattention_tpu/env/kernel.py``; the tile defaults are
Hopper's, the packing defaults the JAX package's. The TPU package defaults
to 256 x 512 tiles because a TPU core has megabytes of VMEM; a Hopper CTA
has 227 KB of shared memory, and the port's FFA kernels are compiled for
q and k tiles of 64 or 128 rows wherever a CTA fits
(``utils/mem_budget.py:compiled_tiles``). The default pair is 64 x 64, the
one every kernel and dtype has.
"""

from __future__ import annotations

import os

from .general import _get_int


def ffa_block_q() -> int:
    """Q tile rows per CTA step."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_Q", 64)


def ffa_block_k() -> int:
    """K tile rows per work item."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_K", 64)


def ffa_block_q_dq() -> int:
    """Q tile rows of the dq backward kernel; 0 = inherit FFA_BLOCK_Q. A
    pair the dq kernel is not compiled for (for the dtype and head dim)
    silently inherits the forward's tiles (``kernels/ffa.py:
    resolve_bwd_overrides``)."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_Q_DQ", 0)


def ffa_block_k_dq() -> int:
    """K tile rows of the dq backward kernel; 0 = inherit FFA_BLOCK_K."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_K_DQ", 0)


def ffa_block_q_dkv() -> int:
    """Q tile rows of the dk/dv (and fused) backward kernel; 0 = inherit
    FFA_BLOCK_Q."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_Q_DKV", 0)


def ffa_block_k_dkv() -> int:
    """K tile rows of the dk/dv (and fused) backward kernel; 0 = inherit
    FFA_BLOCK_K."""
    return _get_int("MAGI_ATTENTION_FFA_BLOCK_K_DKV", 0)


def ffa_blocks_pinned() -> bool:
    """True when the forward tiles are pinned by env: explicit settings
    always beat MAGI_ATTENTION_FFA_AUTO_TILE and mixed dispatch."""
    return (
        "MAGI_ATTENTION_FFA_BLOCK_Q" in os.environ
        or "MAGI_ATTENTION_FFA_BLOCK_K" in os.environ
    )


def ffa_gqa_pack() -> bool:
    """Run the GQA-packed forward kernel (``csrc/ffa_fwd_gqa.cu``: one CTA
    per q tile and block of query heads of one kv head, each K/V tile
    loaded once per work item for the block) where the group is > 1, no
    max-logits output is requested and the packed tiles fit
    (``kernels/ffa.py:fwd_pack_heads``). Opt-in, as in the JAX package."""
    return _get_int("MAGI_ATTENTION_FFA_GQA_PACK", 0) == 1


def ffa_gqa_pack_dq() -> bool:
    """Run the GQA-packed dq backward kernel (``csrc/ffa_bwd_dq_gqa.cu``)
    where the group is > 1 and the packed tiles fit
    (``kernels/ffa.py:dq_pack_heads``). Opt-in, as in the JAX package."""
    return _get_int("MAGI_ATTENTION_FFA_GQA_PACK_DQ", 0) == 1


def ffa_gqa_pack_dkv() -> bool:
    """The JAX package's switch between its packed and unpacked dk/dv
    kernels (on by default). The port has one dk/dv kernel (and one fused
    kernel), which already loops the GQA group inside one CTA per (k tile,
    kv head) with K and V resident: the packed semantics. So either value
    selects that same kernel."""
    return _get_int("MAGI_ATTENTION_FFA_GQA_PACK_DKV", 1) == 1
