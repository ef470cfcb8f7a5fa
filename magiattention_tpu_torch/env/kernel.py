"""FFA kernel tile and GQA-packing flags.

Same names as ``magiattention_tpu/env/kernel.py``; the tile defaults are
Hopper's, the packing defaults the JAX package's. The TPU package defaults to 256 x 512 tiles because a TPU core has
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
