"""PyTorch + CUDA port of magiattention_tpu, for NVIDIA Hopper (sm_90a).

It holds four paths. Serving: chunked FFA prefill and paged decode over
a paged KV cache, driven by a continuous-batching engine. Single-device
attention: ``flex_flash_attn_func`` (FFA forward and backward as a
``torch.autograd.Function``). Context parallelism, the main path:
``magi_attn_flex_key -> dispatch -> calc_attn -> undispatch`` (the
dispatch and CP planners, GroupCast/GroupReduce over
``torch.distributed``, the multi-stage runtime, or under
MAGI_ATTENTION_QO_COMM=1 the dynamic qo-comm planner and runtime) and
``roll``, under a Llama trainer.
NSA attention on one device: ``parallel.nsa_attn``, its selected branch
over block-sparse kernels. Their kernels are written by hand in CUDA C++ (``csrc/``) and built with
``nvcc`` at first use; each has a plain PyTorch version beside it, which
CPU tensors take.

The package imports torch and numpy, never jax or ``magiattention_tpu``.
"""

from . import api, comm, common, env, functional, kernels, meta, models, parallel, resilience, serving, testing  # noqa: F401
from .api import (  # noqa: F401
    calc_attn,
    dispatch,
    get_position_ids,
    init_dist_attn_runtime_key,
    init_dist_attn_runtime_mgr,
    magi_attn_flex_dispatch,
    magi_attn_flex_key,
    magi_attn_varlen_dispatch,
    magi_attn_varlen_key,
    roll,
    roll_simple,
    undispatch,
)
from .common import AttnForwardMeta, AttnMaskType  # noqa: F401
from .functional import flex_flash_attn_func  # noqa: F401
from .kernels import PagedKVCache, ffa_attn, paged_attn, paged_decode_attn  # noqa: F401
from .resilience import PageExhaustedError  # noqa: F401
from .serving import ServeConfig, ServeEngine, ServeRequest, ToyModel  # noqa: F401

__all__ = [
    "AttnForwardMeta",
    "AttnMaskType",
    "PageExhaustedError",
    "PagedKVCache",
    "ServeConfig",
    "ServeEngine",
    "ServeRequest",
    "ToyModel",
    "calc_attn",
    "dispatch",
    "ffa_attn",
    "flex_flash_attn_func",
    "get_position_ids",
    "init_dist_attn_runtime_key",
    "init_dist_attn_runtime_mgr",
    "magi_attn_flex_dispatch",
    "magi_attn_flex_key",
    "magi_attn_varlen_dispatch",
    "magi_attn_varlen_key",
    "paged_attn",
    "paged_decode_attn",
    "roll",
    "roll_simple",
    "undispatch",
]
