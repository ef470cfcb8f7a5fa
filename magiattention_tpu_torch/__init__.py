"""PyTorch + CUDA port of magiattention_tpu, for NVIDIA Hopper (sm_90a).

It holds two paths. Serving: chunked FFA prefill and paged decode over a
paged KV cache, driven by a continuous-batching engine. Training on one
device: ``flex_flash_attn_func`` (FFA forward and split backward as a
``torch.autograd.Function``) under a Llama trainer. Their kernels are
written by hand in CUDA C++ (``csrc/``) and built with ``nvcc`` at first
use; each has a plain PyTorch version beside it, which CPU tensors take.

The package imports torch and numpy, never jax or ``magiattention_tpu``.
"""

from . import common, env, functional, kernels, models, resilience, serving, testing  # noqa: F401
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
    "ffa_attn",
    "flex_flash_attn_func",
    "paged_attn",
    "paged_decode_attn",
]
