"""PyTorch + CUDA port of magiattention_tpu, for NVIDIA Hopper (sm_90a).

This slice holds the serving path: chunked FFA prefill and paged decode over
a paged KV cache, driven by a continuous-batching engine. Its two kernels are
written by hand in CUDA C++ (``csrc/``) and built with ``nvcc`` at first use;
each has a plain PyTorch version beside it, which CPU tensors take.

The package imports torch and numpy, never jax or ``magiattention_tpu``.
"""

from . import env, kernels, resilience, serving, testing  # noqa: F401
from .kernels import PagedKVCache, ffa_attn, paged_attn, paged_decode_attn  # noqa: F401
from .resilience import PageExhaustedError  # noqa: F401
from .serving import ServeConfig, ServeEngine, ServeRequest, ToyModel  # noqa: F401

__all__ = [
    "PageExhaustedError",
    "PagedKVCache",
    "ServeConfig",
    "ServeEngine",
    "ServeRequest",
    "ToyModel",
    "ffa_attn",
    "paged_attn",
    "paged_decode_attn",
]
