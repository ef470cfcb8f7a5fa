"""Model families trained through the port's attention: a Llama decoder,
a Magi-1-style video diffusion transformer (``video_dit``) and a
Mixtral-style MoE decoder with expert parallelism (``moe``);
``convert`` maps HuggingFace Llama and Mixtral weights onto them."""

from . import video_dit  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig,
    forward,
    init_params,
    loss_fn,
    params_from_numpy,
    train_step,
    value_and_grad,
)
from .moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_forward,
    moe_train_step,
    shard_moe_params,
)

__all__ = [
    "LlamaConfig",
    "MoEConfig",
    "forward",
    "init_moe_params",
    "init_params",
    "loss_fn",
    "moe_forward",
    "moe_train_step",
    "params_from_numpy",
    "shard_moe_params",
    "train_step",
    "value_and_grad",
    "video_dit",
]
