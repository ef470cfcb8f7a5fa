"""Model families trained through the port's attention."""

from .llama import (  # noqa: F401
    LlamaConfig,
    flex_attn,
    forward,
    init_params,
    loss_fn,
    params_from_numpy,
    train_step,
    value_and_grad,
)

__all__ = [
    "LlamaConfig",
    "flex_attn",
    "forward",
    "init_params",
    "loss_fn",
    "params_from_numpy",
    "train_step",
    "value_and_grad",
]
