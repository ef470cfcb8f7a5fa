"""Llama-style decoder trained through flex attention, on one device.

The port's counterpart of ``magiattention_tpu/models/llama.py``: a
packed-varlen (no batch dim) decoder whose parameters are a plain dict of
float32 master weights (the JAX pytree's layout, so
:func:`params_from_numpy` carries JAX weights over as they are), computed
in ``cfg.dtype``, trained by plain SGD.

Where the JAX functions take a CP runtime key (``attn_key``), these take an
attention callable ``attn(q, k, v) -> (out, meta)``. On one device the JAX
dispatch is the identity (one partition of all chunks, position ids
``arange``), so the JAX model's attention is exactly single-device FFA over
the mask's slices: :func:`flex_attn` binds ``flex_flash_attn_func`` to
them, and :func:`forward` uses positions ``arange(S)``. A later slice
replaces the callable with ``calc_attn`` over the CP planners and runtime.

``train_step`` updates the parameters in place (JAX donates them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..functional.flex_flash_attn import flex_flash_attn_func

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], tuple]

_LAYER_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 64
    ffn_hidden: int = 1408
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(
    cfg: LlamaConfig, seed: int = 0, device: torch.device | str | None = None
) -> dict:
    """Random-init parameters (float32 master weights) from ``seed``, drawn
    on ``device`` (None = the card) by a ``torch.Generator`` of that
    device. The JAX package draws other numbers from the same seed: tests
    carry the JAX weights over with :func:`params_from_numpy`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dim, dh = cfg.dim, cfg.head_dim
    hq, hk = cfg.n_heads, cfg.n_kv_heads

    def dense(shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(shape[0] ** -0.5)

    def ones():
        return torch.ones((dim,), device=device, dtype=torch.float32)

    layers = [
        {
            "attn_norm": ones(),
            "wq": dense((dim, hq * dh)),
            "wk": dense((dim, hk * dh)),
            "wv": dense((dim, hk * dh)),
            "wo": dense((hq * dh, dim)),
            "mlp_norm": ones(),
            "w_gate": dense((dim, cfg.ffn_hidden)),
            "w_up": dense((dim, cfg.ffn_hidden)),
            "w_down": dense((cfg.ffn_hidden, dim)),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": dense((cfg.vocab_size, dim)),
        "final_norm": ones(),
        "lm_head": dense((dim, cfg.vocab_size)),
        "layers": layers,
    }


def params_from_numpy(tree: dict, device: torch.device | str | None = None) -> dict:
    """The JAX package's parameter pytree, as numpy arrays
    (``jax.tree.map(np.asarray, init_params(...))``), as the port's
    float32 parameters on ``device`` (None = the card)."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return {
        "embed": t(tree["embed"]),
        "final_norm": t(tree["final_norm"]),
        "lm_head": t(tree["lm_head"]),
        "layers": [{key: t(lyr[key]) for key in _LAYER_KEYS} for lyr in tree["layers"]],
    }


def param_list(params: dict) -> list[torch.Tensor]:
    """The parameters in a fixed order (embed, final_norm, lm_head, then
    each layer's in ``_LAYER_KEYS`` order)."""
    out = [params["embed"], params["final_norm"], params["lm_head"]]
    for lyr in params["layers"]:
        out += [lyr[key] for key in _LAYER_KEYS]
    return out


def param_names(params: dict) -> list[str]:
    """Names matching :func:`param_list`."""
    out = ["embed", "final_norm", "lm_head"]
    for i, _ in enumerate(params["layers"]):
        out += [f"layers.{i}.{key}" for key in _LAYER_KEYS]
    return out


def flex_attn(q_ranges, k_ranges, attn_type_map=None, **kwargs) -> AttnFn:
    """The attention callable of one mask: ``flex_flash_attn_func`` bound
    to its slices (``kwargs``: e.g. ``backend="sdpa"`` for the plain
    path). On one device this is what the JAX model's ``calc_attn``
    computes."""
    qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
    tmap = None if attn_type_map is None else np.asarray(attn_type_map, np.int32)

    def attn(q, k, v):
        return flex_flash_attn_func(q, k, v, qr, kr, tmap, **kwargs)

    return attn


def _rms_norm(x, w, eps):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * w.to(x.dtype)


def _rope(x, pos, theta):
    """x: (S, h, dh); pos: (S,) global positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs[None, :]  # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def attn_block(x, lyr, cfg: LlamaConfig, pos, attn: AttnFn):
    """Pre-norm attention sub-block: qkv, rope, attention, wo, residual."""
    dt = x.dtype
    h = _rms_norm(x, lyr["attn_norm"], cfg.norm_eps)
    q = (h @ lyr["wq"].to(dt)).reshape(-1, cfg.n_heads, cfg.head_dim)
    k = (h @ lyr["wk"].to(dt)).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lyr["wv"].to(dt)).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, pos, cfg.rope_theta)
    k = _rope(k, pos, cfg.rope_theta)
    attn_out, _ = attn(q, k, v)
    attn_out = attn_out.reshape(-1, cfg.n_heads * cfg.head_dim)
    return x + attn_out @ lyr["wo"].to(dt)


def masked_ce(logits, labels):
    """Mean cross entropy over positions with ``labels >= 0`` (ignored
    positions clamped before the gather so no wrapped index is read)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.clamp(min=0)[:, None].long())[:, 0]
    valid = labels >= 0
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, attn: AttnFn):
    """Logits ``(S, vocab)`` float32 of ``tokens`` ``(S,)`` int (natural
    order: one device, so no dispatch permutation)."""
    dt = cfg.tdtype
    x = params["embed"][tokens.long()].to(dt)  # (S, dim)
    pos = torch.arange(tokens.shape[0], dtype=torch.int32, device=x.device)
    for lyr in params["layers"]:
        x = attn_block(x, lyr, cfg, pos, attn)
        h = _rms_norm(x, lyr["mlp_norm"], cfg.norm_eps)
        gate = F.silu(h @ lyr["w_gate"].to(dt))
        up = h @ lyr["w_up"].to(dt)
        x = x + (gate * up) @ lyr["w_down"].to(dt)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dt)).float()


def loss_fn(params, cfg: LlamaConfig, tokens, labels, attn: AttnFn):
    """Next-token cross entropy (labels < 0 are ignored)."""
    return masked_ce(forward(params, cfg, tokens, attn), labels)


def value_and_grad(params, cfg: LlamaConfig, tokens, labels, attn: AttnFn):
    """(loss, grads in :func:`param_list` order), by autograd."""
    leaves = [p.detach().requires_grad_(True) for p in param_list(params)]
    it = iter(leaves)
    live = {
        "embed": next(it), "final_norm": next(it), "lm_head": next(it),
        "layers": [{key: next(it) for key in _LAYER_KEYS} for _ in params["layers"]],
    }
    loss = loss_fn(live, cfg, tokens, labels, attn)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def train_step(params, cfg: LlamaConfig, tokens, labels, attn: AttnFn, lr: float = 1e-4):
    """One SGD step ``p -= lr * g``, in place. Returns (params, loss)."""
    loss, grads = value_and_grad(params, cfg, tokens, labels, attn)
    with torch.no_grad():
        for p, g in zip(param_list(params), grads):
            p.sub_(g.to(p.dtype), alpha=lr)
    return params, loss
