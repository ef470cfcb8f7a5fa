"""Llama-style decoder with context-parallel flex attention.

The port's counterpart of ``magiattention_tpu/models/llama.py``: a
packed-varlen (no batch dim) decoder whose parameters are a plain dict of
float32 master weights (the JAX pytree's layout, so
:func:`params_from_numpy` carries JAX weights over as they are), computed
in ``cfg.dtype``, trained by plain SGD.

As in JAX, attention runs through the runtime key of the mask
(``attn_key``, from ``api.magi_attn_flex_key``): the tokens are
dispatched and embedded, RoPE takes the dispatched rows' global positions
(``get_position_ids``), every layer calls ``calc_attn``, and the loss is
taken over the dispatched labels. Every other op is row-wise or a matrix
product, so the network runs on the dispatched rows as they are.

At cp > 1 (a key with a cp group) each rank holds its own rows. The loss
is the global mean, as JAX's ``masked_ce`` gives it on the global array:
each rank sums its rows' NLL over the global count of valid labels (one
``all_reduce`` of the count), so the ranks' losses add up to the global
loss. Each rank's parameter gradients are then its rows' share of the
global loss's (the tokens are dispatched before the embedding, so the
embedding's gradient is a share too; attention's cross-rank gradients
already return to their owners through GroupReduce), and
:func:`value_and_grad` adds them over the group with one flat
``all_reduce`` that also carries the loss. At cp 1 no collective is
issued.

``train_step`` updates the parameters in place (JAX donates them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..api import calc_attn, dispatch, get_position_ids
from ..device import resolve_device
from ..dist_attn_runtime_mgr import DistAttnRuntimeKey

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


def attn_block(x, lyr, cfg: LlamaConfig, pos, attn_key: DistAttnRuntimeKey):
    """Pre-norm attention sub-block on the dispatched rows: qkv, rope, CP
    attention, wo, residual."""
    dt = x.dtype
    h = _rms_norm(x, lyr["attn_norm"], cfg.norm_eps)
    q = (h @ lyr["wq"].to(dt)).reshape(-1, cfg.n_heads, cfg.head_dim)
    k = (h @ lyr["wk"].to(dt)).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lyr["wv"].to(dt)).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, pos, cfg.rope_theta)
    k = _rope(k, pos, cfg.rope_theta)
    attn_out, _ = calc_attn(q, k, v, attn_key)
    attn_out = attn_out.reshape(-1, cfg.n_heads * cfg.head_dim)
    return x + attn_out @ lyr["wo"].to(dt)


def _nll_sum(logits, labels):
    """(summed cross entropy over positions with ``labels >= 0``, their
    count): ignored positions are clamped before the gather so no wrapped
    index is read."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.clamp(min=0)[:, None].long())[:, 0]
    valid = labels >= 0
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def masked_ce(logits, labels):
    """Mean cross entropy over positions with ``labels >= 0``."""
    total, count = _nll_sum(logits, labels)
    return total / count.clamp(min=1)


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, attn_key: DistAttnRuntimeKey):
    """Logits of ``tokens`` ``(S,)`` int, natural order, for this rank's
    dispatched rows: ``(shard, vocab)`` float32 in DISPATCHED order (the
    loss dispatches the labels instead of undispatching the logits)."""
    dt = cfg.tdtype
    # this rank's tokens, then their embeddings: the embedding's gradient
    # is this rank's share, as every other parameter's
    x = params["embed"][dispatch(tokens, attn_key).long()].to(dt)  # (shard, dim)
    pos = get_position_ids(attn_key)
    for lyr in params["layers"]:
        x = attn_block(x, lyr, cfg, pos, attn_key)
        h = _rms_norm(x, lyr["mlp_norm"], cfg.norm_eps)
        gate = F.silu(h @ lyr["w_gate"].to(dt))
        up = h @ lyr["w_up"].to(dt)
        x = x + (gate * up) @ lyr["w_down"].to(dt)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dt)).float()


def loss_fn(params, cfg: LlamaConfig, tokens, labels, attn_key: DistAttnRuntimeKey):
    """Next-token cross entropy over the dispatched rows (labels < 0 are
    ignored; labels are dispatched with the same permutation). At cp > 1
    this rank's share of the global mean: its rows' summed NLL over the
    count of valid labels of every rank (one ``all_reduce`` over the key's
    cp group)."""
    if attn_key.cp_size > 1 and attn_key.cp_group is None:
        raise ValueError(
            f"a key of cp_size {attn_key.cp_size} without its cp group: the ranks' "
            "gradients could not be summed"
        )
    logits = forward(params, cfg, tokens, attn_key)
    labels_d = dispatch(labels, attn_key)
    if attn_key.cp_size == 1:
        return masked_ce(logits, labels_d)
    total, count = _nll_sum(logits, labels_d)
    dist.all_reduce(count, group=attn_key.cp_group)
    return total / count.clamp(min=1)


def value_and_grad(params, cfg: LlamaConfig, tokens, labels, attn_key: DistAttnRuntimeKey):
    """(loss, grads in :func:`param_list` order), by autograd. At cp > 1
    the ranks' losses and gradients are added over the cp group by one
    flat ``all_reduce``: every rank gets the global loss and gradients."""
    leaves = [p.detach().requires_grad_(True) for p in param_list(params)]
    it = iter(leaves)
    live = {
        "embed": next(it), "final_norm": next(it), "lm_head": next(it),
        "layers": [{key: next(it) for key in _LAYER_KEYS} for _ in params["layers"]],
    }
    loss = loss_fn(live, cfg, tokens, labels, attn_key)
    grads = list(torch.autograd.grad(loss, leaves))
    loss = loss.detach()
    if attn_key.cp_size > 1:
        flat = torch.cat([loss.reshape(1).float()] + [g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=attn_key.cp_group)
        loss = flat[0].to(loss.dtype)
        sizes = [g.numel() for g in grads]
        grads = [
            part.view_as(g).to(g.dtype)
            for part, g in zip(flat[1:].split(sizes), grads)
        ]
    return loss, grads


def train_step(
    params, cfg: LlamaConfig, tokens, labels, attn_key: DistAttnRuntimeKey, lr: float = 1e-4
):
    """One SGD step ``p -= lr * g``, in place. Returns (params, loss)."""
    loss, grads = value_and_grad(params, cfg, tokens, labels, attn_key)
    with torch.no_grad():
        for p, g in zip(param_list(params), grads):
            p.sub_(g.to(p.dtype), alpha=lr)
    return params, loss
