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
``make_optim_train_step`` is the optimizer twin (a ``torch.optim``
optimizer in place of optax), and ``forward_dense`` / ``loss_fn_dense``
the single-device float32 twin over a boolean mask, as in JAX.
``LlamaConfig.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).

The parameter trees of the three families (this one, ``moe``,
``video_dit``) are dicts of top-level tensors and a list ``layers`` of
dicts; :class:`Layout` names each family's keys in their fixed order, so
the helpers that flatten, name, rebuild and carry JAX trees over serve
all three.

:func:`shard_params` is JAX's placement rule (ZeRO-3 over the cp axis,
Megatron TP over ``tp_axis``) with each rank keeping its block of every
leaf (``models/shard.py``: the tree keeps ``LAYOUT`` and carries its
specs under ``"sharding"``; :func:`gather_params` is the inverse). The
forward, the trainers and ``remat`` take either tree. The collectives of
one step at cp > 1, besides the attention runtime's own:

- replicated: two ``all_reduce`` calls (the label count; the flat sum of
  the loss and every gradient).
- ZeRO-3: one ``all_gather`` over the cp line per sharded leaf where the
  forward uses it (embed, lm_head and each layer's seven projections;
  the norms stay replicated), again in the recompute under ``remat``; one
  ``reduce_scatter`` per sharded leaf in the backward (its gradient
  arrives summed and cut to the block); the same two ``all_reduce``
  calls, the flat one now carrying the loss and the replicated leaves.
- ZeRO-3 + TP (the key's ``head_axis`` is ``tp_axis``): the same gathers
  (each rank gathers its TP block over the cp line), plus four
  ``all_reduce`` calls over the TP line a layer: the attention's and the
  MLP's outputs leave the TP region (forward), and their inputs' gradients
  (backward); two more a layer in the recompute under ``remat``. Each
  rank computes ``n_heads / tp`` q and ``n_kv_heads / tp`` kv heads. The
  loss's and the flat ``all_reduce`` run over the cp line only: the TP
  ranks hold the same rows, and a replicated leaf's gradient is equal
  across a TP line.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..api import calc_attn, dispatch, get_position_ids
from ..comm.functional import copy_to_region, reduce_from_region
from ..device import resolve_device
from ..dist_attn_runtime_mgr import DistAttnRuntimeKey
from .shard import (  # noqa: F401  (gather_params re-exported)
    COLUMN,
    ROW,
    SHARDING,
    ShardSpec,
    gather_params,
    gatherer,
    shard_tree,
    tp_region,
)

_LAYER_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
)


@dataclass(frozen=True)
class Layout:
    """A family's parameter tree: the top-level tensors ``top``, then a
    list ``"layers"`` of dicts of ``layer``'s tensors, in this order (the
    order of :meth:`leaves`, the gradients and the optimizer's list)."""

    top: tuple[str, ...]
    layer: tuple[str, ...]

    def leaves(self, params: dict) -> list[torch.Tensor]:
        out = [params[key] for key in self.top]
        for lyr in params["layers"]:
            out += [lyr[key] for key in self.layer]
        return out

    def names(self, params: dict) -> list[str]:
        out = list(self.top)
        for i, _ in enumerate(params["layers"]):
            out += [f"layers.{i}.{key}" for key in self.layer]
        return out

    def rebuild(self, leaves: Sequence[torch.Tensor], n_layers: int) -> dict:
        """The tree of ``leaves`` (in :meth:`leaves` order)."""
        it = iter(leaves)
        tree = {key: next(it) for key in self.top}
        tree["layers"] = [{key: next(it) for key in self.layer} for _ in range(n_layers)]
        return tree

    def from_numpy(self, tree: dict, device: torch.device | str | None = None) -> dict:
        """The JAX package's pytree of this family, as numpy arrays
        (``jax.tree.map(np.asarray, ...)``), as float32 tensors on
        ``device`` (None = the card)."""
        device = resolve_device(device)
        leaves = [
            torch.tensor(np.asarray(a, dtype=np.float32), device=device)
            for a in self.leaves(tree)
        ]
        return self.rebuild(leaves, len(tree["layers"]))


LAYOUT = Layout(("embed", "final_norm", "lm_head"), _LAYER_KEYS)


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
    # recompute each layer in the backward (torch.utils.checkpoint): FLOPs
    # for activation memory, the standard long-context training setting
    remat: bool = False

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
    return LAYOUT.from_numpy(tree, device)


def param_list(params: dict) -> list[torch.Tensor]:
    """The parameters in a fixed order (embed, final_norm, lm_head, then
    each layer's in ``_LAYER_KEYS`` order)."""
    return LAYOUT.leaves(params)


def param_names(params: dict) -> list[str]:
    """Names matching :func:`param_list`."""
    return LAYOUT.names(params)


def shard_params(params: dict, mesh, axis: str = "cp", tp_axis: str | None = None) -> dict:
    """This rank's blocks of ``params`` under JAX's rule, leaf by leaf, on
    the ``ProcessMesh`` ``mesh`` (``api.get_mesh(key)``): a leaf of two
    dims or more whose first dim ``axis`` divides is ZeRO-3-sharded on dim
    0 over ``axis``; with ``tp_axis``, the 2-D wq/wk/wv/w_gate/w_up whose
    columns tp divides are column-parallel (dim 1 over ``tp_axis``, dim 0
    over ``axis`` where it divides), and wo/w_down are row-parallel over
    ``(tp_axis, axis)`` where cp * tp divides the rows (else over
    ``tp_axis`` alone where the first dim does not divide by cp); the
    norms stay replicated.

    A row-parallel leaf's layout is the port's own: TP rank ``t`` and cp
    rank ``c`` hold row block ``t * cp + c`` (JAX's ``P((cp, tp))``
    order is ``c * tp + t``), so one gather over the cp line gives TP
    rank ``t`` its rows. :func:`gather_params` gives back JAX's whole
    tensors. The tree keeps :data:`LAYOUT` and carries its specs under
    ``"sharding"``."""
    cp = mesh.shape[axis]
    tp = mesh.shape[tp_axis] if tp_axis else 1

    def spec_of(name, shape):
        dp_ok = len(shape) >= 2 and shape[0] % cp == 0
        d0 = (axis,) if dp_ok else ()
        if tp_axis and len(shape) == 2:
            if name in COLUMN and shape[1] % tp == 0:
                return ShardSpec(d0, (tp_axis,))
            if name in ROW and shape[0] % (cp * tp if dp_ok else tp) == 0:
                return ShardSpec((tp_axis, axis) if dp_ok else (tp_axis,))
        return ShardSpec(d0)

    return shard_tree(params, mesh, spec_of, axis, tp_axis)


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
    attention, wo, residual. Under Megatron TP (``lyr`` a view whose
    projections are this rank's TP blocks) the normed rows enter the TP
    region, q/k/v hold this rank's heads, and wo's partial products leave
    it summed."""
    dt = x.dtype
    group = tp_region(lyr)
    h = copy_to_region(_rms_norm(x, lyr["attn_norm"], cfg.norm_eps), group)
    q = (h @ lyr["wq"].to(dt)).unflatten(-1, (-1, cfg.head_dim))
    k = (h @ lyr["wk"].to(dt)).unflatten(-1, (-1, cfg.head_dim))
    v = (h @ lyr["wv"].to(dt)).unflatten(-1, (-1, cfg.head_dim))
    q = _rope(q, pos, cfg.rope_theta)
    k = _rope(k, pos, cfg.rope_theta)
    attn_out, _ = calc_attn(q, k, v, attn_key)
    return x + reduce_from_region(attn_out.flatten(1) @ lyr["wo"].to(dt), group)


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


def check_cp_group(attn_key: DistAttnRuntimeKey) -> None:
    """A key of cp_size > 1 must carry its group: the trainers sum the
    ranks' gradients over it."""
    if attn_key.cp_size > 1 and attn_key.cp_group is None:
        raise ValueError(
            f"a key of cp_size {attn_key.cp_size} without its cp group: the ranks' "
            "gradients could not be summed"
        )


def ce_share(logits, labels_d, attn_key: DistAttnRuntimeKey):
    """This rank's share of the global masked mean cross entropy over the
    dispatched labels: at cp 1 the mean; at cp > 1 its rows' summed NLL
    over the count of valid labels of every rank (one ``all_reduce`` over
    the key's cp group)."""
    if attn_key.cp_size == 1:
        return masked_ce(logits, labels_d)
    total, count = _nll_sum(logits, labels_d)
    dist.all_reduce(count, group=attn_key.cp_group)
    return total / count.clamp(min=1)


def run_layers(layer: Callable, x, layers: list, remat: bool):
    """``x = layer(x, lyr)`` over ``layers``; with ``remat`` each call is a
    ``torch.utils.checkpoint`` region, its activations recomputed in the
    backward (the layer's collectives issued again there, in the same
    order on every rank). A layer that returns ``(x, aux)`` gets the auxes
    back as a list."""
    auxes = []
    for lyr in layers:
        out = checkpoint(layer, x, lyr, use_reentrant=False) if remat else layer(x, lyr)
        if isinstance(out, tuple):
            out, aux = out
            auxes.append(aux)
        x = out
    return x, auxes


def _mlp(x, lyr, cfg: LlamaConfig):
    dt = x.dtype
    group = tp_region(lyr)
    h = copy_to_region(_rms_norm(x, lyr["mlp_norm"], cfg.norm_eps), group)
    gate = F.silu(h @ lyr["w_gate"].to(dt))
    up = h @ lyr["w_up"].to(dt)
    return x + reduce_from_region((gate * up) @ lyr["w_down"].to(dt), group)


def forward(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, attn_key: DistAttnRuntimeKey):
    """Logits of ``tokens`` ``(S,)`` int, natural order, for this rank's
    dispatched rows: ``(shard, vocab)`` float32 in DISPATCHED order (the
    loss dispatches the labels instead of undispatching the logits)."""
    dt = cfg.tdtype
    use = gatherer(params, attn_key)
    top = use.top(params)
    # this rank's tokens, then their embeddings: the embedding's gradient
    # is this rank's share, as every other parameter's
    x = top["embed"][dispatch(tokens, attn_key).long()].to(dt)  # (shard, dim)
    pos = get_position_ids(attn_key)

    def layer(x, lyr):
        lyr = use.layer(lyr)
        return _mlp(attn_block(x, lyr, cfg, pos, attn_key), lyr, cfg)

    x, _ = run_layers(layer, x, params["layers"], cfg.remat)
    x = _rms_norm(x, top["final_norm"], cfg.norm_eps)
    return (x @ top["lm_head"].to(dt)).float()


def loss_fn(params, cfg: LlamaConfig, tokens, labels, attn_key: DistAttnRuntimeKey):
    """Next-token cross entropy over the dispatched rows (labels < 0 are
    ignored; labels are dispatched with the same permutation). At cp > 1
    this rank's share of the global mean (:func:`ce_share`)."""
    check_cp_group(attn_key)
    logits = forward(params, cfg, tokens, attn_key)
    return ce_share(logits, dispatch(labels, attn_key), attn_key)


def tree_value_and_grad(
    loss_of: Callable, params: dict, layout: Layout, attn_key: DistAttnRuntimeKey | None = None,
):
    """(loss, grads in ``layout.leaves`` order) of ``loss_of(tree)`` by
    autograd. At cp > 1 (``attn_key``'s cp group) the ranks' losses and
    the gradients are added over the group by one flat ``all_reduce``:
    every rank gets the global loss and gradients. On a sharded tree a
    leaf split over the cp axis (a ZeRO-3 leaf, an expert block under
    expert parallelism over it) is this rank's block, its gradient
    already complete: it is not summed."""
    n_layers = len(params["layers"])
    leaves = [p.detach().requires_grad_(True) for p in layout.leaves(params)]
    live = layout.rebuild(leaves, n_layers)
    sharding = params.get(SHARDING)
    if sharding is not None:
        live[SHARDING] = sharding
    loss = loss_of(live)
    grads = list(torch.autograd.grad(loss, leaves))
    loss = loss.detach()
    if attn_key is not None and attn_key.cp_size > 1:
        local = sharding.complete(layout, n_layers) if sharding else [False] * len(grads)
        summed = [i for i, own in enumerate(local) if not own]
        flat = torch.cat([loss.reshape(1).float()] + [grads[i].reshape(-1).float() for i in summed])
        dist.all_reduce(flat, group=attn_key.cp_group)
        loss = flat[0].to(loss.dtype)
        parts = flat[1:].split([grads[i].numel() for i in summed])
        for i, part in zip(summed, parts):
            grads[i] = part.view_as(grads[i]).to(grads[i].dtype)
    return loss, grads


def value_and_grad(params, cfg: LlamaConfig, tokens, labels, attn_key: DistAttnRuntimeKey):
    """(loss, grads in :func:`param_list` order), by autograd. At cp > 1
    the ranks' losses and gradients are added over the cp group by one
    flat ``all_reduce``: every rank gets the global loss and gradients."""
    return tree_value_and_grad(
        lambda live: loss_fn(live, cfg, tokens, labels, attn_key), params, LAYOUT, attn_key
    )


def sgd_(params: list[torch.Tensor], grads: list[torch.Tensor], lr: float) -> None:
    """``p -= lr * g`` in place for each pair."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(g.to(p.dtype), alpha=lr)


def train_step(
    params, cfg: LlamaConfig, tokens, labels, attn_key: DistAttnRuntimeKey, lr: float = 1e-4
):
    """One SGD step ``p -= lr * g``, in place. Returns (params, loss)."""
    loss, grads = value_and_grad(params, cfg, tokens, labels, attn_key)
    sgd_(param_list(params), grads, lr)
    return params, loss


def optimizer_step_(optimizer: torch.optim.Optimizer, params: list[torch.Tensor], grads) -> None:
    """Write ``grads`` into the parameters' ``.grad`` and take one
    ``optimizer.step()``."""
    for p, g in zip(params, grads):
        p.grad = g.to(p.dtype)
    optimizer.step()


# ---------------------------------------------------------------------------
# dense (non-CP) twin + optimizer integration, as in JAX
# ---------------------------------------------------------------------------


def dense_attn(q, k, v, mask, head_dim: int):
    """Replicated float32 masked-softmax attention of ``q (S, hq, d)``
    over ``k, v (S, hk, d)`` under a boolean ``mask (S, S)``, in q's dtype
    (the dense twins' attention, as JAX's ``einsum`` pair)."""
    g = q.shape[1] // k.shape[1]
    kf = k.repeat_interleave(g, dim=1).float()
    vf = v.repeat_interleave(g, dim=1).float()
    logits = torch.einsum("shd,thd->hst", q.float(), kf) * (head_dim ** -0.5)
    logits = logits.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hst,thd->shd", p, vf).to(q.dtype)


def forward_dense(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, mask: torch.Tensor):
    """Same network, replicated dense attention over an explicit boolean
    ``mask (S, S)`` (True: attend) — the single-device twin used to check
    CP convergence parity (JAX ``forward_dense``). Natural order."""
    dt = cfg.tdtype
    x = params["embed"][tokens.long()].to(dt)
    pos = torch.arange(tokens.shape[0], device=x.device)
    for lyr in params["layers"]:
        h = _rms_norm(x, lyr["attn_norm"], cfg.norm_eps)
        q = (h @ lyr["wq"].to(dt)).reshape(-1, cfg.n_heads, cfg.head_dim)
        k = (h @ lyr["wk"].to(dt)).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lyr["wv"].to(dt)).reshape(-1, cfg.n_kv_heads, cfg.head_dim)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        attn_out = dense_attn(q, k, v, mask, cfg.head_dim).reshape(-1, cfg.n_heads * cfg.head_dim)
        x = _mlp(x + attn_out @ lyr["wo"].to(dt), lyr, cfg)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dt)).float()


def loss_fn_dense(params, cfg: LlamaConfig, tokens, labels, mask):
    """Masked mean cross entropy of :func:`forward_dense` (JAX
    ``loss_fn_dense``)."""
    return masked_ce(forward_dense(params, cfg, tokens, mask), labels)


def make_optim_train_step(cfg: LlamaConfig, attn_key: DistAttnRuntimeKey, optimizer):
    """The optimizer step of the CP model (JAX ``make_optax_train_step``).
    ``optimizer`` is a ``torch.optim.Optimizer`` over
    ``param_list(params)``; the returned ``step(params, tokens, labels)``
    runs :func:`value_and_grad` (at cp > 1 the summed gradients), writes
    the gradients into ``.grad``, calls ``optimizer.step()`` and returns
    ``(params, loss)``."""

    def step(params, tokens, labels):
        loss, grads = value_and_grad(params, cfg, tokens, labels, attn_key)
        optimizer_step_(optimizer, param_list(params), grads)
        return params, loss

    return step


def make_optim_train_step_dense(cfg: LlamaConfig, mask: torch.Tensor, optimizer):
    """The dense twin of :func:`make_optim_train_step` (JAX
    ``make_optax_train_step_dense``), same optimizer contract."""

    def step(params, tokens, labels):
        loss, grads = tree_value_and_grad(
            lambda live: loss_fn_dense(live, cfg, tokens, labels, mask), params, LAYOUT
        )
        optimizer_step_(optimizer, param_list(params), grads)
        return params, loss

    return step
