"""Mixture-of-Experts decoder with expert parallelism (EP) over
``torch.distributed``.

The port's counterpart of ``magiattention_tpu/models/moe.py``: Llama's
backbone (attention through the CP runtime key) with a routed MoE FFN in
every layer. Routing is JAX's GShard policy exactly: router logits and
probabilities in float32, Mixtral gating (a softmax over the top-k
logits, ties to the lower expert index as ``lax.top_k``), Switch's
auxiliary load-balance loss over the top-1 choices, a capacity of
``C = ceil(K * S / E * capacity_factor)`` slots per expert from the
routed row count, every token's first choice ahead of any second choice,
and overflow dropped (its combine weight 0, the residual carries it).

JAX builds ``(S, E, C)`` one-hot dispatch and combine tensors and
multiplies by them (static dense products for XLA). Here the same slots
are computed with indices: each kept (token, choice) gets its slot
``e * C + c``, the slots are filled by one gather (zero rows where no
token landed), each projection of the expert FFN is one ``torch.bmm``
over ``(E_local, slots, dim)``, and each token's output is the
gate-weighted sum of its at most ``K`` slot rows.

EP: the experts are stacked on a leading dim; expert ``e`` lives on the
EP group rank ``e // (E / ep)``. The token slots go to their experts'
ranks and come back through two ``all_to_all_single`` exchanges over the
group, laid out as JAX's ``(ep, E/ep, C, d)`` exchange
(``comm.functional.all_to_all``: an autograd function whose backward is
the inverse exchange). ``aux`` is the group mean (JAX's ``pmean``).

Per-rank processes: at cp > 1 each rank holds its dispatched rows. With
``ep_axis`` the key's cp axis (JAX's layout of EP group == CP group)
each rank routes its own rows, as each shard of JAX's ``shard_map``
does. With ``ep_axis`` another axis of the key's mesh (``"tp"`` of a
(cp, tp) mesh), JAX's ``shard_map`` gives EP rank ``t`` the rows
``[t * S / ep, (t + 1) * S / ep)`` of the global dispatched array,
replicated over the cp axis: here each rank gathers the cp line's rows
(``all_gather``), takes its EP block (``scatter_to_region`` over the EP
line, whose ranks run alike), routes it, and gathers the EP line's
outputs back (``gather_from_region``) to keep its own rows; the router
enters the EP region (``copy_to_region``: its gradient summed over the
EP line) and aux is the EP line's mean (``reduce_from_region``), so aux
and the drops are JAX's per shard. Without EP, JAX's layer routes the
global dispatched array; here each rank gathers every rank's rows
(``all_gather``, whose backward reduce-scatters), routes all of them on
the whole expert stacks and keeps its own rows' outputs, so capacity and
drops are JAX's. Every rank then runs the expert FFN over all ``cp * S``
rows, cp times one shard's work (JAX's global array pays it once across
the devices): at cp > 1, pass ``ep_axis``.

:func:`shard_moe_params` is JAX's: the expert stacks split by expert
over ``ep_axis`` (each rank's block, used as held), or without it
ZeRO-3-sharded over ``dp_axis`` (gathered each layer before the FFN);
every other leaf follows llama's ZeRO-3 rule over ``dp_axis``.

Gradients at cp > 1 follow Llama's convention: each rank's loss is its
share of the global loss (the CE share ``nll_sum_r / global_count``, the
aux share ``aux_coef * aux / cp``), and one flat ``all_reduce`` sums the
gradients of the leaves not split over the cp axis. A ZeRO-3 leaf's
gradient arrives summed by its gather's backward, and an expert block's
under EP over the cp axis is complete: every rank's contribution brought
home by the exchange's backward.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..api import dispatch, get_mesh, get_position_ids
from ..comm.functional import (
    all_gather,
    all_to_all,
    copy_to_region,
    gather_from_region,
    reduce_from_region,
    scatter_to_region,
)
from ..device import resolve_device
from ..dist_attn_runtime_mgr import DistAttnRuntimeKey
from .llama import (
    Layout,
    LlamaConfig,
    _rms_norm,
    attn_block,
    ce_share,
    check_cp_group,
    run_layers,
    sgd_,
    tree_value_and_grad,
)
from .shard import ShardSpec, gatherer, shard_tree, zero3_spec

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
LAYOUT = Layout(
    ("embed", "final_norm", "lm_head"),
    ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router", *_EXPERT_KEYS),
)


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    """Llama backbone with MoE FFN layers (attention path unchanged)."""

    n_experts: int = 8
    top_k: int = 2
    # per-expert token slots per routed shard = ceil(top_k * S / E * cf)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


def init_moe_params(
    cfg: MoEConfig, seed: int = 0, device: torch.device | str | None = None
) -> dict:
    """Random-init parameters (float32 master weights) from ``seed`` on
    ``device`` (None = the card): the Llama backbone, a router ``(dim,
    E)`` and expert stacks ``(E, dim, ffn)``, ``(E, ffn, dim)`` per layer,
    each weight N(0, 1) / sqrt(fan_in) as in JAX. The JAX package draws
    other numbers from the same seed: tests carry its weights over with
    :func:`moe_params_from_numpy`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dim, dh, ffn, E = cfg.dim, cfg.head_dim, cfg.ffn_hidden, cfg.n_experts
    hq, hk = cfg.n_heads, cfg.n_kv_heads

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(fan_in ** -0.5)

    def ones():
        return torch.ones((dim,), device=device, dtype=torch.float32)

    layers = [
        {
            "attn_norm": ones(),
            "wq": dense((dim, hq * dh), dim),
            "wk": dense((dim, hk * dh), dim),
            "wv": dense((dim, hk * dh), dim),
            "wo": dense((hq * dh, dim), hq * dh),
            "mlp_norm": ones(),
            "router": dense((dim, E), dim),
            "w_gate": dense((E, dim, ffn), dim),
            "w_up": dense((E, dim, ffn), dim),
            "w_down": dense((E, ffn, dim), ffn),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "embed": dense((cfg.vocab_size, dim), dim),
        "final_norm": ones(),
        "lm_head": dense((dim, cfg.vocab_size), dim),
        "layers": layers,
    }


def moe_params_from_numpy(tree: dict, device: torch.device | str | None = None) -> dict:
    """The JAX package's MoE pytree, as numpy arrays, as the port's float32
    parameters on ``device`` (None = the card)."""
    return LAYOUT.from_numpy(tree, device)


def _check_experts_divisible(n_experts: int, ep: int, ep_axis) -> None:
    if ep and n_experts % ep:
        raise ValueError(
            f"n_experts={n_experts} must be divisible by the ep axis size "
            f"{ep} (axis {ep_axis!r})"
        )


def shard_moe_params(params: dict, mesh, dp_axis: str = "cp", ep_axis: str | None = None) -> dict:
    """This rank's blocks of ``params`` under JAX's rule on the
    ``ProcessMesh`` ``mesh``: the expert stacks (3-D ``w_gate``, ``w_up``,
    ``w_down``) split by expert over ``ep_axis`` (block ``[r * E/ep, (r +
    1) * E/ep)`` for coordinate ``r``), or without it ZeRO-3-sharded over
    ``dp_axis`` where it divides the expert count, else replicated; every
    other leaf follows llama's ZeRO-3 rule over ``dp_axis``. ``ep_axis``
    may equal ``dp_axis``. The tree keeps :data:`LAYOUT` and carries its
    specs under ``"sharding"``."""
    dp = mesh.shape[dp_axis]
    ep = mesh.shape[ep_axis] if ep_axis else 1

    def spec_of(name, shape):
        if name in _EXPERT_KEYS and len(shape) == 3:
            if ep_axis:
                _check_experts_divisible(shape[0], ep, ep_axis)
                return ShardSpec((ep_axis,), ep=True)
            return ShardSpec((dp_axis,) if shape[0] % dp == 0 else ())
        return zero3_spec(shape, mesh, dp_axis)

    return shard_tree(params, mesh, spec_of, dp_axis, None)


# ---------------------------------------------------------------------------
# the MoE FFN layer
# ---------------------------------------------------------------------------


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, ties to
    the lower index (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(h32: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """Top-k routing of ``h32 (S, dim)`` float32 over ``router_w (dim,
    E)``: JAX ``_route``'s policy as slot indices.

    Returns ``(slot, gates, aux, C)``: ``slot (S, K)`` int64, the slot
    ``e * C + c`` of each (token, choice), ``E * C`` where it was dropped;
    ``gates (S, K)`` float32, the Mixtral gate of each choice, 0 where
    dropped; the Switch aux loss (a float32 scalar); the capacity ``C``.
    """
    S = h32.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = int(np.ceil(K * S / E * cfg.capacity_factor))
    logits = h32 @ router_w  # (S, E) float32
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(logits, K)  # (S, K)
    gates = torch.softmax(topv, dim=-1)
    # Switch aux loss: E * mean_frac_per_expert . mean_prob_per_expert
    sel1 = F.one_hot(topi[:, 0], E).float()
    aux = E * (sel1.mean(dim=0) @ probs.mean(dim=0))
    # slot in expert via a cumsum over the (K, S) priority order: every
    # token's k = 0 choice before any k = 1 choice (GShard's policy)
    flat = topi.T.reshape(-1)  # (K*S,)
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(dim=0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, E * C).reshape(K, S).T
    return slot, gates * keep.reshape(K, S).T, aux, C


def _moe_ffn_local(h, router, w_gate, w_up, w_down, cfg: MoEConfig, group=None, ep: int = 1,
                   rank: int = 0, replicas: bool = False):
    """MoE FFN on one shard's tokens ``h (S_local, dim)``: ``(y, aux)``.

    With ``ep > 1`` the token slots go to the expert shards of ``group``
    and back (this process is group rank ``rank``) and ``aux`` is the
    group mean. The expert stacks are either the whole stack (this rank
    computes its block of it) or already its block ``(E/ep, ...)``.
    ``replicas``: the group's ranks hold the same rows outside the layer
    (EP over an axis other than cp), so the router and whole stacks enter
    the group's region and aux leaves it as a mean; otherwise the group
    is the cp line, whose ranks' losses add.
    """
    dt = h.dtype
    S, d = h.shape
    E = cfg.n_experts
    if replicas:
        router = copy_to_region(router, group)
    slot, gates, aux, C = _route(h.float(), router, cfg)

    # fill the (E, C) slots by a gather: slot -> its token, else a zero row.
    # index_select, not advanced indexing: its backward is index_add_,
    # where indexing's sorts the indices (3.6 ms a call at Mixtral's widths
    # on an H100). A token's K gradient rows then add in either order: at
    # top-2 that sums alike, above it the last bit may differ run to run
    tok = torch.arange(S, device=h.device).repeat(cfg.top_k)
    src = torch.full((E * C + 1,), S, dtype=torch.long, device=h.device)
    src = src.scatter(0, slot.T.reshape(-1), tok)[: E * C]
    slots = torch.cat([h, h.new_zeros((1, d))]).index_select(0, src).view(E, C, d)

    n_local = E // ep
    if w_gate.shape[0] != n_local:  # the whole stacks: this rank's block
        lo, hi = rank * n_local, (rank + 1) * n_local
        w_gate, w_up, w_down = (
            (copy_to_region(w, group) if replicas else w)[lo:hi] for w in (w_gate, w_up, w_down))
    if ep > 1:
        # send each peer its expert block's slots, receive this block's
        # slots from every peer: (ep = source, E/ep, C, d), then source
        # peers stacked into the slot axis (E/ep, ep*C, d)
        recv = all_to_all(slots, group, 0, 0).view(ep, n_local, C, d)
        slots = recv.transpose(0, 1).reshape(n_local, ep * C, d)
        if replicas:
            aux = reduce_from_region(aux, group) / ep
        else:
            mean = aux.detach().clone()
            dist.all_reduce(mean, group=group)
            # the group mean's value; the gradient flows to this rank's aux
            aux = aux + (mean / ep - aux).detach()

    # batched expert FFN: one bmm per projection over the local experts
    g = F.silu(torch.bmm(slots, w_gate.to(dt)))
    u = torch.bmm(slots, w_up.to(dt))
    out = torch.bmm(g * u, w_down.to(dt))

    if ep > 1:
        # the inverse exchange: split the slot axis back by token owner,
        # (ep, E/ep, C, d) -> all_to_all -> (E, C, d)
        send = out.view(n_local, ep, C, d).transpose(0, 1).reshape(E, C, d)
        out = all_to_all(send, group, 0, 0)

    rows = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))]).index_select(
        0, slot.reshape(-1)).view(S, -1, d)  # (S, K, d)
    y = (gates.to(dt).float()[:, :, None] * rows.float()).sum(dim=1).to(dt)
    return y, aux


def moe_ffn(h, lyr, cfg: MoEConfig, mesh=None, ep_axis=None):
    """Public MoE FFN entry on this process's tokens ``h``.

    - ``mesh`` (a ``ProcessMesh``) and ``ep_axis`` given: expert parallel
      over ``mesh.group(ep_axis)``; ``h`` is this rank's tokens (JAX's
      ``shard_map`` shard over the same axis).
    - ``ep_axis`` alone: JAX's branch "already inside a ``shard_map``"
      has no counterpart in a per-rank process; raises ``ValueError``.
    - neither: one shard, no communication.
    """
    args = (lyr["router"], lyr["w_gate"], lyr["w_up"], lyr["w_down"])
    if ep_axis is None:
        return _moe_ffn_local(h, *args, cfg)
    if mesh is None:
        raise ValueError(
            f"moe_ffn(ep_axis={ep_axis!r}) without a mesh: JAX's in-shard_map form "
            "has no counterpart in a per-rank process; pass the ProcessMesh"
        )
    ep = mesh.shape[ep_axis]
    _check_experts_divisible(cfg.n_experts, ep, ep_axis)
    return _moe_ffn_local(h, *args, cfg, group=mesh.group(ep_axis), ep=ep,
                          rank=mesh.coord(ep_axis))


# ---------------------------------------------------------------------------
# full model: llama backbone + MoE FFN
# ---------------------------------------------------------------------------


def moe_forward(params: dict, cfg: MoEConfig, tokens: torch.Tensor, attn_key: DistAttnRuntimeKey,
                ep_axis: str | None = None):
    """Forward of ``tokens (S,)`` (natural order) on this rank's
    dispatched rows: ``(logits (shard, vocab) float32 in DISPATCHED order,
    aux)``, aux the mean over layers. ``ep_axis`` runs the experts
    expert-parallel over that axis of the key's mesh (``api.get_mesh``):
    the key's cp axis (each rank routes its own rows), or another axis
    (each EP rank routes its block of the global dispatched rows)."""
    dt = cfg.tdtype
    use = gatherer(params, attn_key)
    top = use.top(params)
    x = top["embed"][dispatch(tokens, attn_key).long()].to(dt)
    pos = get_position_ids(attn_key)
    mesh = get_mesh(attn_key) if ep_axis is not None else None
    if mesh is not None and ep_axis not in mesh.axis_names:
        raise ValueError(f"ep_axis {ep_axis!r} is not an axis of the key's mesh {mesh.axis_names}")
    if ep_axis != attn_key.cp_axis and attn_key.cp_size > 1:
        check_cp_group(attn_key)
    s_cp = attn_key.cp_rank

    def ffn(h, lyr):
        if ep_axis == attn_key.cp_axis:
            return moe_ffn(h, lyr, cfg, mesh=mesh, ep_axis=ep_axis)
        s = h.shape[0]
        rows = all_gather(h, attn_key.cp_group)  # the global dispatched rows
        if ep_axis is None:  # route them all, as JAX's layer does
            y, aux = moe_ffn(rows, lyr, cfg)
        else:  # EP rank t routes block t of them, as JAX's shard_map
            ep, group = mesh.shape[ep_axis], mesh.group(ep_axis)
            _check_experts_divisible(cfg.n_experts, ep, ep_axis)
            y, aux = _moe_ffn_local(
                scatter_to_region(rows, group), lyr["router"], lyr["w_gate"], lyr["w_up"],
                lyr["w_down"], cfg, group=group, ep=ep, rank=mesh.coord(ep_axis), replicas=True)
            y = gather_from_region(y, group)
        return y[s_cp * s:(s_cp + 1) * s], aux

    def layer(x, lyr):
        lyr = use.layer(lyr)
        x = attn_block(x, lyr, cfg, pos, attn_key)
        y, aux = ffn(_rms_norm(x, lyr["mlp_norm"], cfg.norm_eps), lyr)
        return x + y, aux

    x, auxes = run_layers(layer, x, params["layers"], cfg.remat)
    aux = torch.stack(auxes).sum() if auxes else torch.zeros((), device=x.device)
    x = _rms_norm(x, top["final_norm"], cfg.norm_eps)
    logits = (x @ top["lm_head"].to(dt)).float()
    return logits, aux / max(cfg.n_layers, 1)


def moe_loss_fn(params, cfg: MoEConfig, tokens, labels, attn_key: DistAttnRuntimeKey,
                ep_axis: str | None = None):
    """Masked cross entropy plus ``aux_loss_coef * aux``. At cp > 1 this
    rank's share: the CE share (``llama.ce_share``) plus
    ``aux_loss_coef * aux / cp`` (``aux`` is the same on every rank), so
    the ranks' losses add up to JAX's global loss."""
    check_cp_group(attn_key)
    logits, aux = moe_forward(params, cfg, tokens, attn_key, ep_axis)
    ce = ce_share(logits, dispatch(labels, attn_key), attn_key)
    return ce + cfg.aux_loss_coef * aux / attn_key.cp_size


def moe_value_and_grad(params, cfg: MoEConfig, tokens, labels, attn_key: DistAttnRuntimeKey,
                       ep_axis: str | None = None):
    """(loss, grads in ``LAYOUT.leaves`` order). At cp > 1 one flat
    ``all_reduce`` sums the loss shares and the gradients of the leaves
    not split over the cp axis (``llama.tree_value_and_grad``)."""
    return tree_value_and_grad(
        lambda live: moe_loss_fn(live, cfg, tokens, labels, attn_key, ep_axis),
        params, LAYOUT, attn_key,
    )


def moe_train_step(params, cfg: MoEConfig, tokens, labels, attn_key: DistAttnRuntimeKey,
                   ep_axis: str | None = None, lr: float = 1e-4):
    """One SGD step ``p -= lr * g``, in place. Returns (params, loss)."""
    loss, grads = moe_value_and_grad(params, cfg, tokens, labels, attn_key, ep_axis)
    sgd_(LAYOUT.leaves(params), grads, lr)
    return params, loss


# ---------------------------------------------------------------------------
# dense reference (testing): per-token full expert sum, no capacity drops
# ---------------------------------------------------------------------------


def moe_ffn_reference(h, lyr, cfg: MoEConfig):
    """O(S*E) dense reference of the MoE FFN: every token visits its top-k
    experts directly (no capacity, no drops). Ground truth for the routed
    implementation wherever no slot overflows (JAX ``moe_ffn_reference``)."""
    logits = h.float() @ lyr["router"]
    topv, topi = _top_k(logits, cfg.top_k)
    gates = torch.softmax(topv, dim=-1)  # (S, K)
    dt = h.dtype

    def expert(e, x):
        g = F.silu(x @ lyr["w_gate"][e].to(dt))
        u = x @ lyr["w_up"][e].to(dt)
        return (g * u) @ lyr["w_down"][e].to(dt)

    all_out = torch.stack([expert(e, h) for e in range(cfg.n_experts)], dim=1)  # (S, E, dim)
    sel = torch.gather(all_out, 1, topi[:, :, None].expand(-1, -1, h.shape[1]))  # (S, K, dim)
    return (sel * gates[:, :, None].to(dt)).sum(dim=1)


__all__ = [
    "MoEConfig",
    "init_moe_params",
    "moe_ffn",
    "moe_ffn_reference",
    "moe_forward",
    "moe_loss_fn",
    "moe_params_from_numpy",
    "moe_train_step",
    "moe_value_and_grad",
    "shard_moe_params",
]
