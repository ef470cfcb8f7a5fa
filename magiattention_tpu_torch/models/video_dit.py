"""Video DiT: a diffusion-transformer model family on spatiotemporal CP.

The port's counterpart of ``magiattention_tpu/models/video_dit.py``, the
Magi-1-style workload (an autoregressive video diffusion transformer
trained with MagiAttention's block-causal video mask): AdaLN conditioning
on the diffusion timestep, a flow-matching objective, and attention
through ``magi_attn_flex_key -> dispatch -> calc_attn`` over the
spatiotemporal block mask (frames causal, each frame attending the last
``window_frames`` frames; ``utils.sparse_utils.make_video_block_mask``).

Layout as ``models/llama.py``: packed tokens (no batch dim), every
non-attention op row-wise or a matrix product, so the network runs on
this rank's dispatched rows; the factorized (frame, spatial) position
embeddings are gathered at the dispatched global positions. The latents
are dispatched before the input projection, so every parameter's
gradient on a rank is its rows' share. At cp > 1 the loss is the share of
JAX's global mean: the rank's squared-error sum over ``seqlen * in_dim``,
and ``value_and_grad``'s one flat ``all_reduce`` sums loss and gradients.
Projection weights reuse llama's names, so ``llama.shard_params``
(ZeRO-3, Megatron TP) applies unchanged, as in JAX (re-exported here):
the AdaLN, patch-embedding and output leaves follow its ZeRO-3 rule, and
the forward gathers through llama's helper (``models/shard.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..api import calc_attn, dispatch, get_position_ids, magi_attn_flex_key
from ..device import resolve_device
from ..dist_attn_runtime_mgr import DistAttnRuntimeKey
from ..utils.sparse_utils import (
    block_mask_to_dense_mask,
    block_mask_to_ranges,
    make_video_block_mask,
)
from ..comm.functional import copy_to_region, reduce_from_region
from .llama import (  # noqa: F401  (shard_params re-exported, as in JAX)
    Layout,
    _rms_norm,
    check_cp_group,
    dense_attn,
    optimizer_step_,
    run_layers,
    shard_params,
    tree_value_and_grad,
)
from .shard import gatherer, tp_region

LAYOUT = Layout(
    ("w_in", "frame_emb", "spatial_emb", "w_t1", "w_t2", "final_norm", "w_out"),
    ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down", "w_mod",
     "b_mod"),
)


@dataclass(frozen=True)
class VideoDiTConfig:
    num_frames: int = 8
    tokens_per_frame: int = 256
    in_dim: int = 16  # latent channels per token
    dim: int = 384
    n_layers: int = 4
    n_heads: int = 6
    n_kv_heads: int = 6
    head_dim: int = 64
    ffn_hidden: int = 1024
    window_frames: int = 2  # each frame sees this many trailing frames
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = False

    @property
    def seqlen(self) -> int:
        return self.num_frames * self.tokens_per_frame

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def video_mask_ranges(cfg: VideoDiTConfig):
    """(q_ranges, k_ranges, attn_type_map, block_mask) of the Magi-1-style
    spatiotemporal mask at frame-block granularity."""
    bm = make_video_block_mask(cfg.num_frames, 1, cfg.window_frames)
    qr, kr, tm = block_mask_to_ranges(bm, cfg.tokens_per_frame, cfg.tokens_per_frame)
    return (
        [[r.start, r.end] for r in qr],
        [[r.start, r.end] for r in kr],
        [t.to_int_type() for t in tm],
        bm,
    )


def make_video_attn_key(
    cfg: VideoDiTConfig,
    mesh=None,
    cp_axis: str = "cp",
    chunk_size: int | None = None,
    dist_attn_config=None,
    *,
    cp_group=None,
    device: torch.device | str | None = None,
) -> DistAttnRuntimeKey:
    """The runtime key of the video mask, over ``cp_group`` or a
    ``ProcessMesh`` and its ``cp_axis`` as ``magi_attn_flex_key`` takes
    them (neither: cp 1); chunks of half a frame unless given."""
    qr, kr, tm, _ = video_mask_ranges(cfg)
    kwargs = {}
    if dist_attn_config is not None:
        kwargs["dist_attn_config"] = dist_attn_config
    if mesh is not None:
        kwargs.update(mesh=mesh, cp_axis=cp_axis)
    return magi_attn_flex_key(
        qr, kr, tm, cfg.seqlen, cfg.seqlen, cp_group=cp_group, device=device,
        chunk_size=chunk_size or cfg.tokens_per_frame // 2, **kwargs,
    )


def dense_video_mask(cfg: VideoDiTConfig) -> np.ndarray:
    """Token-level boolean oracle for the dense twin."""
    _, _, _, bm = video_mask_ranges(cfg)
    return block_mask_to_dense_mask(bm, cfg.tokens_per_frame, cfg.tokens_per_frame)


def init_params(
    cfg: VideoDiTConfig, seed: int = 0, device: torch.device | str | None = None
) -> dict:
    """Random-init parameters (float32 master weights) from ``seed`` on
    ``device`` (None = the card), with JAX's scales: N(0, 1) /
    sqrt(fan_in) for the projections, 0.02 for the position embeddings,
    1e-3 for the AdaLN modulation and the output projection (small, not
    DiT's exact zeros, so gradients reach the body from step 0), zero
    modulation biases. Tests carry JAX's weights over with
    :func:`params_from_numpy`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dim, dh = cfg.dim, cfg.head_dim
    hq, hk = cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale=None):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(scale if scale is not None else shape[0] ** -0.5)

    def ones(n):
        return torch.ones((n,), device=device, dtype=torch.float32)

    layers = [
        {
            "attn_norm": ones(dim),
            "wq": dense((dim, hq * dh)),
            "wk": dense((dim, hk * dh)),
            "wv": dense((dim, hk * dh)),
            "wo": dense((hq * dh, dim)),
            "mlp_norm": ones(dim),
            "w_gate": dense((dim, cfg.ffn_hidden)),
            "w_up": dense((dim, cfg.ffn_hidden)),
            "w_down": dense((cfg.ffn_hidden, dim)),
            # AdaLN modulation: cond -> (shift, scale, gate) x (attn, mlp)
            "w_mod": dense((dim, 6 * dim), scale=1e-3),
            "b_mod": torch.zeros((6 * dim,), device=device, dtype=torch.float32),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "w_in": dense((cfg.in_dim, dim)),
        "frame_emb": dense((cfg.num_frames, dim), scale=0.02),
        "spatial_emb": dense((cfg.tokens_per_frame, dim), scale=0.02),
        # timestep conditioning MLP (sinusoidal -> dim -> dim)
        "w_t1": dense((dim, dim)),
        "w_t2": dense((dim, dim)),
        "final_norm": ones(dim),
        "w_out": dense((dim, cfg.in_dim), scale=1e-3),
        "layers": layers,
    }


def params_from_numpy(tree: dict, device: torch.device | str | None = None) -> dict:
    """The JAX package's DiT pytree, as numpy arrays, as the port's float32
    parameters on ``device`` (None = the card)."""
    return LAYOUT.from_numpy(tree, device)


def param_list(params: dict) -> list[torch.Tensor]:
    """The parameters in :data:`LAYOUT` order (the gradients' order, the
    optimizer's list)."""
    return LAYOUT.leaves(params)


def param_names(params: dict) -> list[str]:
    """Names matching :func:`param_list`."""
    return LAYOUT.names(params)


def _timestep_embedding(t, dim: int, device) -> torch.Tensor:
    """Sinusoidal embedding of the diffusion time ``t`` in [0, 1]."""
    half = dim // 2
    freqs = torch.exp(
        -np.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device) / half
    )
    ang = torch.as_tensor(t, dtype=torch.float32, device=device) * 1000.0 * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)])


def _modulate(h, mod, dt):
    shift, scale, gate = mod
    return h * (1.0 + scale.to(dt)) + shift.to(dt), gate


def _cond(params: dict, cfg: VideoDiTConfig, t, device) -> torch.Tensor:
    """The timestep conditioning ``(dim,)`` float32."""
    cond = _timestep_embedding(t, cfg.dim, device)
    cond = F.silu(cond @ params["w_t1"])
    return F.silu(cond @ params["w_t2"])


def _block(x, lyr, cfg: VideoDiTConfig, cond, attend):
    """One AdaLN transformer block; ``attend(q, k, v)`` is the attention.
    Under Megatron TP the projections are this rank's blocks, as in
    llama's ``attn_block`` and ``_mlp``."""
    dt = x.dtype
    group = tp_region(lyr)
    mods = (cond @ lyr["w_mod"] + lyr["b_mod"]).reshape(6, cfg.dim)
    h = _rms_norm(x, lyr["attn_norm"], cfg.norm_eps)
    h, gate_a = _modulate(h, mods[0:3], dt)
    h = copy_to_region(h, group)
    q = (h @ lyr["wq"].to(dt)).unflatten(-1, (-1, cfg.head_dim))
    k = (h @ lyr["wk"].to(dt)).unflatten(-1, (-1, cfg.head_dim))
    v = (h @ lyr["wv"].to(dt)).unflatten(-1, (-1, cfg.head_dim))
    attn_out = attend(q, k, v).flatten(1)
    x = x + gate_a.to(dt) * reduce_from_region(attn_out @ lyr["wo"].to(dt), group)

    h = _rms_norm(x, lyr["mlp_norm"], cfg.norm_eps)
    h, gate_m = _modulate(h, mods[3:6], dt)
    h = copy_to_region(h, group)
    up = F.silu(h @ lyr["w_gate"].to(dt)) * (h @ lyr["w_up"].to(dt))
    return x + gate_m.to(dt) * reduce_from_region(up @ lyr["w_down"].to(dt), group)


def _embed(params, cfg: VideoDiTConfig, latents, pos):
    dt = cfg.tdtype
    x = latents.to(dt) @ params["w_in"].to(dt)
    frame = pos // cfg.tokens_per_frame
    sp = pos % cfg.tokens_per_frame
    return x + (params["frame_emb"][frame] + params["spatial_emb"][sp]).to(dt)


def forward(params: dict, cfg: VideoDiTConfig, latents: torch.Tensor, t,
            attn_key: DistAttnRuntimeKey) -> torch.Tensor:
    """Velocity prediction of ``latents (seqlen, in_dim)`` (noisy,
    natural order) at diffusion time ``t`` (a scalar in [0, 1]): this
    rank's ``(shard, in_dim)`` float32 in DISPATCHED order (the loss
    dispatches the target instead of undispatching the prediction)."""
    use = gatherer(params, attn_key)
    top = use.top(params)
    pos = get_position_ids(attn_key)
    x = _embed(top, cfg, dispatch(latents, attn_key), pos)
    cond = _cond(top, cfg, t, x.device)

    def attend(q, k, v):
        return calc_attn(q, k, v, attn_key)[0]

    def layer(x, lyr):
        return _block(x, use.layer(lyr), cfg, cond, attend)

    x, _ = run_layers(layer, x, params["layers"], cfg.remat)
    x = _rms_norm(x, top["final_norm"], cfg.norm_eps)
    return x.float() @ top["w_out"]


def _flow(clean, noise, t):
    """(x_t, v): x_t = (1 - t) x0 + t eps, target v = eps - x0."""
    return (1.0 - t) * clean + t * noise, (noise - clean).float()


def loss_fn(params: dict, cfg: VideoDiTConfig, clean, noise, t,
            attn_key: DistAttnRuntimeKey) -> torch.Tensor:
    """Flow-matching MSE (JAX ``loss_fn``), the target dispatched with the
    prediction's permutation. At cp > 1 this rank's share of the global
    mean: its squared-error sum over ``seqlen * in_dim``."""
    check_cp_group(attn_key)
    xt, target = _flow(clean, noise, t)
    pred = forward(params, cfg, xt, t, attn_key)
    err = pred - dispatch(target, attn_key)
    return (err * err).sum() / (cfg.seqlen * cfg.in_dim)


def value_and_grad(params, cfg: VideoDiTConfig, clean, noise, t, attn_key: DistAttnRuntimeKey):
    """(loss, grads in :func:`param_list` order); at cp > 1 summed over
    the key's cp group by one flat ``all_reduce``."""
    return tree_value_and_grad(
        lambda live: loss_fn(live, cfg, clean, noise, t, attn_key), params, LAYOUT, attn_key
    )


# ---------------------------------------------------------------------------
# dense (non-CP) twin and the optimizer steps, as in JAX
# ---------------------------------------------------------------------------


def forward_dense(params: dict, cfg: VideoDiTConfig, latents: torch.Tensor, t,
                  mask: torch.Tensor) -> torch.Tensor:
    """Same network, replicated dense float32 attention over a boolean
    ``mask (seqlen, seqlen)`` (JAX ``forward_dense``). Natural order."""
    pos = torch.arange(latents.shape[0], device=latents.device)
    x = _embed(params, cfg, latents, pos)
    cond = _cond(params, cfg, t, x.device)

    def attend(q, k, v):
        return dense_attn(q, k, v, mask, cfg.head_dim)

    for lyr in params["layers"]:
        x = _block(x, lyr, cfg, cond, attend)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["w_out"]


def loss_fn_dense(params, cfg: VideoDiTConfig, clean, noise, t, mask):
    """Flow-matching MSE of :func:`forward_dense` (JAX ``loss_fn_dense``)."""
    xt, target = _flow(clean, noise, t)
    return ((forward_dense(params, cfg, xt, t, mask) - target) ** 2).mean()


def make_optim_train_step(cfg: VideoDiTConfig, attn_key: DistAttnRuntimeKey, optimizer):
    """The optimizer step of the CP model (JAX ``make_optax_train_step``):
    ``optimizer`` is a ``torch.optim.Optimizer`` over
    ``param_list(params)``; ``step(params, clean, noise, t)`` writes the
    gradients of :func:`value_and_grad` into ``.grad``, calls
    ``optimizer.step()`` and returns ``(params, loss)``."""

    def step(params, clean, noise, t):
        loss, grads = value_and_grad(params, cfg, clean, noise, t, attn_key)
        optimizer_step_(optimizer, param_list(params), grads)
        return params, loss

    return step


def make_optim_train_step_dense(cfg: VideoDiTConfig, mask: torch.Tensor, optimizer):
    """The dense twin of :func:`make_optim_train_step` (JAX
    ``make_optax_train_step_dense``)."""

    def step(params, clean, noise, t):
        loss, grads = tree_value_and_grad(
            lambda live: loss_fn_dense(live, cfg, clean, noise, t, mask), params, LAYOUT
        )
        optimizer_step_(optimizer, param_list(params), grads)
        return params, loss

    return step
