"""HuggingFace -> magiattention_tpu_torch weight conversion.

The port's counterpart of ``magiattention_tpu/models/convert.py``: maps a
HF ``LlamaForCausalLM`` state dict onto :mod:`.llama`'s parameter dict,
and a ``MixtralForCausalLM`` one onto :mod:`.moe`'s, as float32 tensors.
It works on the state dict's tensors directly and never imports
``transformers``: a live model is only asked for ``.state_dict()`` and
``.config``.

Layout notes (HF stores ``nn.Linear`` weight as (out, in); ours are
(in, out) matmul-ready, so every projection transposes):

- ``model.embed_tokens.weight (vocab, dim)`` -> ``embed`` (as-is)
- ``layers.N.self_attn.{q,k,v,o}_proj.weight`` -> ``wq/wk/wv/wo`` (T)
- ``layers.N.input_layernorm.weight`` -> ``attn_norm``
- ``layers.N.post_attention_layernorm.weight`` -> ``mlp_norm``
- ``layers.N.mlp.{gate,up,down}_proj.weight`` -> ``w_gate/w_up/w_down`` (T)
- ``model.norm.weight`` -> ``final_norm``; ``lm_head.weight`` -> ``lm_head`` (T)
- Mixtral: ``block_sparse_moe.gate`` -> ``router`` (T);
  ``experts.N.{w1,w3,w2}`` -> ``w_gate/w_up/w_down`` stacked on the expert
  dim (each T)

The rotary convention matches (both rotate first-half/second-half pairs),
so no permutation of q/k rows is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import resolve_device
from .llama import LlamaConfig
from .moe import MoEConfig


def config_from_hf(hf_config, dtype: str = "bfloat16") -> LlamaConfig:
    """LlamaConfig from a HF ``LlamaConfig``. ``dtype`` is the activation
    compute dtype (pass "float32" for close parity checks against a
    float32 torch forward)."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads
    )
    return LlamaConfig(
        dtype=dtype,
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        head_dim=head_dim,
        ffn_hidden=hf_config.intermediate_size,
        rope_theta=float(hf_config.rope_theta),
        norm_eps=float(hf_config.rms_norm_eps),
    )


def _tensors(sd: dict, device) -> Callable:
    """``t(key)``: the state dict's entry (a tensor or an array) as a
    float32 tensor on ``device``."""

    def t(key):
        return torch.as_tensor(sd[key]).detach().to(device=device, dtype=torch.float32)

    return t


def _attn_layer_entries(t, p: str) -> dict:
    """The backbone (attention + norms) per-layer mapping, shared by the
    Llama and Mixtral converters so a mapping fix reaches both."""
    return {
        "attn_norm": t(p + "input_layernorm.weight"),
        "wq": t(p + "self_attn.q_proj.weight").T.contiguous(),
        "wk": t(p + "self_attn.k_proj.weight").T.contiguous(),
        "wv": t(p + "self_attn.v_proj.weight").T.contiguous(),
        "wo": t(p + "self_attn.o_proj.weight").T.contiguous(),
        "mlp_norm": t(p + "post_attention_layernorm.weight"),
    }


def _top_level_entries(sd: dict, t, layers: list) -> dict:
    """embed/final_norm/lm_head (tied-weight fallback) + layers."""
    head = "lm_head.weight" if "lm_head.weight" in sd else "model.embed_tokens.weight"
    return {
        "embed": t("model.embed_tokens.weight"),
        "final_norm": t("model.norm.weight"),
        "lm_head": t(head).T.contiguous(),
        "layers": layers,
    }


def params_from_hf_state_dict(sd: dict, cfg: LlamaConfig,
                              device: torch.device | str | None = None) -> dict:
    """HF LlamaForCausalLM state dict (tensors or arrays) -> the port's
    Llama parameters on ``device`` (None = the card). ``lm_head.weight``
    falls back to the embedding (tied weights) when absent."""
    t = _tensors(sd, resolve_device(device))
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layers.append({
            **_attn_layer_entries(t, p),
            "w_gate": t(p + "mlp.gate_proj.weight").T.contiguous(),
            "w_up": t(p + "mlp.up_proj.weight").T.contiguous(),
            "w_down": t(p + "mlp.down_proj.weight").T.contiguous(),
        })
    return _top_level_entries(sd, t, layers)


def load_hf_llama(model, dtype: str = "bfloat16",
                  device: torch.device | str | None = None) -> tuple[LlamaConfig, dict]:
    """(cfg, params) from a live HF ``LlamaForCausalLM`` instance."""
    cfg = config_from_hf(model.config, dtype=dtype)
    return cfg, params_from_hf_state_dict(model.state_dict(), cfg, device)


# ---------------------------------------------------------------------------
# Mixtral -> MoE family
# ---------------------------------------------------------------------------


def moe_config_from_hf(hf_config, dtype: str = "bfloat16",
                       capacity_factor: float = 1.25) -> MoEConfig:
    """MoEConfig from a HF ``MixtralConfig`` (gating matches: softmax over
    the selected top-k router logits). Backbone fields come through
    :func:`config_from_hf` so a new base-field mapping reaches both
    families."""
    base = dataclasses.asdict(config_from_hf(hf_config, dtype=dtype))
    return MoEConfig(
        **base,
        n_experts=hf_config.num_local_experts,
        top_k=hf_config.num_experts_per_tok,
        capacity_factor=capacity_factor,
    )


def moe_params_from_hf_state_dict(sd: dict, cfg: MoEConfig,
                                  device: torch.device | str | None = None) -> dict:
    """HF MixtralForCausalLM state dict -> the port's MoE parameters on
    ``device`` (None = the card). Mixtral naming:
    ``block_sparse_moe.gate`` -> router; experts.N.{w1,w3,w2} ->
    w_gate/w_up/w_down (stacked on the expert dim, transposed to (in,
    out))."""
    t = _tensors(sd, resolve_device(device))

    def stack(m, name):
        return torch.stack([t(m + f"experts.{e}.{name}.weight").T for e in range(cfg.n_experts)])

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        m = p + "block_sparse_moe."
        layers.append({
            **_attn_layer_entries(t, p),
            "router": t(m + "gate.weight").T.contiguous(),
            "w_gate": stack(m, "w1"),
            "w_up": stack(m, "w3"),
            "w_down": stack(m, "w2"),
        })
    return _top_level_entries(sd, t, layers)


def load_hf_mixtral(model, dtype: str = "bfloat16", capacity_factor: float = 1.25,
                    device: torch.device | str | None = None) -> tuple[MoEConfig, dict]:
    """(cfg, params) from a live HF ``MixtralForCausalLM``. For exact
    parity checks against the torch forward use a LARGE capacity_factor
    (HF routes every token to its top-k experts with no capacity drops)."""
    cfg = moe_config_from_hf(model.config, dtype=dtype, capacity_factor=capacity_factor)
    return cfg, moe_params_from_hf_state_dict(model.state_dict(), cfg, device)
