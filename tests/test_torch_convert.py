"""The port's HF weight bridge (``models/convert.py``) against the JAX
package's and against HuggingFace's own float32 forward.

Tiny random-init ``transformers`` Llama and Mixtral models are built here
(no download), as the JAX package's ``tests/test_models/test_convert_hf.py``
builds them. Held: the port's converted parameters equal to the bit to
JAX ``params_from_hf_state_dict`` / ``moe_params_from_hf_state_dict`` on
the same state dict; the port's dense twin and its CP path at cp 1
(``magi_attn_flex_key`` on the CPU, the kernels' plain versions) against
the HF model's logits (float32, 1e-4); the converted Mixtral at capacity
factor 8 (no drop: HF routes every token) through ``moe_forward`` at cp 1
against HF (1e-4); and ``models.convert`` importing no ``transformers``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magiattention_tpu.models import convert as jax_convert
from magiattention_tpu_torch import api
from magiattention_tpu_torch.models import convert, llama, moe
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

transformers = pytest.importorskip("transformers")

S = 96
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
             rms_norm_eps=1e-5, rope_theta=10000.0, attn_implementation="eager")


def _model(kind: str, seed: int):
    torch.manual_seed(seed)
    if kind == "llama":
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**SMALL))
    else:
        hf = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            **SMALL, num_local_experts=8, num_experts_per_tok=2))
    return hf.eval()


@pytest.fixture(scope="module")
def hf_llama():
    return _model("llama", 0)


@pytest.fixture(scope="module")
def hf_mixtral():
    return _model("mixtral", 1)


def _hf_logits(hf, tokens: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return hf(torch.from_numpy(tokens.astype(np.int64))[None]).logits[0].numpy()


def _tokens(seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, S).astype(np.int64)


def _cp1_key():
    return api.magi_attn_flex_key([[0, S]], [[0, S]], [1], S, S, device="cpu", chunk_size=8)


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_converted_params_equal_jax(kind, hf_llama, hf_mixtral):
    hf = hf_llama if kind == "llama" else hf_mixtral
    sd_np = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    if kind == "llama":
        cfg, params = convert.load_hf_llama(hf, dtype="float32", device="cpu")
        ref = jax_convert.params_from_hf_state_dict(sd_np, jax_convert.config_from_hf(hf.config))
        layout = llama.LAYOUT
    else:
        cfg, params = convert.load_hf_mixtral(hf, dtype="float32", device="cpu")
        ref = jax_convert.moe_params_from_hf_state_dict(
            sd_np, jax_convert.moe_config_from_hf(hf.config))
        layout = moe.LAYOUT
        assert (cfg.n_experts, cfg.top_k) == (8, 2)
    assert (cfg.dim, cfg.ffn_hidden, cfg.n_layers, cfg.head_dim) == (64, 96, 2, 16)
    for name, a, b in zip(layout.names(params), layout.leaves(params), layout.leaves(ref)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # a numpy state dict converts to the same tensors
    again = (convert.params_from_hf_state_dict if kind == "llama"
             else convert.moe_params_from_hf_state_dict)(sd_np, cfg, "cpu")
    for a, b in zip(layout.leaves(params), layout.leaves(again)):
        assert torch.equal(a, b)


def test_llama_logits_match_hf(hf_llama):
    cfg, params = convert.load_hf_llama(hf_llama, dtype="float32", device="cpu")
    tokens = _tokens(0, cfg.vocab_size)
    ref = _hf_logits(hf_llama, tokens)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool))
    dense = llama.forward_dense(params, cfg, torch.from_numpy(tokens), mask)
    np.testing.assert_allclose(dense.numpy(), ref, atol=1e-4, rtol=1e-4)
    key = _cp1_key()
    cp = api.undispatch(llama.forward(params, cfg, torch.from_numpy(tokens), key), key)
    np.testing.assert_allclose(cp.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_mixtral_at_capacity_8_matches_hf(hf_mixtral):
    cfg, params = convert.load_hf_mixtral(hf_mixtral, dtype="float32", capacity_factor=8.0,
                                          device="cpu")
    tokens = _tokens(2, cfg.vocab_size)
    key = _cp1_key()
    logits, aux = moe.moe_forward(params, cfg, torch.from_numpy(tokens), key)
    np.testing.assert_allclose(api.undispatch(logits, key).numpy(), _hf_logits(hf_mixtral, tokens),
                               atol=1e-4, rtol=1e-4)
    assert np.isfinite(aux.item())


def test_convert_imports_no_transformers():
    code = ("import sys, magiattention_tpu_torch.models.convert; "
            "print(any(m.split('.')[0] == 'transformers' for m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
