"""The port's Llama trainer at cp > 1 over gloo against the JAX package at
the same cp, and its cp = 1 step free of collectives.

At the shapes of the JAX package's ``tests/test_models/test_llama.py``
(vocab 128, dim 64, 2 layers, 4/2 heads, head_dim 16, ffn 128, 128 tokens
in two causal documents, chunk 16, float32), with the weights of JAX
``init_params`` carried over by ``params_from_numpy``. For cp 2 and 4 one
process per rank (spawned, a file-store ``init_method``) runs the port's
``value_and_grad``: each rank's loss is its share of the global mean (its
rows' NLL over the global count of valid labels, one ``all_reduce``), and
one flat ``all_reduce`` adds the losses and the parameter gradients over
the group. The JAX package runs ``jax.value_and_grad(loss_fn)`` on a
cp-device CPU mesh with its ``sdpa`` backend. Held on every rank: the loss
and every parameter gradient within float32 1e-5 of JAX's, and exactly two
``all_reduce`` calls. At cp 1 the step issues none.
"""

import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu.api import magi_attn_flex_key
from magiattention_tpu.models import llama as jax_llama
from magiattention_tpu_torch import api as port_api
from magiattention_tpu_torch.models import llama
from magiattention_tpu_torch.testing import assert_close
from tests.torch_port_cases import (
    LLAMA_CP_CFG,
    LLAMA_CP_CHUNK,
    LLAMA_CP_SEQ,
    llama_cp_data,
    llama_cp_worker,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
S = LLAMA_CP_SEQ
RANGES = [[0, S // 2], [S // 2, S]]


def _leaves(tree) -> list[np.ndarray]:
    """The JAX pytree's arrays in the port's param_list order."""
    out = [tree["embed"], tree["final_norm"], tree["lm_head"]]
    for lyr in tree["layers"]:
        out += [lyr[k] for k in llama._LAYER_KEYS]
    return [np.asarray(a) for a in out]


@lru_cache(maxsize=None)
def _jax_params():
    return jax_llama.init_params(jax_llama.LlamaConfig(**LLAMA_CP_CFG), jax.random.key(0))


@lru_cache(maxsize=None)
def _jax_run(cp: int):
    cfg = jax_llama.LlamaConfig(**LLAMA_CP_CFG)
    mesh = Mesh(np.array(jax.devices("cpu")[:cp]), axis_names=("cp",))
    key = magi_attn_flex_key(RANGES, RANGES, [1, 1], S, S, mesh=mesh, chunk_size=LLAMA_CP_CHUNK)
    tokens, labels = (jnp.asarray(a) for a in llama_cp_data())
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa")
        vg = jax.jit(jax.value_and_grad(jax_llama.loss_fn), static_argnums=(1, 4))
        loss, grads = vg(_jax_params(), cfg, tokens, labels, key)
    return float(loss), _leaves(grads)


@lru_cache(maxsize=None)
def _port_run(cp: int) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_llama_cp_")
    tree = jax.tree.map(np.asarray, _jax_params())
    mp.start_processes(llama_cp_worker, args=(cp, os.path.join(out_dir, "init"), out_dir, tree),
                       nprocs=cp, start_method="spawn", join=True)
    return out_dir


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_loss_and_grads_match_jax(cp):
    loss, grads = _jax_run(cp)
    names = llama.param_names(llama.params_from_numpy(jax.tree.map(np.asarray, _jax_params()), "cpu"))
    for r in range(cp):
        got = np.load(os.path.join(_port_run(cp), f"llama_{r}.npz"))
        assert int(got["all_reduce_calls"]) == 2  # the label count, the flat sum
        np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
        for i, (name, want) in enumerate(zip(names, grads)):
            assert_close(got[f"g{i}"], want, msg=f"cp {cp} rank {r} {name}", **TOL)


def test_cp1_step_issues_no_collective(monkeypatch):
    """A cp = 1 key (no group): value_and_grad and train_step call no
    torch.distributed collective."""
    calls = []
    for name in ("all_reduce", "all_gather", "all_to_all_single", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "broadcast"):
        real = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _n=name, _f=real, **k: (calls.append(_n), _f(*a, **k))[1])
    key = port_api.magi_attn_flex_key(RANGES, RANGES, [1, 1], S, S, device="cpu",
                                      chunk_size=LLAMA_CP_CHUNK)
    params = llama.params_from_numpy(jax.tree.map(np.asarray, _jax_params()), "cpu")
    tokens, labels = (torch.from_numpy(a) for a in llama_cp_data())
    cfg = llama.LlamaConfig(**LLAMA_CP_CFG)
    loss, _ = llama.value_and_grad(params, cfg, tokens, labels, key)
    llama.train_step(params, cfg, tokens, labels, key, lr=1e-2)
    assert calls == []
    np.testing.assert_allclose(float(loss), _jax_run(1)[0], rtol=1e-5)
