"""The port's video DiT (``models/video_dit.py``) against the JAX
package's on the same numpy inputs, at the config of JAX's
``tests/test_models/test_video_dit.py`` (4 frames x 64 tokens, in_dim 8,
dim 64, 2 heads / 1 kv head of 32, ffn 128, window 2, float32, t 0.3),
with the weights of JAX ``init_params`` carried over by
``params_from_numpy``.

- The mask ranges, block mask and dense mask equal JAX's
  ``video_mask_ranges`` / ``dense_video_mask``.
- Loss and every gradient of ``value_and_grad`` at cp 1 (in process) and
  cp 2 (a gloo world, ``tests/torch_port_cases.py:dit_worker``) against
  ``jax.value_and_grad(loss_fn)`` at the same cp on a CPU mesh with
  JAX's ``sdpa`` backend: loss rel 1e-5, gradients float32 1e-5 (the
  absolute part of max(1, the largest |gradient|)); ``remat`` within 1e-6
  of no remat at both.
- The dense twin (``loss_fn_dense``) against JAX's, the same tolerances.
- Three AdamW steps through ``make_optim_train_step`` (``torch.optim.AdamW``)
  against JAX ``make_optax_train_step`` with ``optax.adamw`` at the same
  hyperparameters (lr 1e-3, betas 0.9 / 0.999, eps 1e-8, weight decay
  1e-4 set on both, since the defaults differ): losses rel 1e-5,
  parameters elementwise within 1e-5 and rel-norm 1e-4 (Adam divides a
  near-zero gradient, the modulation biases', by its own scale, so its
  float32 rounding moves those steps by ~1e-5 of their size); the dense
  twin's step equal to the CP step within the same.
"""

import dataclasses
import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu.models import video_dit as jax_dit
from magiattention_tpu_torch.models import video_dit
from magiattention_tpu_torch.testing import assert_close
from tests.torch_port_cases import DIT_CFG, DIT_T, dit_data, dit_worker

JCFG = jax_dit.VideoDiTConfig(**DIT_CFG)
PCFG = video_dit.VideoDiTConfig(**DIT_CFG)
SDPA = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
STEP_TS = (0.1, 0.35, 0.6)


def _tol(want) -> dict:
    """float32 1e-5, the absolute part relative to the array's scale."""
    return dict(atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=1e-5, norm_rtol=1e-5)


@lru_cache(maxsize=None)
def _jax_params():
    return jax_dit.init_params(JCFG, jax.random.PRNGKey(0))


@lru_cache(maxsize=None)
def _tree():
    return jax.tree.map(np.asarray, _jax_params())


def _leaves(tree) -> list[np.ndarray]:
    return [np.asarray(a) for a in video_dit.LAYOUT.leaves(tree)]


def _jax_key(cp: int):
    mesh = Mesh(np.array(jax.devices("cpu")[:cp]), axis_names=("cp",))
    return jax_dit.make_video_attn_key(JCFG, mesh, "cp")


def _sdpa(fn):
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in SDPA.items():
            mpatch.setenv(k, v)
        return fn()


@lru_cache(maxsize=None)
def _jax_vg(cp: int):
    clean, noise = (jnp.asarray(a) for a in dit_data())
    vg = jax.jit(jax.value_and_grad(jax_dit.loss_fn), static_argnums=(1, 5))
    loss, grads = _sdpa(lambda: vg(_jax_params(), JCFG, clean, noise, jnp.float32(DIT_T),
                                   _jax_key(cp)))
    return float(loss), _leaves(jax.tree.map(np.asarray, grads))


def _check(tag: str, loss, grads, want_loss, want_grads) -> None:
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for name, g, w in zip(video_dit.LAYOUT.names(_tree()), grads, want_grads):
        assert_close(g, w, msg=f"{tag} {name}", **_tol(w))


def test_mask_matches_jax():
    port, ref = video_dit.video_mask_ranges(PCFG), jax_dit.video_mask_ranges(JCFG)
    assert port[:3] == ref[:3]
    np.testing.assert_array_equal(port[3], ref[3])
    np.testing.assert_array_equal(video_dit.dense_video_mask(PCFG), jax_dit.dense_video_mask(JCFG))


def test_loss_and_grads_match_jax_at_cp1():
    key = video_dit.make_video_attn_key(PCFG, device="cpu")
    params = video_dit.params_from_numpy(_tree(), "cpu")
    clean, noise = (torch.from_numpy(a) for a in dit_data())
    loss, grads = video_dit.value_and_grad(params, PCFG, clean, noise, DIT_T, key)
    _check("cp 1", loss, grads, *_jax_vg(1))
    assert float(np.linalg.norm(grads[video_dit.LAYOUT.names(params).index("layers.0.wq")])) > 0
    loss_r, grads_r = video_dit.value_and_grad(params, dataclasses.replace(PCFG, remat=True), clean,
                                               noise, DIT_T, key)
    np.testing.assert_allclose(float(loss_r), float(loss), rtol=1e-6)
    for g, g_r in zip(grads, grads_r):
        np.testing.assert_allclose(g_r.numpy(), g.numpy(), rtol=1e-6, atol=1e-6)


@lru_cache(maxsize=None)
def _port_run(cp: int) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_dit_")
    mp.start_processes(dit_worker, args=(cp, os.path.join(out_dir, "init"), out_dir, _tree()),
                       nprocs=cp, start_method="spawn", join=True)
    return out_dir


def test_loss_and_grads_match_jax_at_cp2():
    loss, grads = _jax_vg(2)
    n = len(grads)
    for r in range(2):
        got = np.load(os.path.join(_port_run(2), f"dit_{r}.npz"))
        _check(f"cp 2 rank {r}", got["loss"], [got[f"g{i}"] for i in range(n)], loss, grads)
        np.testing.assert_allclose(got["remat_loss"], got["loss"], rtol=1e-6)
        for i in range(n):
            np.testing.assert_allclose(got[f"remat_g{i}"], got[f"g{i}"], rtol=1e-6, atol=1e-6)


def test_dense_twin_matches_jax():
    clean, noise = dit_data()
    mask = jax_dit.dense_video_mask(JCFG)
    loss, grads = jax.jit(jax.value_and_grad(jax_dit.loss_fn_dense), static_argnums=(1,))(
        _jax_params(), JCFG, jnp.asarray(clean), jnp.asarray(noise), jnp.float32(DIT_T),
        jnp.asarray(mask))
    params = video_dit.params_from_numpy(_tree(), "cpu")
    tmask = torch.from_numpy(video_dit.dense_video_mask(PCFG))
    args = (torch.from_numpy(clean), torch.from_numpy(noise), DIT_T, tmask)
    from magiattention_tpu_torch.models.llama import tree_value_and_grad

    loss_p, grads_p = tree_value_and_grad(
        lambda live: video_dit.loss_fn_dense(live, PCFG, *args), params, video_dit.LAYOUT)
    _check("dense", loss_p, grads_p, float(loss), _leaves(jax.tree.map(np.asarray, grads)))


def test_adamw_steps_match_optax():
    clean, noise = dit_data()
    opt = optax.adamw(ADAMW["lr"], b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                      weight_decay=ADAMW["weight_decay"])
    step = jax_dit.make_optax_train_step(JCFG, _jax_key(1), opt)
    params = jax.tree.map(jnp.copy, _jax_params())
    state = opt.init(params)
    losses = []
    for t in STEP_TS:
        params, state, loss = _sdpa(lambda: step(params, state, jnp.asarray(clean),
                                                 jnp.asarray(noise), jnp.float32(t)))
        losses.append(float(loss))
    final = _leaves(jax.tree.map(np.asarray, params))

    def run(make, arg):
        p = video_dit.params_from_numpy(_tree(), "cpu")
        optim = torch.optim.AdamW(video_dit.param_list(p), lr=ADAMW["lr"],
                                  betas=(ADAMW["b1"], ADAMW["b2"]), eps=ADAMW["eps"],
                                  weight_decay=ADAMW["weight_decay"])
        step_p = make(PCFG, arg, optim)
        out = []
        for t in STEP_TS:
            p, loss = step_p(p, torch.from_numpy(clean), torch.from_numpy(noise), t)
            out.append(loss.item())
        return out, video_dit.param_list(p)

    got, p_cp = run(video_dit.make_optim_train_step, video_dit.make_video_attn_key(PCFG,
                                                                                    device="cpu"))
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert got[0] != pytest.approx(got[-1], rel=1e-12)
    for name, p, w in zip(video_dit.LAYOUT.names(_tree()), p_cp, final):
        assert_close(p, w, msg=f"adamw {name}", **{**_tol(w), "norm_rtol": 1e-4})
    got_d, p_d = run(video_dit.make_optim_train_step_dense,
                     torch.from_numpy(video_dit.dense_video_mask(PCFG)))
    np.testing.assert_allclose(got_d, got, rtol=1e-5)
    for p, q in zip(p_d, p_cp):
        assert_close(p, q, msg="dense step", **{**_tol(q.numpy()), "norm_rtol": 1e-4})
