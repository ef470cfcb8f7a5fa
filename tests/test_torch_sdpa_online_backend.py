"""The CP runtime's ``sdpa_online`` backend against the JAX package's.

At cp 2 over gloo (one process per rank, a file-store ``init_method``),
the port's ``magi_attn_flex_key -> dispatch -> calc_attn -> undispatch``
under MAGI_ATTENTION_KERNEL_BACKEND=sdpa_online (the blockwise
online-softmax replay of the merged buffers, ``kernels/sdpa_online.py``)
and under ``sdpa``, forward with max-logits and the backward of
``sum(out * dO)``, on ``tests/test_torch_cp.py``'s masks and shapes. Held:
out, lse, dq, dk, dv and max-logits within float32 1e-5 of JAX's
``sdpa_online`` backend on a 2-device CPU mesh, and of the port's own
``sdpa`` backend; lse carries no gradient (JAX's stop-gradient).
"""

import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu import api as jax_api
from magiattention_tpu.config import DistAttnConfig, OverlapConfig
from magiattention_tpu_torch.testing import assert_close

from tests.test_torch_cp import MASKS
from tests.torch_port_cases import CP_CHUNK, CP_SEQ, cp_inputs, cp_worker

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
CP, DEGREE = 2, 2
BACKENDS = ("sdpa_online", "sdpa")
FAST_MASKS = ("varlen_causal",)
SLOW_MASKS = ("causal", "sliding_window")
MASK_PARAMS = [*FAST_MASKS, *(pytest.param(m, marks=pytest.mark.slow) for m in SLOW_MASKS)]


TAG = {"sdpa_online": "on", "sdpa": "de"}  # equal lengths: the same inputs


def _name(mask, backend):
    """The case name; cp_worker draws its inputs from the name's length,
    so both backends of a mask run on the same inputs."""
    return f"{mask}_{TAG[backend]}"


@lru_cache(maxsize=None)
def _port_run(masks: tuple) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_online_")
    cases = [
        (_name(m, b), *MASKS[m], DEGREE, {"MAGI_ATTENTION_KERNEL_BACKEND": b})
        for m in masks for b in BACKENDS
    ]
    mp.start_processes(
        cp_worker, args=(CP, os.path.join(out_dir, "init"), out_dir, cases), nprocs=CP,
        start_method="spawn", join=True,
    )
    return out_dir


def _port(mask, backend, rank):
    masks = FAST_MASKS if mask in FAST_MASKS else SLOW_MASKS
    return np.load(os.path.join(_port_run(masks), f"{_name(mask, backend)}_{rank}.npz"))


@lru_cache(maxsize=None)
def _jax_run(mask: str):
    """JAX's ``sdpa_online`` backend at cp 2: out, lse (dispatched layout),
    dq, dk, dv and max-logits, on the inputs the port's case drew."""
    qr, kr, types = MASKS[mask]
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa_online")
        mesh = Mesh(np.array(jax.devices("cpu")[:CP]), axis_names=("cp",))
        key = jax_api.magi_attn_flex_key(
            qr, kr, types, CP_SEQ, CP_SEQ, mesh=mesh, chunk_size=CP_CHUNK,
            dist_attn_config=DistAttnConfig(
                overlap_config=OverlapConfig(degree=DEGREE, min_chunk_size=32)
            ),
        )
        q, k, v, do = cp_inputs(len(_name(mask, "sdpa_online")))

        def loss(q, k, v):
            out_d, meta = jax_api.calc_attn(
                jax_api.dispatch(q, key), jax_api.dispatch(k, key, role="kv"),
                jax_api.dispatch(v, key, role="kv"), key, return_max_logits=True,
            )
            out = jax_api.undispatch(out_d, key)
            return jnp.sum(out * do), (out, meta.lse, meta.max_logits)

        grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (out, lse, ml)), grads = grad_fn(*(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out), np.asarray(lse), *(np.asarray(g) for g in grads), np.asarray(ml)]


NAMES = ("out", "lse", "dq", "dk", "dv", "ml")


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_sdpa_online_backend_matches_jax(mask):
    want = _jax_run(mask)
    shard = want[1].shape[0] // CP
    for r in range(CP):
        got = _port(mask, "sdpa_online", r)
        for n, w in zip(NAMES, want):
            if n == "lse":
                w = w[r * shard:(r + 1) * shard]
                np.testing.assert_array_equal(np.isneginf(got[n]), np.isneginf(w))
            assert_close(got[n], w, msg=f"{mask} rank {r} {n}", **TOL)


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_sdpa_online_backend_matches_sdpa(mask):
    """The port's two plain backends on the same inputs: the same merged
    slices, one softmax dense, the other blockwise online."""
    for r in range(CP):
        online = _port(mask, "sdpa_online", r)
        dense = _port(mask, "sdpa", r)
        assert int(online["stages"]) == int(dense["stages"])
        for n in NAMES:
            assert_close(online[n], dense[n], msg=f"{mask} rank {r} {n}", **TOL)
