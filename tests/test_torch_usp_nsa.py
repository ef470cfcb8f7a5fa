"""The port's ``usp_nsa_attn`` over gloo at (ring 2, ulysses 2) against
the JAX package's and the port's single-device ``nsa_attn``.

Four processes (one spawn, a file-store ``init_method``) run
``usp_nsa_attn`` on their shards at the JAX package's NSA test shapes (S
256 in two documents, hq 4, hk 2, d 32, float32) over the JAX package's
parameters, forward and the backward of ``sum(out * dO)``, the parameter
gradients all-reduced (SUM) over the world. Held within float32 atol/rtol
2e-5, natural order: the output against JAX's ``usp_nsa_attn`` on a
(2, 2) CPU mesh (forward, as the JAX package's own test holds it), and
the output and the gradients of q, k, v and of every parameter against
the port's single-device ``nsa_attn``: the replicated parameters'
partials sum to the one-device gradient. (``b_cmp_k``'s true gradient is
0: a shift of every compressed key leaves each query's softmax as it is;
both sides give rounding residue, held by the same absolute tolerance.)
"""

import os
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from magiattention_tpu.parallel import nsa as jax_nsa
from magiattention_tpu_torch.parallel import nsa_attn, params_from_numpy
from magiattention_tpu_torch.parallel.nsa import PARAM_NAMES

from tests.torch_port_cases import NSA_CU, NSA_D, NSA_KW, NSA_SEQ, nsa_inputs, usp_nsa_worker

WORLD = 4
TOL = dict(atol=2e-5, rtol=2e-5)  # as np.testing.assert_allclose holds it


@lru_cache(maxsize=None)
def _tree() -> dict:
    params = jax_nsa.init_nsa_params(jax.random.PRNGKey(1), NSA_D, NSA_KW["l_cmp"])
    return {n: np.asarray(params[n]) for n in PARAM_NAMES}


@lru_cache(maxsize=None)
def _port_run() -> dict:
    """Spawn the world once. Returns the natural-order out, dq, dk, dv and
    the all-reduced parameter gradients (every rank's, which must agree)."""
    out_dir = tempfile.mkdtemp(prefix="torch_usp_nsa_")
    mp.start_processes(
        usp_nsa_worker, args=(WORLD, os.path.join(out_dir, "init"), out_dir, _tree()),
        nprocs=WORLD, start_method="spawn", join=True,
    )
    parts = [np.load(os.path.join(out_dir, f"usp_nsa_{r}.npz")) for r in range(WORLD)]
    rows = NSA_SEQ // WORLD
    res = {}
    for f in ("out", "dq", "dk", "dv"):
        res[f] = np.zeros((NSA_SEQ, *parts[0][f].shape[1:]), np.float32)
        for p in parts:
            i = int(p["index"])
            res[f][i * rows:(i + 1) * rows] = p[f]
    for n in PARAM_NAMES:
        for p in parts[1:]:
            np.testing.assert_array_equal(p[f"g_{n}"], parts[0][f"g_{n}"])
        res[f"g_{n}"] = parts[0][f"g_{n}"]
    return res


def test_usp_nsa_forward_matches_jax():
    q, k, v, _ = (jnp.asarray(a) for a in nsa_inputs())
    params = {n: jnp.asarray(a) for n, a in _tree().items()}
    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]).reshape(2, 2), axis_names=("rp", "sp"))
    want = jax.jit(lambda q, k, v: jax_nsa.usp_nsa_attn(q, k, v, params, NSA_CU, mesh, **NSA_KW))(q, k, v)
    np.testing.assert_allclose(_port_run()["out"], np.asarray(want), err_msg="usp_nsa out vs JAX", **TOL)


@pytest.mark.parametrize("field", ["out", "dq", "dk", "dv", *(f"g_{n}" for n in PARAM_NAMES)])
def test_usp_nsa_matches_single_device(field):
    q, k, v, do = (torch.from_numpy(a) for a in nsa_inputs())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    params = {n: p.requires_grad_(True) for n, p in params_from_numpy(_tree(), "cpu").items()}
    out = nsa_attn(*leaves, params, NSA_CU, **NSA_KW)
    (out * do).sum().backward()
    want = dict(out=out.detach(), dq=leaves[0].grad, dk=leaves[1].grad, dv=leaves[2].grad,
                **{f"g_{n}": p.grad for n, p in params.items()})[field]
    np.testing.assert_allclose(_port_run()[field], want.numpy(), err_msg=f"usp_nsa {field} vs nsa_attn",
                               **TOL)
