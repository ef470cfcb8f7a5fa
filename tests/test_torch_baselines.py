"""The port's CP baselines over gloo against the JAX package's and the
port's single-device FFA, and the adjoints of their collectives.

One spawn of four processes (a file-store ``init_method``) runs every
baseline of ``magiattention_tpu_torch.parallel`` (ring P2P and AllGather
under zigzag and contiguous sharding, Ulysses at cp 4, USP at (2, 2),
LoongTrain at (O 2, I 2) under both shardings and 2D at (U 2, O 1, I 2)
under both placements, HybridCP at (2, 2), AllGather at cp 4) on three
masks at S 256, hq 8, hk 4, d 32, float32: each process's shard forward
and the backward of ``sum(out * dO)``, on the CPU (the kernels' plain
versions). Held, in natural order: out, lse and dq, dk, dv

- against the JAX package's function on a CPU mesh of the same shape,
  ``jax.grad`` of the same sum: one variant of each baseline on the
  ``varlen_causal`` mask in the fast tier, the rest in the slow tier (the
  JAX baselines run their Pallas kernels interpreted, two to four seconds
  a call);
- against the port's single-device ``ffa_attn`` on every mask;

within float32 atol/rtol 2e-5.

The same spawn checks each collective of ``comm.functional`` (the
all-to-all both ways, the all-gather, the ring pass of two tensors and
LoongTrain's double ring) over both axes of a (2, 2) mesh: its backward
is its adjoint, <op(x), y> == <x, op^T(y)> summed over the world.
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

from magiattention_tpu import parallel as jax_parallel
from magiattention_tpu_torch.kernels.ffa import ffa_attn
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import (
    BASE_MASKS,
    BASE_SEQ,
    BASELINES,
    base_inputs,
    baselines_worker,
    dispatch_perm,
)

WORLD = 4
TOL = dict(atol=2e-5, rtol=2e-5)
FIELDS = ("out", "lse", "dq", "dk", "dv")
CASES = [(name, mask) for name in BASELINES for mask in BASE_MASKS]
ADJOINTS = [f"{op}_{axis}" for op in ("a2a_10", "a2a_01", "gather", "ring") for axis in "ab"]
ADJOINTS.append("double_ring")


@lru_cache(maxsize=None)
def _port_run() -> str:
    """Spawn the world once; it runs every case. Returns its output directory."""
    out_dir = tempfile.mkdtemp(prefix="torch_baselines_")
    mp.start_processes(
        baselines_worker, args=(WORLD, os.path.join(out_dir, "init"), out_dir, CASES),
        nprocs=WORLD, start_method="spawn", join=True,
    )
    return out_dir


def _natural(name: str, mask: str) -> dict:
    """The port's per-process results of a case as whole natural-order
    arrays: each process's rows placed at its shard index, then the
    dispatch undone."""
    parts = [np.load(os.path.join(_port_run(), f"{name}_{mask}_{r}.npz")) for r in range(WORLD)]
    assert sorted(int(p["index"]) for p in parts) == list(range(WORLD))
    perm = dispatch_perm(BASELINES[name][3])
    res = {}
    for f in FIELDS:
        rows = BASE_SEQ // WORLD
        layout = np.zeros((BASE_SEQ, *parts[0][f].shape[1:]), np.float32)
        for p in parts:
            i = int(p["index"])
            layout[i * rows:(i + 1) * rows] = p[f]
        res[f] = np.empty_like(layout)
        res[f][perm] = layout
    return res


def _jax_mesh(spec):
    devices = jax.devices("cpu")[:WORLD]
    if spec[0] == "loongtrain":
        (u, o, i), placement = spec[1], spec[2]
        return jax_parallel.make_loongtrain_mesh(devices, u, o, i, placement)
    names, shape = spec
    return Mesh(np.array(devices).reshape(shape), axis_names=names)


def _jax_run(name: str, mask: str) -> dict:
    """The JAX package's baseline on the same inputs: out, lse and the
    gradients of sum(out * dO), natural order."""
    fn, spec, _, dispatch, kw = BASELINES[name]
    perm = dispatch_perm(dispatch)
    q, k, v, do = (jnp.asarray(a[perm]) for a in base_inputs(len(mask)))
    qr, kr, tm = (np.asarray(x) for x in BASE_MASKS[mask])
    mesh = _jax_mesh(spec)

    def loss(q, k, v):
        out, lse = getattr(jax_parallel, fn)(q, k, v, qr, kr, tm, mesh, **kw)
        return jnp.sum(out * do), (out, lse)

    (_, (out, lse)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    res = {}
    for f, a in zip(FIELDS, (out, lse, *grads)):
        res[f] = np.empty(a.shape, np.float32)
        res[f][perm] = np.asarray(a)
    return res


def _single_device(mask: str) -> dict:
    """The port's one-device ``ffa_attn`` (CPU: its plain version)."""
    q, k, v, do = (torch.from_numpy(a) for a in base_inputs(len(mask)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = ffa_attn(*leaves, *BASE_MASKS[mask])
    (out * do).sum().backward()
    return dict(out=out.detach().numpy(), lse=lse.numpy(),
                **{f: t.grad.numpy() for f, t in zip(("dq", "dk", "dv"), leaves)})


def _hold(got: dict, want: dict, what: str) -> None:
    for f in FIELDS:
        assert_close(got[f], want[f], msg=f"{what} {f}", **TOL)


# in the fast tier: one variant of each baseline on one mask
JAX_FAST = ("ring_zigzag", "ring_ag_zigzag", "ulysses", "usp", "loongtrain_zigzag",
            "loongtrain_2d_context_first", "hybrid", "allgather")
JAX_CASES = [
    pytest.param(name, mask, marks=(
        () if name in JAX_FAST and mask == "varlen_causal" else pytest.mark.slow
    ))
    for name, mask in CASES
]


@pytest.mark.parametrize("name,mask", JAX_CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_baseline_matches_jax(name, mask):
    _hold(_natural(name, mask), _jax_run(name, mask), f"{name} {mask} vs JAX")


@pytest.mark.parametrize("name,mask", CASES, ids=[f"{n}-{m}" for n, m in CASES])
def test_baseline_matches_single_device(name, mask):
    _hold(_natural(name, mask), _single_device(mask), f"{name} {mask} vs ffa_attn")


@pytest.mark.parametrize("op", ADJOINTS)
def test_collective_backward_is_adjoint(op):
    for r in range(WORLD):
        fwd, adj = np.load(os.path.join(_port_run(), f"adjoint_{r}.npz"))[op]
        assert abs(fwd) > 1e-3  # the check sees something
        np.testing.assert_allclose(adj, fwd, rtol=1e-12, atol=1e-12, err_msg=f"{op} rank {r}")
