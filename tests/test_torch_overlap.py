"""The CP runtime's staged (overlapped) backward, the overlap-safety
check, ``dist_attn_func`` and ``get_mesh`` against the JAX package's.

Over gloo at world 4 (one spawn, a file-store ``init_method``), on the
JAX package's ``tests/test_support/test_template_mla.py`` widths (256
tokens, 2 q heads, 1 kv head, d 32) with an overlap degree of 2:

- the staged backward (each stage's GroupReduce issued the moment its
  dk/dv exist, the host part last) equals, to the bit, the same runtime
  with every reduce after every part's backward, flat and two-level at
  (dcn 2, ici 2), with and without
  MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE; out, lse, dq, dk and dv are
  within float32 1e-5 of JAX's ``DistAttnRuntime(use_overlap=True)`` on a
  4-device CPU mesh (its FFA in interpret mode);
- ``assert_overlap_safe`` passes on the plan and fails when the
  overlapped runtime reads one stage's buffer before its rows landed (a
  wait skipped, built here in the test);
- ``dist_attn_func`` against JAX's, MAGI_ATTENTION_PRECISION unset
  (float32 1e-5) and ``bf16`` (bf16 tolerance);
- ``get_mesh`` returns a mesh key's own mesh, and for a ``cp_group`` key
  a one-axis mesh whose line is the group.

And on the host: the GroupReduce's per-destination sum equals one
``index_add_`` on the CPU, bit for bit.
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

from magiattention_tpu import api as jax_api
from magiattention_tpu import config as jax_config
from magiattention_tpu.api.magi_attn_interface import _mgr as jax_mgr
from magiattention_tpu.functional.dist_attn import DistAttnRuntime as JaxRuntime
from magiattention_tpu.functional.dist_attn import dist_attn_func as jax_dist_attn_func
from magiattention_tpu_torch.comm.primitives import scatter_add_rows
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import (
    HIER_CHUNK,
    HIER_MASKS,
    HIER_SEQ,
    OVERLAP_NAMES,
    PRECISION_BF16,
    hier_inputs,
    overlap_config,
    overlap_worker,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2, norm_rtol=1e-2)
FAST_MASKS = ("causal",)
SLOW_MASKS = ("shared_prefix",)
MASK_PARAMS = [*FAST_MASKS, *(pytest.param(m, marks=pytest.mark.slow) for m in SLOW_MASKS)]
CP = 4


@lru_cache(maxsize=None)
def _port_run(masks: tuple) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_overlap_")
    mp.start_processes(
        overlap_worker, args=(CP, os.path.join(out_dir, "init"), out_dir, list(masks)), nprocs=CP,
        start_method="spawn", join=True,
    )
    return out_dir


def _port(mask: str, rank: int):
    masks = FAST_MASKS if mask in FAST_MASKS else SLOW_MASKS
    return np.load(os.path.join(_port_run(masks), f"{mask}_{rank}.npz"))


@lru_cache(maxsize=None)
def _jax_run(mask: str, precision: str | None = None):
    """JAX's overlapped runtime on a 4-device CPU mesh through its
    ``dist_attn_func``: out, lse, dq, dk, dv in the dispatched layout."""
    qr, kr, tm = HIER_MASKS[mask]
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.delenv("MAGI_ATTENTION_KERNEL_BACKEND", raising=False)
        if precision:
            mpatch.setenv("MAGI_ATTENTION_PRECISION", precision)
        mesh = Mesh(np.array(jax.devices("cpu")[:CP]), ("cp",))
        key = jax_api.magi_attn_flex_key(qr, kr, tm, HIER_SEQ, HIER_SEQ, mesh=mesh, cp_axis="cp",
                                         chunk_size=HIER_CHUNK,
                                         dist_attn_config=overlap_config(jax_config))
        mgr = jax_mgr(key)
        rt = JaxRuntime(comm_meta=mgr.comm_meta, calc_meta=mgr.calc_meta, mesh=mesh,
                        cp_axis="cp", use_overlap=True)
        q, k, v, do = (jax_api.dispatch(jnp.asarray(a), key, role=role)
                       for a, role in zip(hier_inputs(), ("qo", "kv", "kv", "qo")))

        def loss(q, k, v):
            out, lse = jax_dist_attn_func(q, k, v, rt)
            return jnp.sum(out.astype(jnp.float32) * do), (out, lse)

        (_, (out, lse)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
    return [np.asarray(t, dtype=np.float32) for t in (out, lse, *grads)]


def _rows(a: np.ndarray, rank: int) -> np.ndarray:
    n = a.shape[0] // CP
    return a[rank * n:(rank + 1) * n]


def _close(got, want, msg, tol):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=msg)
    assert_close(np.where(np.isneginf(got), 0.0, got), np.where(np.isneginf(want), 0.0, want),
                 msg=msg, **tol)


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_staged_backward_matches_jax(mask):
    """The staged backward (flat and two-level, default and
    high-precision reduce) against JAX's overlapped runtime."""
    want = _jax_run(mask)
    for r in range(CP):
        got = _port(mask, r)
        for tag in ("flat", "flat_hp", "hier", "hier_hp"):
            for n, w in zip(OVERLAP_NAMES, want):
                _close(got[f"{tag}_staged_{n}"], _rows(w, r), f"{mask} rank {r} {tag} {n}", TOL)


@pytest.mark.parametrize("comm", ["flat", "flat_hp", "hier", "hier_hp"])
@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_staged_backward_bitwise_equals_unstaged(mask, comm):
    """Issuing each stage's reduce under the next part's compute changes
    when the sums run, not what they sum: the gradients (and the forward)
    equal the runtime's with every reduce after every part, to the bit."""
    for r in range(CP):
        got = _port(mask, r)
        for n in OVERLAP_NAMES:
            np.testing.assert_array_equal(got[f"{comm}_staged_{n}"], got[f"{comm}_unstaged_{n}"],
                                          err_msg=f"{mask} rank {r} {comm} {n}")


def test_assert_overlap_safe_on_real_plan():
    """The port's twin of the JAX package's ``test_template_mla.py``
    check: the check ran on every rank (the worker raises otherwise), and
    a skipped wait makes it fail, naming the tensor."""
    for r in range(CP):
        assert "out mismatch" in str(_port(FAST_MASKS[0], r)["skipped_wait_error"])


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_dist_attn_func_matches_jax(precision):
    """``dist_attn_func`` over the flat runtime against JAX's; under
    MAGI_ATTENTION_PRECISION=bf16 both cast q, k, v to bf16 first."""
    mask = FAST_MASKS[0]
    want = _jax_run(mask, precision)
    tag, tol = ("func_bf16", BF16_TOL) if precision else ("func", TOL)
    assert PRECISION_BF16["MAGI_ATTENTION_PRECISION"] == "bf16"
    for r in range(CP):
        got = _port(mask, r)
        for n, w in zip(OVERLAP_NAMES, want):
            _close(got[f"{tag}_{n}"], _rows(w, r), f"rank {r} {tag} {n}", tol)
        if precision:  # the bf16 run is not the float32 one
            assert not np.array_equal(got["func_bf16_out"], got["func_out"])


@pytest.mark.parametrize("key", ["mesh", "cp_group"])
def test_get_mesh(key):
    for r in range(CP):
        got = _port(FAST_MASKS[0], r)
        if key == "mesh":
            assert bool(got["mesh_is_keys"])
        else:
            assert int(got["group_mesh_shape"]) == CP
            assert got["group_mesh_line"].tolist() == list(range(CP))
            assert int(got["group_mesh_coord"]) == r
            assert bool(got["group_mesh_group"]) and bool(got["group_mesh_cached"])


def test_get_mesh_at_cp1():
    from magiattention_tpu_torch import api

    key = api.magi_attn_flex_key([[0, 64]], [[0, 64]], [1], 64, 64, device="cpu", chunk_size=16)
    mesh = api.get_mesh(key)
    assert mesh.shape == {"cp": 1} and mesh.group("cp") is None and mesh.coord("cp") == 0
    assert api.get_mesh(key) is mesh


@pytest.mark.parametrize("splits", [(5, 0, 7, 4), (12,), (0, 0, 3)])
def test_scatter_add_rows_is_one_index_add(splits):
    """The GroupReduce's sum, one destination's rows at a time, equals one
    ``index_add_`` over all of them on the CPU, to the bit: a row sent to
    several ranks is summed in destination order either way."""
    rng = np.random.default_rng(sum(splits))
    rows = np.concatenate([rng.choice(12, n, replace=False) for n in splits]).astype(np.int64)
    src = torch.from_numpy(rng.standard_normal((len(rows), 2, 3)).astype(np.float32))
    base = torch.from_numpy(rng.standard_normal((12, 2, 3)).astype(np.float32))
    want = base.clone().index_add_(0, torch.from_numpy(rows), src)
    got = scatter_add_rows(base.clone(), torch.from_numpy(rows), src, splits)
    assert torch.equal(got, want)
