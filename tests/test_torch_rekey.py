"""Re-keying a new mask onto a dispatch (``make_flex_key_for_new_mask_
after_dispatch``, ``make_varlen_key_for_new_mask_after_dispatch``) and the
cross-attention args, the port over gloo at cp 2 against the JAX package.

The cases of the JAX package's ``tests/test_api/test_rekey.py`` (:37,
:73, :93). Two ranks (spawned, a file-store ``init_method``) plan a causal
dispatch key, re-key it to the full mask and to a (32, 0) sliding window,
dispatch q/k/v with the first key, run ``calc_attn`` under the new one,
undispatch, and back-propagate ``sum(out * dO)`` (the kernels' plain
versions on the CPU). Held: the re-keyed partitions and position ids equal
the dispatch key's (and JAX's); the natural-order output, dq, dk and dv of
every rank within float32 2e-5 of the JAX package's on a 2-device CPU mesh
(its ``sdpa`` backend, jitted); a causal window refused as in JAX; the
cross-attention args equal JAX's and cover the global q x k rectangle
exactly.
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

from magiattention_tpu import api as japi
from magiattention_tpu.api.magi_attn_interface import _mgr as jax_mgr
from magiattention_tpu.common.enum import AttnMaskType
from magiattention_tpu.common.ranges import AttnRanges
from magiattention_tpu_torch.testing import assert_close
from tests.torch_port_cases import REKEY_CHUNK, REKEY_SEQ, rekey_inputs, rekey_worker

CP = 2
TOL = dict(atol=2e-5, rtol=2e-5, norm_rtol=2e-5)


@lru_cache(maxsize=None)
def _port_run() -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_rekey_")
    mp.start_processes(rekey_worker, args=(CP, os.path.join(out_dir, "init"), out_dir),
                       nprocs=CP, start_method="spawn", join=True)
    return out_dir


def _port(name, rank):
    return np.load(os.path.join(_port_run(), f"{name}_{rank}.npz"))


@lru_cache(maxsize=None)
def _jax_keys():
    s = REKEY_SEQ
    mesh = Mesh(np.array(jax.devices("cpu")[:CP]), axis_names=("cp",))
    key1 = japi.magi_attn_flex_key([[0, s]], [[0, s]], [1], s, s, mesh=mesh, chunk_size=REKEY_CHUNK)
    return key1, {
        "full": japi.make_flex_key_for_new_mask_after_dispatch([[0, s]], [[0, s]], [0], key1),
        "window": japi.make_varlen_key_for_new_mask_after_dispatch(
            [0, s], [0, s], key1, causal=False, window_size=(32, 0)),
    }


@lru_cache(maxsize=None)
def _jax_run(name: str):
    key1, keys = _jax_keys()
    key2 = keys[name]
    q, k, v, do = (jnp.asarray(a) for a in rekey_inputs(list(keys).index(name)))
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa")

        def loss(q, k, v):
            out_d, _ = japi.calc_attn(
                japi.dispatch(q, key1), japi.dispatch(k, key1, role="kv"),
                japi.dispatch(v, key1, role="kv"), key2,
            )
            out = japi.undispatch(out_d, key2)
            return jnp.sum(out * do), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", ["full", "window"])
def test_rekey_reuses_dispatch_and_matches_jax(name):
    out, grads = _jax_run(name)
    jkey1, jkeys = _jax_keys()
    for r in range(CP):
        got = _port(name, r)
        assert bool(got["distinct"]) and bool(got["most_recent"])
        np.testing.assert_array_equal(got["partitions"], got["fixed"])
        np.testing.assert_array_equal(got["position_ids"], got["key1_position_ids"])
        np.testing.assert_array_equal(
            got["position_ids"], np.asarray(jax_mgr(jkeys[name]).dispatch_meta_q.position_ids)
        )
        assert_close(got["out"], out, msg=f"{name} rank {r} out", **TOL)
        for g, want in zip(("dq", "dk", "dv"), grads):
            assert_close(got[g], want, msg=f"{name} rank {r} {g}", **TOL)


def test_varlen_rekey_refuses_a_causal_window():
    s = REKEY_SEQ
    with pytest.raises(ValueError):
        japi.make_varlen_key_for_new_mask_after_dispatch(
            [0, s], [0, s], _jax_keys()[0], causal=True, window_size=(32, 0))
    for r in range(CP):
        assert bool(_port("xattn", r)["refused"])


def test_xattn_args_match_jax_and_cover_exactly():
    s, sk = REKEY_SEQ, 96
    ref_q = AttnRanges.from_ranges([[0, 128], [128, s]])
    ref_k = AttnRanges.from_ranges([[0, 48], [48, sk]])
    jargs = jax_mgr(_jax_keys()[0]).get_xattn_args(ref_q, ref_k, AttnMaskType.FULL)
    want = np.zeros((s, sk), dtype=bool)
    for qr, kr in zip(ref_q, ref_k):
        want[qr.start: qr.end, kr.start: kr.end] = True
    for rank in range(CP):
        got = _port("xattn", rank)
        pos = got["position_ids"]
        cover = np.zeros((s, sk), dtype=bool)
        for r, a in enumerate(jargs):
            np.testing.assert_array_equal(got[f"q{r}"], np.asarray(a.q_ranges).reshape(-1, 2))
            np.testing.assert_array_equal(got[f"k{r}"], np.asarray(a.k_ranges).reshape(-1, 2))
            for (qs, qe), (ks, ke) in zip(got[f"q{r}"], got[f"k{r}"]):
                for ql in range(qs, qe):
                    cover[pos[r, ql], ks:ke] = True
        np.testing.assert_array_equal(cover, want)
