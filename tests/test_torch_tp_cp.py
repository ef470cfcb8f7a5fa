"""Tensor parallelism over heads composed with CP: the port against the
JAX package.

Over gloo at world 4 (one process per rank, a file-store
``init_method``) on a (cp 2, tp 2) ``ProcessMesh``, each process runs
``magi_attn_flex_key(mesh=..., cp_axis="cp", head_axis="tp")`` and
``dispatch -> calc_attn -> undispatch`` on its own heads (``hq / 2`` q
heads, ``hk / 2`` kv heads, as Megatron hands attention its heads), at
the JAX package's ``tests/test_parallel/test_tp_cp.py`` widths and masks.
JAX runs the same on a (2, 2) CPU mesh (``sdpa`` backend). Held: each
rank's heads of out, lse, dq, dk, dv and max-logits within float32 1e-5
of JAX's; each process solved its cp line's plan once (a key without
``head_axis`` reuses it, and the ranks of a cp line hold the same plan);
kv heads that do not split over TP raise JAX's message, as does
``head_axis`` under qo-comm.
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
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import (
    TP_CHUNK,
    TP_HK,
    TP_HQ,
    TP_MASKS,
    TP_SEQ,
    tp_heads,
    tp_inputs,
    tp_worker,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
FAST_MASKS = ("causal",)
SLOW_MASKS = ("shared_prefix",)
MASK_PARAMS = [*FAST_MASKS, *(pytest.param(m, marks=pytest.mark.slow) for m in SLOW_MASKS)]


@lru_cache(maxsize=None)
def _port_run(masks: tuple) -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_tp_cp_")
    mp.start_processes(
        tp_worker, args=(4, os.path.join(out_dir, "init"), out_dir, list(masks)), nprocs=4,
        start_method="spawn", join=True,
    )
    return out_dir


def _port(mask: str, rank: int):
    masks = FAST_MASKS if mask in FAST_MASKS else SLOW_MASKS
    return np.load(os.path.join(_port_run(masks), f"{mask}_{rank}.npz"))


@lru_cache(maxsize=None)
def _jax_run(mask: str):
    """JAX's TP x CP on a (cp 2, tp 2) CPU mesh (``sdpa`` backend): out, lse
    (dispatched layout), dq, dk, dv and max-logits."""
    qr, kr, tm = TP_MASKS[mask]
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa")
        mesh = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2), ("cp", "tp"))
        key = jax_api.magi_attn_flex_key(qr, kr, tm, TP_SEQ, TP_SEQ, mesh=mesh, cp_axis="cp",
                                         head_axis="tp", chunk_size=TP_CHUNK)
        q, k, v, do = tp_inputs()

        def loss(q, k, v):
            out_d, meta = jax_api.calc_attn(
                jax_api.dispatch(q, key), jax_api.dispatch(k, key, role="kv"),
                jax_api.dispatch(v, key, role="kv"), key, return_max_logits=True,
            )
            out = jax_api.undispatch(out_d, key)
            return jnp.sum(out * do), (out, meta.lse, meta.max_logits)

        grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (out, lse, ml)), grads = grad_fn(*(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out), np.asarray(lse), *(np.asarray(g) for g in grads)], np.asarray(ml)


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_tp_cp_matches_jax(mask):
    want, _ = _jax_run(mask)
    shard = want[1].shape[0] // 2
    for r in range(4):
        got = _port(mask, r)
        t, c = int(got["tp"]), int(got["cp"])
        assert (c, t) == divmod(r, 2)
        h, hk = tp_heads(t, 2, TP_HQ), tp_heads(t, 2, TP_HK)
        every = slice(None)
        sel = {"out": (every, h), "lse": (slice(c * shard, (c + 1) * shard), h),
               "dq": (every, h), "dk": (every, hk), "dv": (every, hk)}
        for n, w in zip(("out", "lse", "dq", "dk", "dv"), want):
            w = w[sel[n]]
            assert got[n].shape == w.shape, f"{mask} rank {r} {n}"
            assert_close(got[n], w, msg=f"{mask} rank {r} {n}", **TOL)


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_tp_cp_max_logits_match_jax(mask):
    _, want = _jax_run(mask)
    for r in range(4):
        got = _port(mask, r)
        h = tp_heads(int(got["tp"]), 2, TP_HQ)
        assert np.isfinite(got["ml"]).all()
        assert_close(got["ml"], want[h], msg=f"{mask} rank {r} max_logits", **TOL)


@pytest.mark.parametrize("mask", MASK_PARAMS)
def test_one_solve_per_cp_line(mask):
    """Each process solved its cp line's plan once; a key that differs
    only in ``head_axis`` reused it from the plan cache; the two cp lines
    (tp 0 and tp 1) hold the same plan."""
    got = [_port(mask, r) for r in range(4)]
    for r, g in enumerate(got):
        assert int(g["solves"]) == 1, f"rank {r}"
        assert str(g["reuse"]) == "memory", f"rank {r}"
        np.testing.assert_array_equal(g["send_idx"], got[0]["send_idx"])


def test_tp_not_dividing_kv_heads_raises():
    want = ("head_axis='tp' (size 2) must divide both num_heads_q (4) and num_heads_kv (3) — "
            "GQA kv heads shard over TP too")
    for r in range(4):
        got = np.load(os.path.join(_port_run(FAST_MASKS), f"raises_{r}.npz"))
        assert str(got["uneven"]) == want


def test_head_axis_with_qo_comm_raises_jax_message():
    want = "MAGI_ATTENTION_QO_COMM=1 does not support head_axis (TP head sharding) yet; unset one of the two"
    for r in range(4):
        got = np.load(os.path.join(_port_run(FAST_MASKS), f"raises_{r}.npz"))
        assert str(got["qo"]) == want
