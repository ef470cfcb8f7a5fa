"""The port's context-parallel main path over gloo against the JAX
package at the same cp size.

For cp 2 and 4, one process per rank (spawned, a file-store
``init_method``: no fixed port, so parallel test workers do not collide)
runs ``magi_attn_flex_key -> dispatch -> calc_attn -> undispatch`` and
the backward of ``sum(out * dO)`` on the CPU (the kernels' plain
versions), for three masks (causal, varlen causal over three documents, a
sliding window over two documents) at overlap degrees 1, 2 and 4 (every
pair at cp 4, one degree per mask at cp 2), plus one case under the
high-precision reduce. The JAX package runs the same mask, chunking and
overlap config on a cp-device CPU mesh with its plain (``sdpa``) backend,
jitted. Held: the natural-order output and dq, dk, dv
(every rank's, which must be the whole gradients, as JAX's global ones
are) and each rank's lse rows; float32 atol/rtol/rel-norm 1e-5.

The per-head max-logits of every rank against the JAX package's
(``calc_attn(return_max_logits=True)``, all-reduced over the group).

Also GroupCast and GroupReduce on their own (``group_cast_rows`` and its
backward, ``group_reduce_rows``) against a numpy gather and scatter-add
over the solver's send indices.
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
from magiattention_tpu.api.functools import infer_attn_mask_from_cu_seqlens
from magiattention_tpu.config import DistAttnConfig, OverlapConfig
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import (
    CP_CHUNK,
    CP_SEQ,
    cp_inputs,
    cp_worker,
)

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
HP = {"MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE": "1"}


def _window_mask():
    qr, kr, types = infer_attn_mask_from_cu_seqlens([0, 256, 512], causal=False, window_size=(64, 0))
    return qr.to_naive_ranges(), kr.to_naive_ranges(), [t.to_int_type() for t in types]


MASKS = {
    "causal": ([(0, 512)], [(0, 512)], [1]),
    "varlen_causal": ([(0, 160), (160, 352), (352, 512)],) * 2 + ([1, 1, 1],),
    "sliding_window": _window_mask(),
}
CASES = {
    2: [("causal", 1, {}), ("varlen_causal", 2, {}), ("sliding_window", 4, {})],
    4: [(m, deg, {}) for m in MASKS for deg in (1, 2, 4)] + [("causal", 2, HP)],
}
CP_CASES = [(cp, *c) for cp, cases in CASES.items() for c in cases]


def _case_name(mask, degree, env):
    return f"{mask}_deg{degree}" + ("_hp" if env else "")


@lru_cache(maxsize=None)
def _port_run(cp: int) -> str:
    """Spawn the cp ranks once; they run every case. Returns the output
    directory."""
    out_dir = tempfile.mkdtemp(prefix="torch_cp_")
    init_file = os.path.join(out_dir, "init")
    cases = [
        (_case_name(m, deg, env), *MASKS[m], deg, env) for m, deg, env in CASES[cp]
    ]
    mp.start_processes(
        cp_worker, args=(cp, init_file, out_dir, cases), nprocs=cp,
        start_method="spawn", join=True,
    )
    return out_dir


@lru_cache(maxsize=None)
def _jax_run(cp: int, mask: str, degree: int, hp: bool):
    """JAX (out, lse in the dispatched layout, dq, dk, dv), natural order,
    and the per-head max-logits."""
    qr, kr, types = MASKS[mask]
    env = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa", **(HP if hp else {})}
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in env.items():
            mpatch.setenv(k, v)
        mesh = Mesh(np.array(jax.devices("cpu")[:cp]), axis_names=("cp",))
        key = jax_api.magi_attn_flex_key(
            qr, kr, types, CP_SEQ, CP_SEQ, mesh=mesh, chunk_size=CP_CHUNK,
            dist_attn_config=DistAttnConfig(
                overlap_config=OverlapConfig(degree=degree, min_chunk_size=32)
            ),
        )
        q, k, v, do = cp_inputs(len(_case_name(mask, degree, env if hp else {})))

        def loss(q, k, v):
            out_d, meta = jax_api.calc_attn(
                jax_api.dispatch(q, key), jax_api.dispatch(k, key, role="kv"),
                jax_api.dispatch(v, key, role="kv"), key, return_max_logits=True,
            )
            out = jax_api.undispatch(out_d, key)
            return jnp.sum(out * do), (out, meta.lse, meta.max_logits)

        grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (out, lse, ml)), grads = grad_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads], np.asarray(ml)


@pytest.mark.parametrize(
    "cp,mask,degree,env", CP_CASES, ids=[f"cp{c[0]}-{_case_name(*c[1:])}" for c in CP_CASES]
)
def test_cp_matches_jax(cp, mask, degree, env):
    out_dir = _port_run(cp)
    out, lse, grads, _ = _jax_run(cp, mask, degree, bool(env))
    name = _case_name(mask, degree, env)
    shard = lse.shape[0] // cp
    stages = set()
    for r in range(cp):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))
        stages.add(int(got["stages"]))
        assert_close(got["out"], out, msg=f"{name} rank {r} out", **TOL)
        np.testing.assert_array_equal(
            np.isneginf(got["lse"]), np.isneginf(lse[r * shard:(r + 1) * shard])
        )
        assert_close(got["lse"], lse[r * shard:(r + 1) * shard], msg=f"{name} rank {r} lse", **TOL)
        for g, want in zip(("dq", "dk", "dv"), grads):
            assert_close(got[g], want, msg=f"{name} rank {r} {g}", **TOL)
    assert len(stages) == 1  # every rank ran the same plan
    if cp == 4 and degree > 1:
        assert stages.pop() > 1  # the multi-stage path ran


@pytest.mark.parametrize(
    "cp,mask,degree,env", CP_CASES, ids=[f"cp{c[0]}-{_case_name(*c[1:])}" for c in CP_CASES]
)
def test_cp_max_logits_matches_jax(cp, mask, degree, env):
    """``calc_attn(return_max_logits=True)``: every rank holds the global
    per-head max (its parts' max, all-reduced MAX over the gloo group),
    equal to the JAX package's at the same cp size."""
    out_dir = _port_run(cp)
    want = _jax_run(cp, mask, degree, bool(env))[3]
    name = _case_name(mask, degree, env)
    for r in range(cp):
        got = np.load(os.path.join(out_dir, f"{name}_{r}.npz"))["ml"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert_close(got, want, msg=f"{name} rank {r} max_logits", **TOL)


@pytest.mark.parametrize("cp", [2, 4])
def test_group_cast_and_reduce_match_numpy(cp):
    """GroupCast delivers each rank the rows the solver planned, source by
    source; GroupReduce (and GroupCast's backward) sums every rank's
    partials back into the owners' rows."""
    from magiattention_tpu_torch import meta as port_meta
    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.config import DistAttnConfig as PortConfig
    from magiattention_tpu_torch.config import OverlapConfig as PortOverlap

    out_dir = _port_run(cp)
    got = [np.load(os.path.join(out_dir, f"comm_{r}.npz")) for r in range(cp)]
    mask = str(got[0]["case"]).split("_deg")[0]
    degree = int(str(got[0]["case"]).split("_deg")[1].split("_")[0])
    qr, kr, types = MASKS[mask]
    config = PortConfig(overlap_config=PortOverlap(degree=degree, min_chunk_size=32))
    mq, mkv, bucket = port_meta.make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr),
        [AttnMaskType.from_int_type(t) for t in types], CP_SEQ, CP_SEQ, CP_CHUNK, cp,
        config.dispatch_config,
    )
    comm, _ = port_meta.make_attn_meta_from_dispatch_meta(bucket, mq, config, dispatch_meta_kv=mkv)
    assert len(comm.kv_stages) > 1
    xs = [g["x"] for g in got]
    for st, stage in enumerate(comm.kv_stages):
        counts = stage.send_counts
        for r in range(cp):
            want = np.zeros((stage.r_max, xs[0].shape[1]), np.float32)
            rows = [xs[s][stage.send_idx[s, r, : counts[s, r]]] for s in range(cp)]
            cat = np.concatenate(rows)
            want[: len(cat)] = cat
            np.testing.assert_array_equal(got[r][f"cast{st}"], want)
            red = np.zeros_like(xs[r], dtype=np.float64)
            for d in range(cp):
                off = int(counts[:r, d].sum())
                seg = got[d][f"y{st}"][off: off + counts[r, d]]
                np.add.at(red, stage.send_idx[r, d, : counts[r, d]], seg)
            assert_close(got[r][f"reduce{st}"], red, msg=f"reduce st{st} r{r}", **TOL)
            assert_close(got[r][f"grad{st}"], red, msg=f"cast grad st{st} r{r}", **TOL)


def test_lse_merge_matches_jax_and_empty_parts_give_zero():
    """The partial-attention merges (functional/utils.py) against the JAX
    package's on the same partials; a row every part leaves empty (lse
    -inf, out 0) merges to out 0 and lse -inf, never NaN."""
    import torch

    from magiattention_tpu.functional import utils as jax_utils
    from magiattention_tpu_torch.functional import utils

    rng = np.random.default_rng(3)
    outs = rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
    lses = rng.standard_normal((3, 16, 2)).astype(np.float32)
    lses[0, :4] = -np.inf  # part 0 empty on rows 0..3
    lses[:, 8:10] = -np.inf  # rows 8, 9 empty in every part
    outs[lses == -np.inf] = 0.0
    got = utils.lse_weighted_reduce(torch.from_numpy(outs), torch.from_numpy(lses))
    want = jax_utils.lse_weighted_reduce(jnp.asarray(outs), jnp.asarray(lses))
    for a, b in zip(got, want):
        assert not torch.isnan(a).any()
        np.testing.assert_array_equal(np.isneginf(a.numpy()), np.isneginf(np.asarray(b)))
        assert_close(a.numpy(), np.asarray(b), **TOL)
    assert not got[0][8:10].any() and torch.isneginf(got[1][8:10]).all()
    two = [torch.from_numpy(x) for x in (outs[0], lses[0], outs[1], lses[1])]
    got2 = utils.correct_attn_out_lse(*two)
    want2 = jax_utils.correct_attn_out_lse(*(jnp.asarray(x.numpy()) for x in two))
    for a, b in zip(got2, want2):
        assert not torch.isnan(a).any()
        assert_close(a.numpy(), np.asarray(b), **TOL)
