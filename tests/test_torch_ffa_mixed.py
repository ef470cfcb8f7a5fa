"""The port's FFA tile flow (auto-tile, per-pass backward tiles, the
mixed-granularity dispatch) and ``paged_attn``'s softcap and causal
arguments, on the CPU against the JAX package.

``ffa_attn`` under MAGI_ATTENTION_FFA_AUTO_TILE=1, under the mixed pin
(MAGI_ATTENTION_FFA_MIXED_BLOCKS=1) and unpinned: out, lse and dq/dk/dv
within float32 1e-5 of the JAX package's ``ffa_attn`` (Pallas in interpret
mode, its own tiles; tile choice changes no result beyond rounding). Under
the mixed pin the port runs two plans and its lse merge (``_FFAMixed``, the
kernels' plain versions on the CPU); its backward runs each branch against
the merged lse and one delta, and the branch gradients sum to the single
plan's. A cp-2 gloo run of the CP runtime under auto-tile
(``DeferredTilePolicy``) against the JAX package's at cp 2 (its dense
backend), with the runtime's tiles the policy's pick over both ranks.
Then ROADMAP C7: ``paged_attn`` with softcap 30 and causal off, float32
within 1e-5 of the JAX package's.

The mixed mask is a dense half and a 16-key sliding band: the band is
fragmented at 64 x 64 (its tiles run 4x its area). For the pin to find a
fine tiling other than the coarse 64 x 64, the test gives the policy a
per-item overhead of 16,384 score elements (above 8,192 a 128-row tile
beats two 64-row ones on the band); the fitted constant is
``tile_policy.OVERHEAD_ELEMS``.
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
from magiattention_tpu.config import DistAttnConfig, OverlapConfig
from magiattention_tpu.env.general import scoped_env as jax_scoped_env
from magiattention_tpu.kernels import paged_kv as jpk
from magiattention_tpu.kernels.ffa import ffa_attn as jax_ffa_attn
from magiattention_tpu.kernels.mask_utils import types_to_bands
from magiattention_tpu_torch.kernels import ffa as port_ffa
from magiattention_tpu_torch.kernels import paged_kv as tpk
from magiattention_tpu_torch.kernels import tile_policy as port_tp
from magiattention_tpu_torch.testing import assert_close

from tests.torch_port_cases import CP_CHUNK, CP_SEQ, cp_inputs, tile_cp_worker

TOL = dict(atol=1e-5, rtol=1e-5, norm_rtol=1e-5)
S, HQ, HK, D = 256, 4, 2, 32
MODES = {
    "auto_tile": {"MAGI_ATTENTION_FFA_AUTO_TILE": "1"},
    "mixed_pin": {"MAGI_ATTENTION_FFA_MIXED_BLOCKS": "1"},
    "unpinned": {},
}


def _mixed_mask():
    qr = np.asarray([[0, S // 2], [S // 2, S]], np.int32)
    kr = qr.copy()
    lo = np.asarray([-(1 << 30), -15], np.int32)
    hi = np.asarray([1 << 30, 0], np.int32)
    return qr, kr, lo, hi


def _causal_docs():
    qr = np.asarray([[0, 80], [80, 176], [176, S]], np.int32)
    return (qr, qr.copy(), *types_to_bands(qr, qr, np.ones(3, np.int32)))


MASKS = {"dense_plus_band": _mixed_mask(), "causal_docs": _causal_docs()}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in ((S, HQ, D), (S, HK, D), (S, HK, D)))
    w = rng.standard_normal((S, HQ, D)).astype(np.float32)
    return q, k, v, w


@lru_cache(maxsize=None)
def _jax(mask, mode):
    qr, kr, lo, hi = MASKS[mask]
    q, k, v, w = _arrays(len(mask))

    def loss(q, k, v):
        out, lse = jax_ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
        return jnp.sum(out * w), (out, lse)

    with jax_scoped_env(MODES[mode]):
        (_, (out, lse)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v))
        )
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _port(mask):
    qr, kr, lo, hi = MASKS[mask]
    q, k, v, w = _arrays(len(mask))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = port_ffa.ffa_attn(*leaves, qr, kr, d_lo=lo, d_hi=hi)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), lse.numpy(), [t.grad.numpy() for t in leaves]


@pytest.fixture
def policy_env(monkeypatch):
    for key in ("MAGI_ATTENTION_FFA_AUTO_TILE", "MAGI_ATTENTION_FFA_MIXED_BLOCKS",
                "MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", "MAGI_ATTENTION_FFA_BLOCK_Q",
                "MAGI_ATTENTION_FFA_BLOCK_K"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(port_tp, "OVERHEAD_ELEMS", {2: 16384, 4: 16384})
    return monkeypatch


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_ffa_attn_matches_jax(mask, mode, policy_env):
    for key, val in MODES[mode].items():
        policy_env.setenv(key, val)
    qr, kr, lo, hi = MASKS[mask]
    how = port_ffa.resolve_dispatch(qr, kr, lo, hi, S, S, D, D, 4)
    if mode == "mixed_pin" and mask == "dense_plus_band":
        assert how.mixed is not None and how.mixed.fine_blocks != how.mixed.coarse_blocks
        assert list(how.mixed.frag_idx) == [1]  # the band
    if mode == "auto_tile":
        fwd, dq, dkv = port_tp.choose_blocks_per_pass(qr, kr, lo, hi, S, S, D, D, 4)
        assert how.mixed is not None or how.blocks == fwd
    got, want = _port(mask), _jax(mask, mode)
    np.testing.assert_array_equal(np.isneginf(got[1]), np.isneginf(want[1]))
    assert_close(got[0], want[0], msg=f"{mask} {mode} out", **TOL)
    assert_close(got[1], want[1], msg=f"{mask} {mode} lse", **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[2], want[2]):
        assert_close(a, b, msg=f"{mask} {mode} {name}", **TOL)


def test_mixed_backward_sums_branches_against_the_merged_lse(policy_env):
    """The mixed function's gradients equal the single plan's (sdpa on the
    CPU), and each branch alone, run against the merged lse and delta,
    gives its share: their sum is the whole."""
    policy_env.setenv("MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", "mixed")
    qr, kr, lo, hi = MASKS["dense_plus_band"]
    q, k, v, w = (torch.from_numpy(a) for a in _arrays(7))
    mix = port_ffa.resolve_dispatch(qr, kr, lo, hi, S, S, D, D, 4).mixed
    assert mix is not None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = port_ffa.ffa_attn(*leaves, qr, kr, d_lo=lo, d_hi=hi)
    (out * w).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out_r, lse_r = port_ffa.sdpa_attn(*ref, qr, kr, None, d_lo=lo, d_hi=hi)
    (out_r * w).sum().backward()
    assert_close(out.detach(), out_r.detach(), msg="out", **TOL)
    assert_close(lse, lse_r.detach(), msg="lse", **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        assert_close(a.grad, b.grad, msg=name, **TOL)
    # the merge of the two branches' forwards is the single pass
    parts = [
        port_ffa.ffa_attn(q, k, v, qr[i], kr[i], d_lo=lo[i], d_hi=hi[i])
        for i in (mix.dense_idx, mix.frag_idx)
    ]
    mo, ml = port_ffa._merge_out_lse(parts[0][0], parts[0][1], parts[1][0], parts[1][1])
    assert_close(mo, out_r.detach(), msg="merged out", **TOL)
    assert_close(ml, lse_r.detach(), msg="merged lse", **TOL)


def test_merge_keeps_uncovered_rows():
    """A row neither branch covers stays (0, -inf); a row one branch
    covers takes that branch's (out, lse) exactly."""
    gen = torch.Generator().manual_seed(0)
    o1, o2 = torch.randn(4, 2, 8, generator=gen), torch.randn(4, 2, 8, generator=gen)
    l1 = torch.tensor([[0.5, -np.inf], [1.0, 2.0], [-np.inf, -np.inf], [3.0, -np.inf]])
    l2 = torch.tensor([[-np.inf, 1.5], [0.0, -np.inf], [-np.inf, -np.inf], [-np.inf, -np.inf]])
    out, lse = port_ffa._merge_out_lse(o1, l1, o2, l2)
    assert torch.isneginf(lse[2]).all() and not out[2].any()
    assert torch.equal(lse[0, 0], l1[0, 0]) and torch.allclose(out[0, 0], o1[0, 0])
    assert torch.equal(lse[0, 1], l2[0, 1]) and torch.allclose(out[0, 1], o2[0, 1])
    want = torch.logaddexp(l1[1, 0], l2[1, 0])
    assert torch.allclose(lse[1, 0], want)


# ---------------------------------------------------------------------------
# the CP runtime under auto-tile, cp 2 over gloo
# ---------------------------------------------------------------------------

CP_MASK = ([(0, 160), (160, 352), (352, 512)],) * 2 + ([1, 1, 1],)
CP_ENV = {"MAGI_ATTENTION_FFA_AUTO_TILE": "1"}
CP_SEED = 21


@lru_cache(maxsize=None)
def _cp_port() -> str:
    out_dir = tempfile.mkdtemp(prefix="torch_tile_cp_")
    init_file = os.path.join(out_dir, "init")
    cases = [("auto_tile", *CP_MASK, 2, CP_SEED, CP_ENV)]
    mp.start_processes(
        tile_cp_worker, args=(2, init_file, out_dir, cases), nprocs=2,
        start_method="spawn", join=True,
    )
    return out_dir


def _cp_jax():
    qr, kr, types = CP_MASK
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("MAGI_ATTENTION_KERNEL_BACKEND", "sdpa")
        mesh = Mesh(np.array(jax.devices("cpu")[:2]), axis_names=("cp",))
        key = jax_api.magi_attn_flex_key(
            qr, kr, types, CP_SEQ, CP_SEQ, mesh=mesh, chunk_size=CP_CHUNK,
            dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(degree=2, min_chunk_size=32)),
        )
        q, k, v, do = cp_inputs(CP_SEED)

        def loss(q, k, v):
            out_d, meta = jax_api.calc_attn(
                jax_api.dispatch(q, key), jax_api.dispatch(k, key, role="kv"),
                jax_api.dispatch(v, key, role="kv"), key,
            )
            out = jax_api.undispatch(out_d, key)
            return jnp.sum(out * do), (out, meta.lse)

        fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (out, lse)), grads = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def test_cp_runtime_under_auto_tile_matches_jax():
    out_dir = _cp_port()
    out, lse, grads = _cp_jax()
    shard = lse.shape[0] // 2
    ranks = [np.load(os.path.join(out_dir, f"auto_tile_{r}.npz")) for r in range(2)]
    for r, got in enumerate(ranks):
        assert_close(got["out"], out, msg=f"rank {r} out", **TOL)
        assert_close(got["lse"], lse[r * shard:(r + 1) * shard], msg=f"rank {r} lse", **TOL)
        for g, want in zip(("dq", "dk", "dv"), grads):
            assert_close(got[g], want, msg=f"rank {r} {g}", **TOL)
        # the deferred policy built the plans at its pick over both ranks
        assert bool(got["pending"])
        pick = got["pick"]
        assert (got["plan_tiles"] == pick[0]).all()
        assert np.array_equal(got["policy_bwd"], pick[1:])
        # float32: the backward's bodies take 64 x 64 only
        assert (got["params_dq"] == (64, 64)).all() and (got["params_dkv"] == (64, 64)).all()
    assert np.array_equal(ranks[0]["pick"], ranks[1]["pick"])


@pytest.mark.parametrize("qo_comm", [False, True], ids=["static", "qo_comm"])
def test_runtimes_defer_their_tiles_to_the_first_call(qo_comm, policy_env):
    """Both CP runtimes under auto-tile at cp 1: no plan until the first
    ``calc_attn`` (the dtype and head dims are known only then), then the
    policy's pick over every rank's slice set, with its per-pass tiles on
    the params; the result equal to the dense plain attention."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr

    policy_env.setenv("MAGI_ATTENTION_FFA_AUTO_TILE", "1")
    if qo_comm:
        policy_env.setenv("MAGI_ATTENTION_QO_COMM", "1")
    qr, kr, types = [[0, 96], [96, 256]], [[0, 96], [96, 256]], [1, 1]
    key = api.magi_attn_flex_key(qr, kr, types, S, S, device="cpu", chunk_size=32)
    rt = _mgr(key).runtime
    assert rt._auto_tile_pending and not hasattr(rt, "plans" if not qo_comm else "ffa_plan")
    q, k, v, w = (torch.from_numpy(a) for a in _arrays(3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out_d, meta = api.calc_attn(api.dispatch(leaves[0], key), api.dispatch(leaves[1], key, role="kv"),
                                api.dispatch(leaves[2], key, role="kv"), key)
    out = api.undispatch(out_d, key)
    (out * w).sum().backward()
    geoms, sq, sk = rt._tile_geoms()
    fwd, dq, dkv = port_tp.choose_blocks_per_pass_multi(geoms, sq, sk, D, D, 4)
    plans = [rt.ffa_plan] if qo_comm else rt.plans
    assert all((p.block_q, p.block_k) == fwd for p in plans)
    assert rt._policy_bwd == (dq, dkv)
    params = rt.params(D, 4) if qo_comm else rt._params(D, 4)[0]
    assert params.dq_blocks() == (dq or fwd) and params.dkv_blocks() == (dkv or fwd)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out_r, _ = port_ffa.sdpa_attn(*ref, np.array(qr), np.array(kr), np.array(types))
    (out_r * w).sum().backward()
    assert_close(out.detach(), out_r.detach(), msg="out", **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), leaves, ref):
        assert_close(a.grad, b.grad, msg=name, **TOL)


# ---------------------------------------------------------------------------
# ROADMAP C7: paged_attn's softcap and causal
# ---------------------------------------------------------------------------

PHK, PD, PS, NUM_PAGES, P = 2, 16, 8, 16, 4


@pytest.mark.parametrize("causal", [False, True])
def test_paged_attn_softcap_and_causal_match_jax(causal):
    rng = np.random.default_rng(9)
    tc = tpk.PagedKVCache.create(NUM_PAGES, PS, PHK, PD, 2, P, dtype=torch.float32, device="cpu")
    jc = jpk.PagedKVCache.create(NUM_PAGES, PS, PHK, PD, 2, P, dtype=jnp.float32)
    length, t = 27, 5
    pages = rng.permutation(NUM_PAGES)[: -(-length // PS)].astype(np.int32)
    tc, jc = tpk.assign_pages(tc, 1, pages), jpk.assign_pages(jc, 1, pages)
    k = rng.standard_normal((length, PHK, PD)).astype(np.float32)
    v = rng.standard_normal((length, PHK, PD)).astype(np.float32)
    tc = tpk.append_kv(tc, 1, torch.from_numpy(k), torch.from_numpy(v))
    jc = jpk.append_kv(jc, 1, jnp.asarray(k), jnp.asarray(v))
    q = rng.standard_normal((t, 2 * PHK, PD)).astype(np.float32)
    got = tpk.paged_attn(torch.from_numpy(q), tc, 1, length - t, P, softcap=30.0, causal=causal)
    want = jpk.paged_attn(jnp.asarray(q), jc, 1, length - t, P, softcap=30.0, causal=causal)
    assert_close(got[0], np.asarray(want[0]), msg="out", **TOL)
    assert_close(got[1], np.asarray(want[1]), msg="lse", **TOL)
    if not causal:  # every row sees every token: no row differs from the last
        full = tpk.paged_attn(torch.from_numpy(q[-1:]), tc, 1, length - 1, P, softcap=30.0)
        assert_close(got[0][-1:], full[0], msg="last row", **TOL)
