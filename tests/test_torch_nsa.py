"""The port's NSA attention against the JAX package's on the CPU: the host
layout (``_block_layout``, ``_p_slc_matrix``), ``nsa_attn`` forward and
gradients to q, k, v and every parameter (JAX under its default slc rung,
the Pallas block-sparse kernels in interpret mode; the port under its
kernel route, the plain versions on the CPU) with equal selection tables,
and the port's slc route resolution (pin, feasibility)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magiattention_tpu.parallel import nsa as jnsa
from magiattention_tpu_torch.kernels import block_sparse as tbs
from magiattention_tpu_torch.parallel import nsa as tnsa
from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

S, HK, DH = 288, 2, 32
KW = dict(l_cmp=32, l_slc=64, d_stride=32, block_size_q=16, slc_top_k=2, window=(64, 0), causal=True)


def test_block_layout_and_p_slc_matrix_match_jax():
    for cu, l, d in (([0, 288], 64, 32), ([0, 96, 288], 32, 32), ([0, 112, 288], 64, 16)):
        for got, want in zip(tnsa._block_layout(cu, l, d), jnsa._block_layout(cu, l, d)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for args in (
        ([9, 5], [7, 3], 64, 32, 32),
        ([12], [10], 96, 32, 32),
        ([4, 4, 4], [2, 2, 2], 64, 64, 32),
        ([17, 3], [15, 1], 128, 32, 16),
    ):
        got, want = tnsa._p_slc_matrix(*args), jnsa._p_slc_matrix(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _inputs(g: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = ((S, HK * g, DH), (S, HK, DH), (S, HK, DH), (S, HK * g, DH))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    params = jax.tree.map(np.asarray, jnsa.init_nsa_params(jax.random.PRNGKey(seed), DH, KW["l_cmp"]))
    return q, k, v, do, params


@pytest.mark.parametrize("cu, g", [([0, 288], 1), ([0, 96, 288], 4)], ids=["segs1-g1", "segs2-g4"])
def test_nsa_attn_matches_jax(cu, g):
    """out and the gradients of sum(out * dO) within float32 2e-5 (out) /
    5e-5 (gradients), JAX's own bounds for its block-sparse kernel against
    the gathered branch; the selected block tables equal."""
    q, k, v, do, params = _inputs(g)
    names = tnsa.PARAM_NAMES

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out_j, vjp = jax.vjp(
        lambda p, q_, k_, v_: jnsa.nsa_attn(q_, k_, v_, p, cu, **KW), params, jq, jk, jv
    )
    gp, *gqkv = vjp(jnp.asarray(do))

    tparams = {n: t.requires_grad_(True) for n, t in tnsa.params_from_numpy(params, "cpu").items()}
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tbs.block_sparse_fwd_plain.calls = tbs.block_sparse_bwd_plain.calls = 0
    out_t, idx_t = tnsa.nsa_attn(*leaves, tparams, cu, return_selection=True, **KW)
    grads_t = torch.autograd.grad(out_t, [*leaves, *tparams.values()], torch.from_numpy(do))
    assert (tbs.block_sparse_fwd_plain.calls, tbs.block_sparse_bwd_plain.calls) == (1, 1)

    # the selections are equal first: a top-k tie flip is no kernel error
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(_jax_selection(jq, jk, params, cu)))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=2e-5, rtol=2e-5)
    want = [*gqkv, *(gp[n] for n in names)]
    for name, a, b in zip(("dq", "dk", "dv", *names), grads_t, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-5, err_msg=name)


def _jax_selection(q, k, params, cu):
    """JAX's top-k table, by the steps of its ``nsa_attn`` (:132-190)."""
    l_cmp, l_slc, ds, bq, top_k = (KW[n] for n in ("l_cmp", "l_slc", "d_stride", "block_size_q", "slc_top_k"))
    hq, hk = q.shape[1], k.shape[1]
    g = hq // hk
    cmp_starts, cmp_seg, cmp_counts = jnsa._block_layout(cu, l_cmp, ds)
    slc_starts, slc_seg, slc_counts = jnsa._block_layout(cu, l_slc, ds)
    row_seg = np.zeros(S, np.int32)
    for s in range(len(cu) - 1):
        row_seg[cu[s]: cu[s + 1]] = s
    n_qb = S // bq
    qb_seg = row_seg.reshape(n_qb, bq)[:, 0]
    blk = cmp_starts[:, None] + np.arange(l_cmp)[None]
    k_cmp = jnp.einsum(
        "nlhd,l->nhd", jnp.take(k, jnp.asarray(blk.reshape(-1)), axis=0).reshape(len(cmp_starts), l_cmp, hk, DH),
        params["w_cmp_k"],
    ) + params["b_cmp_k"]
    logits = jnp.einsum("shgd,nhd->shgn", q.reshape(S, hk, g, DH), k_cmp).astype(jnp.float32) * DH ** -0.5
    logits = jnp.where(jnp.asarray(row_seg[:, None] == cmp_seg[None, :])[:, None, None, :], logits, -jnp.inf)
    p_cmp = jax.nn.softmax(logits, axis=-1)
    M = jnp.asarray(jnsa._p_slc_matrix(cmp_counts, slc_counts, l_slc, l_cmp, ds))
    p_slc = jnp.einsum("shgn,nm->shgm", p_cmp, M)
    score = p_slc.sum(axis=2).reshape(n_qb, bq, hk, len(slc_starts)).sum(1).transpose(1, 0, 2)
    score = jnp.where(jnp.asarray(qb_seg[:, None] == slc_seg[None, :])[None], score, -jnp.inf)
    return jax.lax.top_k(score, top_k)[1]


def test_slc_route(monkeypatch):
    """The pin picks the route where the geometry is feasible; an
    infeasible one (blocks that do not start on the d_stride grid) takes
    the gathered route whatever the pin. On the CPU the kernel route runs
    the plain versions, and both routes give the same NSA output."""
    starts = np.arange(0, 224 + 1, 32, dtype=np.int32)
    monkeypatch.delenv("MAGI_ATTENTION_BACKEND_NSA_SLC", raising=False)
    assert tnsa.slc_route(S, 64, 32, starts) == "block_sparse_pallas"
    assert tnsa.slc_route(S, 64, 32, starts + 16) == "gathered_dense"
    assert tnsa.slc_route(S, 48, 32, starts) == "gathered_dense"
    assert tnsa.slc_route(S, 384, 192, starts * 6) == "gathered_dense"
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_NSA_SLC", "gathered_dense")
    assert tnsa.slc_route(S, 64, 32, starts) == "gathered_dense"
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_NSA_SLC", "block_sparse_pallas")
    assert tnsa.slc_route(S, 64, 32, starts) == "block_sparse_pallas"
    assert tnsa.slc_route(S, 64, 32, starts + 16) == "gathered_dense"
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_NSA_SLC", "bogus")
    assert tnsa.slc_route(S, 64, 32, starts) == "block_sparse_pallas"

    q, k, v, _, params = _inputs(2, seed=3)
    tparams = tnsa.params_from_numpy(params, "cpu")
    args = [torch.from_numpy(a) for a in (q, k, v)] + [tparams, [0, 96, 288]]
    outs = {}
    for pin in ("block_sparse_pallas", "gathered_dense"):
        monkeypatch.setenv("MAGI_ATTENTION_BACKEND_NSA_SLC", pin)
        tbs.block_sparse_fwd_plain.calls = 0
        outs[pin] = tnsa.nsa_attn(*args, return_selection=True, **KW)
        assert tbs.block_sparse_fwd_plain.calls == (pin == "block_sparse_pallas")
    (a, ia), (b, ib) = outs.values()
    assert torch.equal(ia, ib)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def test_init_params_and_errors():
    gen = torch.Generator().manual_seed(0)
    p = tnsa.init_nsa_params(gen, 32, 16, dtype=torch.float64, device="cpu")
    assert {n: tuple(t.shape) for n, t in p.items()} == {
        "w_cmp_k": (16,), "b_cmp_k": (), "w_cmp_v": (16,), "b_cmp_v": (),
        "w_gate": (32, 3), "b_gate": (3,),
    }
    assert all(t.dtype == torch.float64 for t in p.values())
    assert p["w_cmp_k"].abs().max() <= 16 ** -0.5 and p["w_gate"].abs().max() <= 32 ** -0.5
    assert not torch.equal(p["w_cmp_k"], p["w_cmp_v"])
    q = torch.zeros(S, HK, DH)
    with pytest.raises(ValueError, match="cu_seqlens"):
        tnsa.nsa_attn(q, q, q, tnsa.params_from_numpy(_inputs(1)[4], "cpu"), [0, 256], **KW)
    with pytest.raises(ValueError, match="slc_top_k"):
        tnsa.nsa_attn(q, q, q, tnsa.params_from_numpy(_inputs(1)[4], "cpu"), [0, 96, 288],
                      **{**KW, "slc_top_k": 3})
