"""The port's ``testing/`` helpers against the JAX package's.

- ``ref_attn`` / ``ref_max_logits``: out, lse and max-logits within 1e-5 of
  JAX's on the same seeded inputs (causal, a random mask with an empty row,
  GQA, sink columns, softcap), and the gradients of ``sum(out * dO)`` in q,
  k, v and the sink within 1e-5 of ``jax.vjp``'s.
- ``GroundTruthDispatcher``: per-chunk and per-rank areas equal JAX's.
- ``FlagCombGenerator``: every strategy's sequence, at several seeds, equal
  JAX's; ``with_flags`` sets and restores the environment.
- ``precompile``: the plans ``ffa_attn`` resolves are warm afterwards; the
  kernel build raises typed where ``nvcc`` is missing.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.common.enum import AttnMaskType as JType
from magiattention_tpu.common.ranges import AttnRanges as JRanges
from magiattention_tpu.testing import flag_generator as jflags
from magiattention_tpu.testing.gt_dispatcher import GroundTruthDispatcher as JGT
from magiattention_tpu.testing.ref_attn import ref_attn as j_ref_attn
from magiattention_tpu.testing.ref_attn import ref_max_logits as j_ref_max_logits
from magiattention_tpu_torch import testing as ptesting
from magiattention_tpu_torch.common.enum import AttnMaskType
from magiattention_tpu_torch.common.ranges import AttnRanges
from magiattention_tpu_torch.testing import flag_generator as pflags

TOL = dict(atol=1e-5, rtol=1e-5)


def _mask(kind: str, sq: int, sk: int, rng) -> np.ndarray:
    if kind == "causal":
        return np.tril(np.ones((sq, sk), bool), k=sk - sq)
    m = rng.random((sq, sk)) < 0.6
    m[3] = False  # a row nothing is attended
    return m


CASES = {
    "causal": dict(mask="causal", hq=2, hk=2),
    "random_gqa": dict(mask="random", hq=4, hk=2),
    "sink": dict(mask="random", hq=2, hk=1, sink=2),
    "softcap": dict(mask="causal", hq=2, hk=1, softcap=5.0, scale=0.3),
}


def _inputs(case, seed=0, sq=24, sk=32, d=16):
    rng = np.random.default_rng(seed)
    c = CASES[case]
    arrays = dict(
        q=rng.standard_normal((sq, c["hq"], d)).astype(np.float32),
        k=rng.standard_normal((sk, c["hk"], d)).astype(np.float32),
        v=rng.standard_normal((sk, c["hk"], d)).astype(np.float32),
        do=rng.standard_normal((sq, c["hq"], d)).astype(np.float32),
    )
    if c.get("sink"):
        arrays["sink"] = rng.standard_normal((c["sink"], c["hq"])).astype(np.float32)
    return arrays, _mask(c["mask"], sq, sk, rng), c


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_attn_and_gradients_match_jax(case):
    a, mask, c = _inputs(case)
    kw = dict(softmax_scale=c.get("scale"), softcap=c.get("softcap", 0.0))
    names = ["q", "k", "v"] + (["sink"] if "sink" in a else [])

    def jfn(*xs):
        out, lse = j_ref_attn(*xs[:3], mask, sink=xs[3] if len(xs) > 3 else None, **kw)
        return out, lse

    jx = [jnp.asarray(a[n]) for n in names]
    (jout, jlse), vjp = jax.vjp(jfn, *jx)
    jgrads = vjp((jnp.asarray(a["do"]), jnp.zeros_like(jlse)))
    px = [torch.from_numpy(a[n]).requires_grad_(True) for n in names]
    out, lse = ptesting.ref_attn(*px[:3], mask, sink=px[3] if len(px) > 3 else None, **kw)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_array_equal(np.isneginf(lse.detach().numpy()), np.isneginf(np.asarray(jlse)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **TOL)
    (out * torch.from_numpy(a["do"])).sum().backward()
    for name, t, g in zip(names, px, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=name, **TOL)
    if c["mask"] == "random":
        assert np.isneginf(lse[3].detach().numpy()).all() == ("sink" not in a)


@pytest.mark.parametrize("case", ["causal", "random_gqa", "softcap"])
def test_ref_max_logits_matches_jax(case):
    a, mask, c = _inputs(case, seed=1)
    kw = dict(softmax_scale=c.get("scale"), softcap=c.get("softcap", 0.0))
    want = j_ref_max_logits(jnp.asarray(a["q"]), jnp.asarray(a["k"]), mask, **kw)
    got = ptesting.ref_max_logits(torch.from_numpy(a["q"]), torch.from_numpy(a["k"]), mask, **kw)
    assert got.shape == (c["hq"],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ref_attn_float64_by_default():
    """The arithmetic is float64 unless asked otherwise; out takes q's
    dtype, lse float32."""
    a, mask, _ = _inputs("causal")
    q, k, v = (torch.from_numpy(a[n]).double() for n in ("q", "k", "v"))
    out64, lse = ptesting.ref_attn(q, k, v, mask)
    out32, _ = ptesting.ref_attn(q.float(), k.float(), v.float(), mask, compute_dtype=torch.float32)
    assert out64.dtype == torch.float64 and lse.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), atol=1e-5, rtol=1e-5)


GT_MASKS = {
    "causal": ([[0, 256]], [[0, 256]], [1]),
    "varlen": ([[0, 100], [100, 256]], [[0, 100], [100, 256]], [1, 0]),
    "prefix": ([[0, 64], [64, 256]], [[0, 64], [0, 256]], [0, 1]),
}


@pytest.mark.parametrize("chunk", [16, 48])
@pytest.mark.parametrize("name", sorted(GT_MASKS))
def test_gt_dispatcher_areas_match_jax(name, chunk):
    qr, kr, types = GT_MASKS[name]
    port = ptesting.GroundTruthDispatcher(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr),
        [AttnMaskType.from_int_type(t) for t in types], 256)
    ref = JGT(JRanges.from_ranges(qr), JRanges.from_ranges(kr),
              [JType.from_int_type(t) for t in types], 256)
    np.testing.assert_array_equal(port.chunk_areas(chunk), ref.chunk_areas(chunk))
    n = -(-256 // chunk)
    parts = [list(range(r, n, 3)) for r in range(3)]
    assert port.rank_areas(parts, chunk) == ref.rank_areas(parts, chunk)
    assert int(port.chunk_areas(chunk).sum()) == int(port.mask.sum())


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("strategy", ["constant", "sequential", "random", "heuristic"])
def test_flag_generator_sequences_match_jax(strategy, seed):
    assert pflags.FLAG_SPACE == jflags.FLAG_SPACE
    got = list(pflags.FlagCombGenerator(strategy, seed=seed, max_combos=12))
    want = list(jflags.FlagCombGenerator(strategy, seed=seed, max_combos=12))
    assert got == want and got


def test_flag_generator_rejects_an_unknown_strategy():
    with pytest.raises(ValueError):
        list(pflags.FlagCombGenerator("exhaustive"))


def test_with_flags_sets_and_restores(monkeypatch):
    monkeypatch.setenv("MAGI_ATTENTION_RANGE_MERGE", "1")
    monkeypatch.delenv("MAGI_ATTENTION_FFA_AUTO_TILE", raising=False)
    with ptesting.with_flags({"MAGI_ATTENTION_RANGE_MERGE": None, "MAGI_ATTENTION_FFA_AUTO_TILE": "1"}):
        assert "MAGI_ATTENTION_RANGE_MERGE" not in os.environ
        assert os.environ["MAGI_ATTENTION_FFA_AUTO_TILE"] == "1"
    assert os.environ["MAGI_ATTENTION_RANGE_MERGE"] == "1"
    assert "MAGI_ATTENTION_FFA_AUTO_TILE" not in os.environ


def test_precompile_warms_the_plans_ffa_attn_takes():
    from magiattention_tpu_torch.kernels import ffa_plan

    cfgs = [
        dict(q_ranges=[[0, 384]], k_ranges=[[0, 384]], attn_type_map=[1], seqlen_q=384,
             seqlen_k=384, head_dim=64),
        dict(q_ranges=[[0, 100], [100, 320]], k_ranges=[[0, 100], [100, 320]],
             attn_type_map=[0, 1], seqlen_q=320, seqlen_k=320, head_dim=128),
    ]
    ffa_plan._cached_plan.cache_clear()
    assert ptesting.precompile_ffa(cfgs, device="cpu") == 2
    warm = ffa_plan._cached_plan.cache_info()
    assert warm.misses >= 2
    # the same lookups hit now
    ptesting.precompile_ffa(cfgs, device="cpu")
    again = ffa_plan._cached_plan.cache_info()
    assert again.misses == warm.misses and again.hits > warm.hits


def test_precompile_ffa_runs_on_the_card_unless_asked(monkeypatch):
    """With no device named, ``precompile_ffa`` runs on the card, as every
    entry point does: without one it raises rather than warm only the
    plans."""
    cfg = dict(q_ranges=[[0, 128]], k_ranges=[[0, 128]], attn_type_map=[1], seqlen_q=128,
               seqlen_k=128, head_dim=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptesting.precompile_ffa([cfg])
    assert ptesting.precompile_ffa([cfg], device="cpu") == 1


def test_precompile_kernels_raises_typed_without_nvcc(monkeypatch):
    from magiattention_tpu_torch.kernels import _build

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "library_path", lambda name: _build.BUILD_DIR / "absent" / name)
    with pytest.raises(_build.KernelBuildError):
        ptesting.precompile_kernels()
