"""The head-dim-256 instances on the CPU: the per-family column split and
what the host models of it.

At 256 the bf16 forward (B1/B2, ``csrc/ffa_fwd_tc.cuh``), dq pass (B3/B4,
``csrc/ffa_bwd_dq_tc.cuh``) and k-major backward (B5/B6, B8/B9,
``csrc/bwd_kv_tc.cuh``) write all 256 columns from one CTA and compute S
and dP once; every float32 body still splits its columns in two
128-column halves across the grid. The kernels run on the card only
(``chip_smoke.py``'s ``d256_kernels``); here: the halves per family
(``kernels/head_dims.py``), the cost model's width factor and grids at 256
(``kernels/tile_policy.py``) and the mode it picks against this card's
times, the default tiles at 256, the dq kernels' shared memory and
packing guard at 256, the packed dq route at 256 against the JAX
package's packed dq, and the new backward's bf16 arithmetic (P^T and dS^T
as hi + lo bf16 tiles, dQ from dS's hi) at d 256 against the JAX
package's ``ffa_attn`` on the same numpy inputs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import ffa as jffa
from magiattention_tpu_torch.kernels import ffa as tffa
from magiattention_tpu_torch.kernels import tile_policy as tp
from magiattention_tpu_torch.kernels.head_dims import FULL_WIDTH_KERNELS, column_halves, cta_width
from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band, types_to_bands
from magiattention_tpu_torch.utils import mem_budget
from tests.test_torch_tensor_cores import _tc_backward, _tc_forward
from tests.torch_port_cases import MASKS, _typed

KERNELS = ("fwd", "fwd_gqa", "dq", "dq_gqa", "dkv", "fused")


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_column_halves_per_family(d, kernel, itemsize):
    """At 64 and 128 no kernel splits; at 256 only the float32 bodies do
    (two 128-column halves across the grid): every bf16 FFA body, the dq
    pass included, writes all 256 columns from one CTA."""
    assert FULL_WIDTH_KERNELS == set(KERNELS)
    full = itemsize == 2
    want = 2 if d == 256 and not full else 1
    assert column_halves(d, kernel, itemsize) == want
    assert cta_width(d, kernel, itemsize) == d // want
    assert column_halves(d) == (2 if d == 256 else 1)  # no family: the split


@pytest.mark.parametrize("kernel, at_256", [("fwd", 2.0), ("fwd_gqa", 2.0), ("dkv", 1.0), ("fused", 1.0)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_width_scale_without_recompute(d, kernel, at_256):
    """A CTA's per-(item, head) time over its time at 128: d / 128 up to
    128. At 256 no product of these bodies is recomputed: a forward
    warpgroup runs S and P V at the full width (2x), and each of the two
    warpgroups of a k-major or dq CTA runs the width-128 instance's
    products (1x, on one CTA an SM): the dq pass's three, S and dP split
    by keys, dQ by column half."""
    want = d / 128 if d <= 128 else at_256
    assert tp.width_scale(d, tp.TC_PRODUCTS[kernel]) == pytest.approx(want)
    assert tp.TC_PRODUCTS["dq"] == tp.TC_PRODUCTS["dq_gqa"] == (0, 3)
    assert tp.width_scale(256, tp.TC_PRODUCTS["dq"]) == pytest.approx(1.0)


# bf16 at Gemma-2-9B's attention (chip_smoke.py's d256_kernels and
# hybrid_d256): 8192 tokens, 16 query heads, 8 kv heads; the global causal
# mask and the 4096-token sliding window
GEMMA = dict(s=8192, hq=16, hk=8)
D256_MASKS = {
    "causal": ([[0, 8192]], [[0, 8192]], [1], None),
    "window_4096": ([[0, 8192]], [[0, 8192]], [1], 4095),
}


def _gemma_plan(name, d=256, itemsize=2):
    qr, kr, types, window = D256_MASKS[name]
    qr, kr = np.array(qr, np.int32), np.array(kr, np.int32)
    lo, hi = types_to_bands(qr, kr, np.array(types, np.int32))
    if window is not None:
        lo = np.array([-window], np.int32)
    s = GEMMA["s"]
    plan, params = tffa.plan_params(qr, kr, None, lo, hi, s, s, d, None, 0.0)
    return plan, params, tffa.bwd_shape(plan, GEMMA["hq"], GEMMA["hk"], d, d, itemsize)


@pytest.mark.parametrize("name", sorted(D256_MASKS))
def test_bwd_mode_cost_at_d256(name):
    """The mode model at d 256 in bf16: every backward kernel's grid is the
    one it runs at 128 (no column halves): one CTA per (k tile, kv head)
    for the k-major kernels, per (q tile, q head) for dq; each kernel's
    modeled units are that grid's makespan on one CTA an SM at the
    width-128 per-item time (each of its two warpgroups runs the width-128
    work); and the unpinned mode is fused, the faster on the card (NVIDIA
    H100 80GB HBM3, 700.00 W, chip_smoke.py's d256_kernels: fused 7.385 ms
    against split 3.098 + 4.657 on the causal mask; modeled, split 9.18
    against fused 8.02)."""
    plan, params, s256 = _gemma_plan(name)
    s128 = _gemma_plan(name, d=128)[2]
    assert (tp._halves(s256, "dq"), tp._halves(s256, "dkv")) == (1, 1)
    assert (tp._halves(s128, "dq"), tp._halves(s128, "dkv")) == (1, 1)
    assert tp.kernel_units(s256) == tp.kernel_units(s128)
    grid = tp._ctas(s256.items_k, s256.hk, 1, False) * (s256.hq // s256.hk)
    for kernel in ("dkv", "fused"):
        assert tp._tc_units(s256, kernel) == tp.makespan(grid, tp.NUM_SMS), kernel
        assert tp.width_scale(256, tp.TC_PRODUCTS[kernel]) == 1.0
    grid_q = tp._ctas(s256.items_q, s256.hq, 1, True)
    assert tp._tc_units(s256, "dq") == tp.makespan(grid_q, tp.NUM_SMS)
    ms = tp.kernel_ms(s256)
    assert ms["fused"] < ms["dq"] + ms["dkv"]
    assert tffa.ffa_bwd_mode(plan, params, 256, 256, 2, GEMMA["hq"], GEMMA["hk"]) == "fused"


@pytest.mark.parametrize("itemsize", [2, 4])
def test_default_tiles_at_256(itemsize):
    """Unpinned, a d-256 call resolves the default 64 x 64 tiles for every
    pass with no per-pass override, and each pass's kernel is compiled
    there. In bf16 the forward is also compiled at 128 x 64 (two
    warpgroups a CTA), but the dq and k-major passes are not: a 128-row
    default would need per-pass tiles, which the CP runtime plans before
    it knows d, so the default stays 64 x 64, where the bf16 forward keeps
    one K/V stage and runs two one-warpgroup CTAs an SM (within 4% of 128
    x 64 on the card)."""
    qr, kr, types, _ = D256_MASKS["causal"]
    qr, kr = np.array(qr, np.int32), np.array(kr, np.int32)
    lo, hi = types_to_bands(qr, kr, np.array(types, np.int32))
    how = tffa.resolve_dispatch(qr, kr, lo, hi, 8192, 8192, 256, 256, itemsize)
    assert how.mixed is None and how.blocks == (64, 64) and not how.overrides
    for kernel in ("fwd", "dq", "dkv", "fused"):
        assert mem_budget.is_compiled(kernel, itemsize, 256, 64, 64), kernel
    assert mem_budget.is_compiled("fwd", itemsize, 256, 128, 64) == (itemsize == 2)
    for kernel in ("dq", "dkv", "fused"):
        assert not mem_budget.is_compiled(kernel, itemsize, 256, 128, 64), kernel
    # the tensor-core CTAs an SM (the bf16 bodies)
    assert mem_budget.ctas_per_sm("fwd", 256, 128, 64) == 1 and mem_budget.ctas_per_sm("fwd", 256) == 2
    assert mem_budget.warpgroups("fused", d=256) == 2 and mem_budget.ctas_per_sm("fused", 256) == 1


def test_dq_kernels_at_256():
    """B3 and B4 at 256 (csrc/ffa_bwd_dq_tc.cuh ``Smem``): the heads' Q and
    dO tiles, two K/V stages (one where two heads pack), a 64 x 64 bf16 dS
    tile a head and 1024 bytes of alignment, 64 x 64 tiles only, two
    column warpgroups and one CTA an SM; bf16 packs two heads there (four
    heads' tiles do not fit, nor a 128-row k tile), float32 none."""
    for heads, stages in ((1, 2), (2, 1)):
        want = 2 * heads * 64 * 256 * 2 + stages * 2 * 64 * 256 * 2 + heads * 64 * 64 * 2 + 1024
        assert mem_budget.dq_smem_bytes(256, heads=heads) == want
        assert tffa.dq_pack_smem_bytes(256, heads, 2) == want
    assert (mem_budget.dq_smem_bytes(256), mem_budget.dq_smem_bytes(256, heads=2)) == (205_824, 214_016)
    assert mem_budget.compiled_tiles("dq", 2, 256) == ((64, 64),)
    assert mem_budget.compiled_tiles("dq_gqa", 2, 256, 2) == ((64, 64),)
    assert mem_budget.compiled_tiles("dq_gqa", 2, 256, 4) == ()
    assert mem_budget.warpgroups("dq", d=256) == mem_budget.warpgroups("dq_gqa", heads=2, d=256) == 2
    assert mem_budget.ctas_per_sm("dq", 256) == mem_budget.ctas_per_sm("dq_gqa", 256, heads=2) == 1
    assert tffa.dq_pack_heads(2, 256, 256, 2) == 2
    assert tffa.dq_pack_heads(4, 256, 256, 2) == 2
    assert tffa.dq_pack_heads(2, 256, 256, 2, 64, 128) == 1
    assert tffa.dq_pack_heads(2, 256, 256, 4) == 1
    assert tffa.dq_pack_heads(2, 256, 192, 2) == 1  # unequal widths: no kernel packs them


@pytest.mark.parametrize("dq_blocks, ok", [((64, 64), True), ((128, 64), False), ((64, 128), False)])
def test_r5_at_256_takes_the_dq_instance(dq_blocks, ok):
    """The plan verifier's R5 at d 256 in bf16: the dq pass's 64 x 64 (its
    one compiled instance, 205,824 bytes) passes; a 128-row q or k tile,
    whose CTA would take more than 232,448 bytes, is refused."""
    from magiattention_tpu_torch.analysis import verify_plan

    report = verify_plan(tile_blocks=((64, 64), dq_blocks, (64, 64)), tile_geom=(1024, 1024, 256, 256, 2))
    assert report.ok() == ok, report.summary()
    assert ok or [v.site for v in report.errors()] == ["dq blocks"]


# 256 tokens, hq 4, hk 2: a causal document and three varlen documents
# (causal, full, causal)
DQ_MASKS = {
    "causal": _typed([[0, 256]], [[0, 256]], [1], 256, 256),
    "varlen": _typed([[0, 96], [96, 200], [200, 256]], [[0, 96], [96, 200], [200, 256]],
                     [1, 0, 1], 256, 256),
}


def _spied(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _f=fn, _n=name, **kw: calls.append(_n) or _f(*a, **kw))


@pytest.mark.parametrize("mask", sorted(DQ_MASKS))
def test_packed_dq_at_256_matches_jax(mask, monkeypatch):
    """With MAGI_ATTENTION_FFA_GQA_PACK_DQ=1 a bf16 dq pass at d 256 takes
    the packed route: ``ffa_bwd_dq_dispatch`` runs ``ffa_bwd_dq_gqa`` (B4;
    its plain version on the CPU) and not ``ffa_bwd_dq``. Its dq, from the
    JAX forward's lse and delta, is within 1e-5 of the JAX package's packed
    dq (``_ffa_bwd_dq_pallas_gqa`` in interpret mode, under the same flag
    and the split pin) on the same values: numpy inputs from a seed,
    rounded to bf16, float32 on the JAX side."""
    qr, kr, lo, hi, sq, sk = DQ_MASKS[mask]
    hq, hk, d = 4, 2, 256
    rng = np.random.default_rng(25)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
        for shape in ((sq, hq, d), (sk, hk, d), (sk, hk, d), (sq, hq, d))
    )
    monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "1")
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
    jax_calls, calls = [], []
    _spied(monkeypatch, jffa, ("_ffa_bwd_dq_pallas_gqa",), jax_calls)
    jout, jlse, jgrads = _jax_grads(*(t.float().numpy() for t in (q, k, v, do)), qr, kr, lo, hi, d ** -0.5)
    assert jax_calls == ["_ffa_bwd_dq_pallas_gqa"]

    _spied(monkeypatch, tffa, ("ffa_bwd_dq_gqa", "ffa_bwd_dq"), calls)
    plan, params = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, d, None, 0.0)
    plan_dq = tffa.bwd_plans(plan, params, sq, sk)[0]
    lse = torch.from_numpy(jlse)
    delta = (torch.from_numpy(jout) * do.float()).sum(-1)
    dq = tffa.ffa_bwd_dq_dispatch(q, k, v, do, lse, delta, plan_dq, params)
    assert calls == ["ffa_bwd_dq_gqa"]
    assert dq.dtype == torch.float32 and dq.shape == (sq, hq, d)
    np.testing.assert_allclose(dq.numpy(), jgrads[0], atol=1e-5, rtol=1e-5)


def _jax_grads(q, k, v, do, qr, kr, lo, hi, scale):
    def f(q_, k_, v_):
        return jffa.ffa_attn(q_, k_, v_, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi)

    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return np.array(out), np.array(lse), [np.array(g) for g in grads]


@pytest.mark.parametrize("mask", ["causal", "uncovered", "varlen"])
def test_d256_bf16_arithmetic_matches_jax(mask):
    """The new d-256 bodies' bf16 arithmetic, in plain PyTorch on bf16
    inputs: the forward's (P rounded to bf16 before the full-width P V),
    the k-major backward's (S^T and dP^T in float32 once, P^T and dS^T
    each as bf16 hi + lo tiles feeding dV and dK, dS's hi feeding dQ),
    against the JAX package's ffa_attn and its gradients on the same
    numpy inputs (float32), within chip_smoke.py's bf16 gates (atol 2e-2,
    rel-norm 1e-2); uncovered rows out 0, lse -inf, dq 0."""
    qr, kr, lo, hi, sq, sk = MASKS[mask]
    hq, hk, d = 4, 2, 256
    rng = np.random.default_rng(256)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
        for shape in ((sq, hq, d), (sk, hk, d), (sk, hk, d), (sq, hq, d))
    )
    scale = d ** -0.5
    mask_t = build_dense_mask_band(qr, kr, lo, hi, sq, sk, device="cpu")
    out, lse = _tc_forward(q, k, v, mask_t, scale)
    f32 = [t.float().numpy() for t in (q, k, v, do)]
    jout, jlse, jgrads = _jax_grads(*f32, qr, kr, lo, hi, scale)

    def within(got, want, what):
        a, b = got.double(), torch.from_numpy(want).double()
        assert (a - b).abs().max().item() <= 2e-2, what
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= 1e-2, what

    assert torch.equal(torch.isneginf(lse), torch.from_numpy(np.isneginf(jlse)))
    fin = np.isfinite(jlse)
    assert np.abs(lse.numpy()[fin] - jlse[fin]).max() <= 2e-2
    within(out.float(), jout, "out")
    empty = torch.isneginf(lse)
    assert not out.float()[empty].any()
    lse32 = torch.from_numpy(jlse)
    delta = (torch.from_numpy(jout) * do.float()).sum(-1)
    got = _tc_backward(q, k, v, do, lse32, delta, mask_t, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, jgrads):
        within(g, w, name)
    assert not got[0][empty].any()
    assert math.isfinite(float(got[1].abs().sum()))
