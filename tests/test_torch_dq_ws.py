"""The warp-specialised bf16 dq backward (``csrc/ffa_bwd_dq_ws.cuh``: B3 at
128 x 128, B4 at two heads of 64 x 128, head dims 64 and 128) on the CPU.

The kernel runs on the card only (``chip_smoke.py``'s ``tensor_cores``,
``ffa_bwd``, ``ffa_bwd_dq_gqa``, ``bwd_mode``, ``tiles``, ``deterministic``
and ``dq_ws`` phases); here:

- its bf16 arithmetic in plain PyTorch: per consumer's 64 rows, the plan's
  work items at the card's dq tiles in run order, each item's 64-key
  blocks in turn, S and dP in float32, dS rounded to bf16 before dQ += dS K.
  It holds against the JAX package's ``ffa_attn`` dq (Pallas in interpret
  mode) on the same numpy inputs within chip_smoke.py's bf16 gates (atol
  2e-2, rel-norm 1e-2) on a causal mask, a varlen mask with uncovered rows
  (dq exactly 0), a sink window's global tokens and softcap 30, at d 64
  and 128;
- each instance's shared memory: ``utils/mem_budget.py`` against the
  header's ``Smem`` layout (read from the source) and the opt-in limit;
- the card's default dq tiles: ``card_bwd_params`` moves a bf16 d-64/128
  backward's dq pass to the body's tiles (the packed dq to a q tile of half
  the rows), ranks below every explicit choice, and only the card's path
  applies it (CPU plans and params stay the JAX package's);
- the backward-mode cost model prices the dq instance that runs.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import ffa as jffa
from magiattention_tpu_torch.kernels import ffa as tffa
from magiattention_tpu_torch.kernels import tile_policy
from magiattention_tpu_torch.kernels.ffa_plan import KE, KS, QE, QS, get_ffa_plan
from magiattention_tpu_torch.utils import mem_budget
from tests.test_torch_tensor_cores import _sink_window
from tests.torch_port_cases import MASKS, _typed

CSRC = Path(tffa.__file__).resolve().parent.parent / "csrc"
BQ, BK = mem_budget.WS_DQ_TILES
LOG2E = 1.4426950408889634


def _ws_dq(q, k, v, do, lse, delta, qr, kr, lo, hi, scale, softcap, bq=BQ):
    """The warp-specialised body's arithmetic over the plan at (bq, BK):
    each consumer's 64 rows walk their q tile's work items in run order,
    64 keys at a time. Returns dq float32."""
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    g = hq // hk
    plan = get_ffa_plan(qr, kr, lo, hi, sq, sk, bq, BK)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.zeros(sq, hq, d)
    rows_all = torch.arange(sq)[:, None]
    cols_all = torch.arange(sk)[None, :]
    for qt in range(plan.num_q_tiles):
        items = [w for w in range(plan.run_ptr[qt], plan.run_ptr[qt + 1])
                 if plan.meta[w, QE] > plan.meta[w, QS] and plan.meta[w, KE] > plan.meta[w, KS]]
        for h in range(hq):
            kv = h // g
            for r0 in range(qt * bq, min(qt * bq + bq, sq), 64):  # a consumer's rows
                r1 = min(r0 + 64, sq)
                acc = torch.zeros(r1 - r0, d)
                row_lse = lse[r0:r1, h, None]
                for w in items:
                    qs, qe, ks, ke, dlo, dhi = (int(x) for x in plan.meta[w, :6])
                    for k0 in range(int(plan.work_kt[w]) * BK, min((int(plan.work_kt[w]) + 1) * BK, sk), 64):
                        k1 = min(k0 + 64, sk)
                        s = qf[r0:r1, h] @ kf[k0:k1, kv].T
                        rr, cc = rows_all[r0:r1], cols_all[:, k0:k1]
                        live = ((rr >= qs) & (rr < qe) & (cc >= ks) & (cc < ke) & (cc - rr >= dlo)
                                & (cc - rr <= dhi) & torch.isfinite(row_lse))
                        if softcap > 0:
                            th = torch.tanh(s * scale / softcap)
                            p = torch.exp(softcap * th - torch.where(live, row_lse, 0.0))
                            dcap = 1 - th * th
                        else:
                            p = torch.exp2(s * (scale * LOG2E) - torch.where(live, row_lse, 0.0) * LOG2E)
                            dcap = 1.0
                        p = torch.where(live, p, 0.0)
                        ds = p * (dof[r0:r1, h] @ vf[k0:k1, kv].T - delta[r0:r1, h, None]) * dcap
                        block = ds.bfloat16().float() @ kf[k0:k1, kv]
                        assert not block[~live.any(1)].any()  # a masked row adds exact zeros
                        acc += block
                dq[r0:r1, h] = acc * scale
    return dq


def _jax_dq(q, k, v, do, qr, kr, lo, hi, scale, softcap):
    def f(q_):
        return jffa.ffa_attn(q_, k_, v_, qr, kr, softmax_scale=scale, softcap=softcap,
                             d_lo=lo, d_hi=hi)

    k_, v_ = jnp.asarray(k), jnp.asarray(v)
    (out, lse), vjp = jax.vjp(f, jnp.asarray(q))
    (dq,) = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return np.array(out), np.array(lse), np.array(dq)


def _dq_masks():
    qr, kr, types = _sink_window(256)
    return {
        "causal": _typed([[0, 256]], [[0, 256]], [1], 256, 256),
        "uncovered": MASKS["uncovered"],
        "sink_window": _typed(qr, kr, types, 256, 256),
    }


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask, softcap", [
    ("causal", 0.0), ("uncovered", 0.0), ("sink_window", 0.0), ("causal", 30.0),
])
def test_ws_bf16_arithmetic_matches_jax(mask, softcap, d):
    """The body's arithmetic (B3's 128-row q tiles and B4's 64-row ones
    alike) against the JAX package's ffa_attn dq on the same numpy inputs
    (bf16-rounded, float32 on the JAX side) within the bf16 gates; dq of
    an uncovered row exactly 0."""
    qr, kr, lo, hi, sq, sk = _dq_masks()[mask]
    hq, hk = 4, 2
    rng = np.random.default_rng(28 + d)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
        for shape in ((sq, hq, d), (sk, hk, d), (sk, hk, d), (sq, hq, d))
    )
    scale = d ** -0.5
    jout, jlse, jdq = _jax_dq(*(t.float().numpy() for t in (q, k, v, do)), qr, kr, lo, hi,
                              scale, softcap)
    lse = torch.from_numpy(jlse)
    delta = (torch.from_numpy(jout) * do.float()).sum(-1)
    want = torch.from_numpy(jdq).double()
    for bq in (BQ, BQ // 2):
        got = _ws_dq(q, k, v, do, lse, delta, qr, kr, lo, hi, scale, softcap, bq).double()
        assert (got - want).abs().max().item() <= 2e-2
        assert ((got - want).norm() / want.norm()).item() <= 1e-2
        uncovered = torch.isneginf(lse).all(1)
        if mask == "uncovered":
            assert uncovered.any()
        assert not got[uncovered].any()


def _header_smem(d: int, bk: int) -> int:
    """``dq_ws::Smem<D, BK>::bytes`` evaluated from the header's text."""
    src = (CSRC / "ffa_bwd_dq_ws.cuh").read_text()
    body = src[src.index("struct Smem {"):]
    body = body[:body.index("};")]
    env = {"D": d, "BK": bk}
    for name, expr in re.findall(r"static constexpr \w+ (\w+) =\s*([^;]+);", body):
        env[name] = eval(" ".join(expr.split()).replace("/", "//"), {}, env)
    return env["bytes"]


@pytest.mark.parametrize("d", [64, 128])
def test_ws_smem_matches_the_header(d):
    """Each warp-specialised instance's shared memory, as the guards, K1 and
    R5 model it (B3 at BQ x BK, B4 at two heads of BQ / 2 x BK), is the
    header's layout, within the opt-in limit; the instance is compiled and
    runs one CTA an SM."""
    want = _header_smem(d, BK)
    assert mem_budget.dq_smem_bytes(d, BQ, BK, 2) == want <= mem_budget.SMEM_PER_CTA
    assert mem_budget.dq_smem_bytes(d, BQ // 2, BK, 2, heads=2) == want
    assert tffa.dq_pack_smem_bytes(d, 2, 2, BQ // 2, BK) == want
    assert mem_budget.ws_dq(d, BQ, BK) and mem_budget.ws_dq(d, BQ // 2, BK, heads=2)
    assert (BQ, BK) in mem_budget.compiled_tiles("dq", 2, d)
    assert (BQ // 2, BK) in mem_budget.compiled_tiles("dq_gqa", 2, d, heads=2)
    assert tffa.dq_pack_heads(8, d, d, 2, BQ // 2, BK) == 2
    assert mem_budget.ctas_per_sm("dq", d, BQ, BK) == 1
    assert mem_budget.ctas_per_sm("dq_gqa", d, BQ // 2, BK, 2) == 1
    if d == 128:
        assert want == 197_696
    # every other instance keeps ffa_bwd_dq_tc.cuh's body and formula
    for bq, bk, heads in ((64, 64, 1), (128, 64, 1), (64, 128, 1), (64, 64, 2)):
        assert not mem_budget.ws_dq(d, bq, bk, heads)
        tc = 2 * heads * bq * d * 2 + 2 * 2 * bk * d * 2 + 1024
        assert mem_budget.dq_smem_bytes(d, bq, bk, 2, heads) == tc
    assert not mem_budget.ws_dq(256, BQ, BK) and not mem_budget.ws_dq(256, BQ // 2, BK, 2)
    assert mem_budget.dq_smem_bytes(128, 64, 64, 2) == 99_328


@pytest.mark.parametrize("d", [64, 128])
def test_k1_and_r5_know_the_instances(d):
    """The kernel checker's K1 queries each dq library's warp-specialised
    instance with the header's figure, and the verifier's R5 accepts the
    card's dq tiles (B3's and B4's) as compiled instances within the
    opt-in limit."""
    from magiattention_tpu_torch.analysis import kernel_check, verifier
    from magiattention_tpu_torch.analysis.violation import VerifyReport

    want = _header_smem(d, BK)
    got = {(i.library, i.args): i.model for i in kernel_check.smem_instances(("ffa_bwd_dq", "ffa_bwd_dq_gqa"))}
    assert got[("ffa_bwd_dq", (d, BQ, BK, 1))] == want
    assert got[("ffa_bwd_dq_gqa", (d, 2, BQ // 2, BK, 1))] == want
    report = VerifyReport()
    kernel_check.check_k1(report)
    assert report.ok(), report.summary()
    for dq_blocks in ((BQ, BK), (BQ // 2, BK)):
        report = VerifyReport()
        verifier.check_tiles(report, (64, 64), 8192, 8192, dq_blocks=dq_blocks, head_dim=d,
                             head_dim_v=d, itemsize=2)
        assert report.ok(), report.summary()


def _params(block_q=64, block_k=64, **kw):
    return tffa.FFAParams(num_q_tiles=4, num_k_tiles=4, block_q=block_q, block_k=block_k,
                          softmax_scale=0.125, softcap=0.0, **kw)


@pytest.fixture
def clean_env(monkeypatch):
    for key in ("MAGI_ATTENTION_FFA_BLOCK_Q", "MAGI_ATTENTION_FFA_BLOCK_K",
                "MAGI_ATTENTION_FFA_BLOCK_Q_DQ", "MAGI_ATTENTION_FFA_BLOCK_K_DQ",
                "MAGI_ATTENTION_FFA_BLOCK_Q_DKV", "MAGI_ATTENTION_FFA_BLOCK_K_DKV",
                "MAGI_ATTENTION_FFA_AUTO_TILE", "MAGI_ATTENTION_FFA_GQA_PACK_DQ",
                "MAGI_ATTENTION_BACKEND_FFA_BWD", "MAGI_ATTENTION_FFA_FUSED_BWD",
                "MAGI_ATTENTION_DETERMINISTIC_MODE"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_card_default_moves_the_dq_pass(d, pack, group, clean_env):
    """bf16 at d 64/128 with the default tiles: on the card the dq pass runs
    at (BQ, BK), or, packed (the flag, a group that packs two heads), at
    (BQ / 2, BK), the same k tile; the k-major pass at its own card tile;
    the forward's tiles stay 64 x 64."""
    if pack:
        clean_env.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "1")
    got = tffa.card_bwd_params(_params(), d, d, 2, group)
    packs = pack and group > 1
    assert got.dq_blocks() == ((BQ // 2 if packs else BQ), BK)
    assert got.dkv_blocks() == mem_budget.WS_DKV_TILES
    assert (got.block_q, got.block_k) == (64, 64)
    bq, bk = got.dq_blocks()
    assert tffa._use_gqa_pack_dq(group, d, d, 2, bq, bk) == (2 if packs else 1)


@pytest.mark.parametrize("case", [
    "float32", "d256", "dv", "tiles", "own_dq", "own_dkv", "pinned", "pinned_dq", "pinned_dkv", "auto",
])
def test_card_default_ranks_below_every_choice(case, clean_env):
    """Nothing moves where the bodies do not run (float32, d 256, d != dv)
    or where a tile was chosen: other forward tiles, a per-pass tile in the
    params (either pass), env pins (forward, dq or k-major pass), the
    auto-tile policy."""
    d, dv, itemsize, params = 128, 128, 2, _params()
    if case == "float32":
        itemsize = 4
    elif case == "d256":
        d = dv = 256
    elif case == "dv":
        dv = 64
    elif case == "tiles":
        params = _params(128, 64)
    elif case == "own_dq":
        params = _params(block_q_dq=128, block_k_dq=64)
    elif case == "own_dkv":
        params = _params(block_q_dkv=128, block_k_dkv=64)
    elif case == "pinned":
        clean_env.setenv("MAGI_ATTENTION_FFA_BLOCK_K", "64")
    elif case == "pinned_dq":
        clean_env.setenv("MAGI_ATTENTION_FFA_BLOCK_Q_DQ", "64")
    elif case == "pinned_dkv":
        clean_env.setenv("MAGI_ATTENTION_FFA_BLOCK_K_DKV", "64")
    elif case == "auto":
        clean_env.setenv("MAGI_ATTENTION_FFA_AUTO_TILE", "1")
    assert tffa.card_bwd_params(params, d, dv, itemsize, 2) is params


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as on the card: drives the
    backward's card branch without one."""

    @property
    def is_cuda(self):
        return True


def _split_backward(monkeypatch, pack: bool, card: bool):
    """The (kernel, dq plan tiles) the split backward's dq pass runs, with
    the kernels replaced by recorders."""
    seen = []

    def dq(name):
        def run(q, k, v, do, lse, delta, plan, params):
            seen.append((name, plan.block_q, plan.block_k))
            return torch.zeros(q.shape, dtype=torch.float32)
        return run

    monkeypatch.setattr(tffa, "ffa_bwd_dq", dq("b3"))
    monkeypatch.setattr(tffa, "ffa_bwd_dq_gqa", dq("b4"))
    monkeypatch.setattr(tffa, "ffa_bwd_dkv", lambda q, k, v, *a: (torch.zeros(k.shape),) * 2)
    monkeypatch.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "split")
    if pack:
        monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "1")
    qr, kr, lo, hi, sq, sk = _dq_masks()["causal"]
    plan, params = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, 128, None, 0.0)
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                   for s in ((sq, 4, 128), (sk, 2, 128), (sk, 2, 128), (sq, 4, 128)))
    lse, delta = torch.zeros(sq, 4), torch.zeros(sq, 4)
    if card:
        q, k, v, do = (t.as_subclass(_OnCard) for t in (q, k, v, do))
    tffa.ffa_bwd(q, k, v, do, lse, delta, plan, params)
    return seen


@pytest.mark.parametrize("pack", [False, True])
def test_backward_runs_the_card_tiles_on_the_card_only(pack, clean_env):
    """``ffa_bwd`` (split): on the card (tensors reporting CUDA) the dq pass
    runs B3 at (BQ, BK), or with the pack flag B4 at (BQ / 2, BK); CPU
    tensors run it at the caller's 64 x 64 plan (the JAX package's)."""
    name, bq = ("b4", BQ // 2) if pack else ("b3", BQ)
    assert _split_backward(clean_env, pack, card=True) == [(name, bq, BK)]
    assert _split_backward(clean_env, pack, card=False) == [(name, 64, 64)]


def test_mode_model_prices_the_instance_that_runs(clean_env):
    """On the card the mode model reads the dq pass at the card's tiles (its
    shape's q-major runs at BQ x BK, one CTA an SM, the warp-specialised
    constants), the packed dq at BQ / 2 x BK with two heads a CTA; a dq
    pass off those tiles takes the cp.async body's constants."""
    from tests.test_torch_tensor_cores import BWD_MODE_MASKS

    qr, kr, types, sq, sk, hq, hk, _ = BWD_MODE_MASKS["train_docs_8192_bf16"]
    plan, params = tffa.plan_params(qr, kr, types, None, None, sq, sk, 128, None, 0.0)
    for pack in (False, True):
        if pack:
            clean_env.setenv("MAGI_ATTENTION_FFA_GQA_PACK_DQ", "1")
        card = tffa.card_bwd_params(params, 128, 128, 2, hq // hk)
        plan_dq, plan_dkv = tffa.bwd_plans(plan, card, sq, sk)
        heads = tffa._use_gqa_pack_dq(hq // hk, 128, 128, 2, plan_dq.block_q, plan_dq.block_k)
        kern = "dq_gqa" if pack else "dq"
        assert (plan_dq.block_q, plan_dq.block_k, heads) == ((BQ // 2, BK, 2) if pack else (BQ, BK, 1))
        shape = tffa.bwd_shape(plan_dq, hq, hk, 128, 128, 2, plan_dkv)
        assert tile_policy._ws_body(shape, kern)
        assert tile_policy._tc_item_us(shape, kern) == tile_policy.TC_ITEM_US[kern]
        assert (plan_dq.block_q, plan_dq.block_k) == tile_policy.TC_TILES[kern]
        assert tile_policy.TC_CTAS_PER_SM[kern] == 1
        assert tile_policy.tile_area(shape, kern) == BQ * BK / (2 if pack else 1) / 4096
        modeled = tile_policy.kernel_ms(shape, heads)["dq"]
        assert 0 < modeled < tile_policy.kernel_ms(tffa.bwd_shape(plan, hq, hk, 128, 128, 2), heads)["dq"]
    # off the card's tiles: the cp.async body's constants
    shape = tffa.bwd_shape(plan, hq, hk, 128, 128, 2)
    assert not tile_policy._ws_body(shape, "dq")
    assert tile_policy._tc_item_us(shape, "dq") == tile_policy.TC_CPASYNC_ITEM_US["dq"]


# chip_smoke.py's bwd_mode masks with the dq pass at the card's tiles (this
# body) and the k-major pair at theirs: fused, dq, dk/dv ms and the packed
# dq's at its tiles where the phase times it (NVIDIA H100 80GB HBM3,
# 700.00 W; fused and dk/dv from the run of the k-major body's second form,
# the pass under the products and ping-pong)
WS_DQ_MS = {
    "causal_8192_bf16": dict(fused=2.546207904815674, dq=0.7545920014381409, dkv=1.7542400360107422),
    "varlen_8192_bf16": dict(fused=0.9522240161895752, dq=0.29360000292460126, dkv=0.6452479958534241),
    "train_docs_8192_bf16": dict(fused=2.892224073410034, dq=0.7912960052490234,
                                 dkv=1.9269440174102783, dq_gqa=0.774616003036499),
    "sink_window_8192_bf16": dict(fused=2.678208112716675, dq=0.30547199249267576,
                                  dkv=1.9240000247955322, dq_gqa=0.26320639848709104),
}
# how close the one-constant model lands to each dq time: the sink
# window's short runs (2-3 items, latency the model does not price) are
# 31% slower than it, the other masks within 7%
DQ_FIT = {"causal_8192_bf16": 0.07, "varlen_8192_bf16": 0.07, "train_docs_8192_bf16": 0.07,
          "sink_window_8192_bf16": 0.31}


def _card_shape(name, pack=False):
    from tests.test_torch_tensor_cores import BWD_MODE_MASKS, _bwd_mode_plan

    from magiattention_tpu_torch.env.general import scoped_env

    plan, params, _ = _bwd_mode_plan(name)
    *_, sq, sk, hq, hk, itemsize = BWD_MODE_MASKS[name]
    with scoped_env({"MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1" if pack else "0"}):
        card = tffa.card_bwd_params(params, 128, 128, itemsize, hq // hk)
    plan_dq, plan_dkv = tffa.bwd_plans(plan, card, sq, sk)
    return plan, card, tffa.bwd_shape(plan_dq, hq, hk, 128, 128, itemsize, plan_dkv)


@pytest.mark.parametrize("kernel", ["dq", "dq_gqa"])
def test_ws_constants_are_the_fit(kernel):
    """The warp-specialised dq constants are what ``calibrate_tc`` fits to
    the times measured at the card's tiles (the packed dq at two heads a
    CTA, at the two masks that time it), and the model lands near each."""
    names = [n for n in WS_DQ_MS if kernel in WS_DQ_MS[n]]
    heads = 2 if kernel == "dq_gqa" else 1
    shapes = [_card_shape(n, pack=kernel == "dq_gqa")[2] for n in names]
    times = [WS_DQ_MS[n][kernel] for n in names]
    got = tile_policy.calibrate_tc(kernel, shapes, times, dq_heads_per_cta=heads)
    assert tile_policy.TC_ITEM_US[kernel] == pytest.approx(got, rel=2e-3)
    for n, s, t in zip(names, shapes, times):
        assert tile_policy._ws_body(s, kernel)
        assert tile_policy.kernel_ms(s, heads)["dq"] == pytest.approx(t, rel=DQ_FIT[n]), n


@pytest.mark.parametrize("name", sorted(WS_DQ_MS))
def test_mode_model_picks_the_faster_mode(name, clean_env):
    """Unpinned, with both passes at the card's tiles, ``ffa_bwd_mode``
    picks the mode the card timed faster there (split at every mask: the
    dq pass's body makes the split pair 1-12% faster than the fused
    kernel), or either where the two are within 5%."""
    from tests.test_torch_tensor_cores import BWD_MODE_MASKS, _accepted

    plan, card, _ = _card_shape(name)
    *_, hq, hk, itemsize = BWD_MODE_MASKS[name]
    t = WS_DQ_MS[name]
    got = tffa.ffa_bwd_mode(plan, card, 128, 128, itemsize, hq, hk)
    assert got in _accepted(t["fused"], t["dq"] + t["dkv"])

