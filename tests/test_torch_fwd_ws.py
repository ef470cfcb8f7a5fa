"""The warp-specialised bf16 forward (``csrc/ffa_fwd_ws.cuh``: B1 at 128 x
128, B2 at two heads of 64 x 128, head dims 64 and 128) on the CPU.

The kernel runs on the card only (``chip_smoke.py``'s ``tensor_cores``,
``ffa_fwd``, ``ffa_fwd_gqa``, ``tiles``, ``d256_kernels`` and ``fwd_ws``
phases); here:

- its bf16 arithmetic in plain PyTorch: per (64-row consumer block, work
  item of the plan at the card's tiles), S in float32, the online softmax
  in the exp2 domain in the item order, P rounded to bf16 before P V, O
  rescaled by each item's alpha. It holds against the JAX package's
  ``ffa_attn`` forward (Pallas, interpret mode) on the same numpy inputs
  within chip_smoke.py's bf16 gates (atol 2e-2, rel-norm 1e-2; lse 1e-5)
  on a causal mask, a varlen mask with uncovered rows (out exactly 0, lse
  -inf), a sink window's global tokens, and softcap 30;
- each instance's shared memory: ``utils/mem_budget.py`` against the
  header's ``Smem`` layout (read from the source) and the opt-in limit;
- the card's default forward tiles: ``card_fwd_params`` moves a bf16
  d-64/128 forward planned at 64 x 64 to the body's tiles and nothing else,
  ranks below every explicit choice, leaves the backward's tiles as they
  were, and only the card's path applies it (CPU plans and params stay
  the JAX package's).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magiattention_tpu.kernels import ffa as jffa
from magiattention_tpu_torch.kernels import ffa as tffa
from magiattention_tpu_torch.kernels.ffa_plan import IS_FULL, KE, KS, QE, QS, get_ffa_plan
from magiattention_tpu_torch.utils import mem_budget
from tests.test_torch_tensor_cores import _sink_window
from tests.torch_port_cases import MASKS, _typed

CSRC = Path(tffa.__file__).resolve().parent.parent / "csrc"
BQ, BK = mem_budget.WS_FWD_TILES
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _ws_forward(q, k, v, qr, kr, lo, hi, scale, softcap):
    """The warp-specialised body's arithmetic over the plan at (BQ, BK):
    each consumer's 64 rows walk their q tile's work items in run order.
    Returns (out bf16, lse float32)."""
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    g = hq // hk
    plan = get_ffa_plan(qr, kr, lo, hi, sq, sk, BQ, BK)
    qf, kf, vf = (t.float() for t in (q, k, v))
    out = torch.zeros(sq, hq, d, dtype=torch.bfloat16)
    lse = torch.full((sq, hq), float("-inf"))
    rows_all = torch.arange(sq)[:, None]
    cols_all = torch.arange(sk)[None, :]
    qk_scale = scale if softcap > 0 else scale * LOG2E
    for qt in range(plan.num_q_tiles):
        items = [w for w in range(plan.run_ptr[qt], plan.run_ptr[qt + 1])
                 if plan.meta[w, QE] > plan.meta[w, QS] and plan.meta[w, KE] > plan.meta[w, KS]]
        for h in range(hq):
            for r0 in range(qt * BQ, min(qt * BQ + BQ, sq), 64):  # a consumer's rows
                r1 = min(r0 + 64, sq)
                acc = torch.zeros(r1 - r0, d)
                m = torch.full((r1 - r0,), float("-inf"))
                l_ = torch.zeros(r1 - r0)
                for w in items:
                    qs, qe, ks, ke, dlo, dhi = (int(x) for x in plan.meta[w, :6])
                    k0 = int(plan.work_kt[w]) * BK
                    k1 = min(k0 + BK, sk)
                    x = qf[r0:r1, h] @ kf[k0:k1, h // g].T * qk_scale
                    if softcap > 0:
                        x = softcap * torch.tanh(x / softcap) * LOG2E
                    rr, cc = rows_all[r0:r1], cols_all[:, k0:k1]
                    live = (rr >= qs) & (rr < qe) & (cc >= ks) & (cc < ke) & (cc - rr >= dlo) & (cc - rr <= dhi)
                    if not plan.meta[w, IS_FULL]:
                        x = torch.where(live, x, float("-inf"))
                    m_new = torch.maximum(m, x.max(1).values)
                    m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(x - m_use[:, None])
                    l_ = l_ * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p.bfloat16().float() @ vf[k0:k1, h // g]
                    m = m_new
                empty = l_ == 0
                o = torch.where(empty[:, None], 0.0, acc / torch.where(empty, 1.0, l_)[:, None])
                out[r0:r1, h] = o.bfloat16()
                lse[r0:r1, h] = torch.where(empty, float("-inf"), (m + torch.log2(l_)) * LN2)
    return out, lse


def _fwd_masks():
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
    """The body's arithmetic against the JAX package's ffa_attn forward on
    the same numpy inputs (bf16-rounded, float32 on the JAX side) within
    the bf16 gates; rows no slice covers give out 0 and lse -inf."""
    qr, kr, lo, hi, sq, sk = _fwd_masks()[mask]
    hq, hk = 4, 2
    rng = np.random.default_rng(27 + d)
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
        for shape in ((sq, hq, d), (sk, hk, d), (sk, hk, d))
    )
    scale = d ** -0.5
    jout, jlse = jffa.ffa_attn(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), qr, kr,
                               softmax_scale=scale, softcap=softcap, d_lo=lo, d_hi=hi)
    jout, jlse = torch.from_numpy(np.array(jout)).double(), torch.from_numpy(np.array(jlse))
    out, lse = _ws_forward(q, k, v, qr, kr, lo, hi, scale, softcap)
    a = out.double()
    assert (a - jout).abs().max().item() <= 2e-2
    assert ((a - jout).norm() / jout.norm()).item() <= 1e-2
    assert torch.equal(torch.isneginf(lse), torch.isneginf(jlse))
    fin = torch.isfinite(jlse)
    assert (lse[fin] - jlse[fin]).abs().max().item() <= 1e-5
    if mask == "uncovered":
        empty = torch.isneginf(jlse)
        assert empty.any() and not out[empty].float().any()


def _header_smem(d: int, bk: int) -> int:
    """``fwd_ws::Smem<D, BK>::bytes`` evaluated from the header's text."""
    src = (CSRC / "ffa_fwd_ws.cuh").read_text()
    body = src[src.index("struct Smem {"):]
    body = body[:body.index("};")]
    env = {"D": d, "BK": bk}
    for name, expr in re.findall(r"static constexpr \w+ (\w+) =\s*([^;]+);", body):
        env[name] = eval(" ".join(expr.split()).replace("/", "//"), {}, env)
    return env["bytes"]


@pytest.mark.parametrize("d", [64, 128])
def test_ws_smem_matches_the_header(d):
    """Each warp-specialised instance's shared memory, as the guards and K1
    model it (B1 at BQ x BK, B2 at two heads of BQ / 2 x BK), is the
    header's layout, within the opt-in limit; the instance is compiled and
    runs one CTA an SM."""
    want = _header_smem(d, BK)
    assert mem_budget.fwd_smem_bytes(d, BQ, BK, 2) == want <= mem_budget.SMEM_PER_CTA
    assert mem_budget.fwd_smem_bytes(d, BQ // 2, BK, 2, heads=2) == want
    assert mem_budget.ws_fwd(d, BQ, BK) and mem_budget.ws_fwd(d, BQ // 2, BK, heads=2)
    assert (BQ, BK) in mem_budget.compiled_tiles("fwd", 2, d)
    assert (BQ // 2, BK) in mem_budget.compiled_tiles("fwd_gqa", 2, d, heads=2)
    assert mem_budget.ctas_per_sm("fwd", d, BQ, BK) == 1
    if d == 128:
        assert want == 230_496
    # every other instance keeps ffa_fwd_tc.cuh's body and formula
    for bq, bk, heads in ((64, 64, 1), (128, 64, 1), (64, 128, 1), (64, 64, 2), (64, 64, 4)):
        assert not mem_budget.ws_fwd(d, bq, bk, heads)
        tc = heads * (bq // 64) * 64 * d * 2 + 2 * bk * 2 * d * 2 + 16 * heads * (bq // 64) + 1024
        assert mem_budget.fwd_smem_bytes(d, bq, bk, 2, heads) == tc
    assert not mem_budget.ws_fwd(256, BQ, BK)


def _plan(mask="causal", d=128):
    qr, kr, lo, hi, sq, sk = _fwd_masks()[mask]
    return tffa.plan_params(qr, kr, None, lo, hi, sq, sk, d, None, 0.0), sq, sk


@pytest.fixture
def clean_env(monkeypatch):
    for key in ("MAGI_ATTENTION_FFA_BLOCK_Q", "MAGI_ATTENTION_FFA_BLOCK_K",
                "MAGI_ATTENTION_FFA_BLOCK_Q_DKV", "MAGI_ATTENTION_FFA_BLOCK_K_DKV",
                "MAGI_ATTENTION_FFA_AUTO_TILE", "MAGI_ATTENTION_FFA_GQA_PACK"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_card_default_moves_the_forward_only(d, heads, clean_env):
    """bf16 at d 64/128 planned at 64 x 64: the forward runs at the body's
    tiles (B1 BQ x BK; packed, whatever its heads at 64 x 64, BQ / 2 x BK,
    where it packs two) over the same slices re-tiled, built once and kept
    on the plan; the params the caller keeps for the backward are
    untouched, and its per-pass tiles on the card are the backward's own
    (``card_bwd_params``: the warp-specialised dq and k-major tiles)."""
    (plan, params), sq, sk = _plan(d=d)
    bq = BQ if heads == 1 else BQ // 2
    got_plan, got = tffa.card_fwd_params(plan, params, d, d, 2, heads, sq, sk)
    assert (got.block_q, got.block_k) == (bq, BK)
    assert (got_plan.block_q, got_plan.block_k) == (bq, BK)
    assert tffa.fwd_pack_heads(heads, d, d, 2, bq, BK) == (1 if heads == 1 else 2)
    assert (got.num_q_tiles, got.num_k_tiles) == (got_plan.num_q_tiles, got_plan.num_k_tiles)
    assert got_plan.slices()[0].tolist() == plan.slices()[0].tolist()
    assert got == dataclasses.replace(params, block_q=bq, block_k=BK,
                                      num_q_tiles=got_plan.num_q_tiles,
                                      num_k_tiles=got_plan.num_k_tiles)
    again = tffa.card_fwd_params(plan, params, d, d, 2, heads, sq, sk)
    assert again[0] is got_plan and again[1] is got  # no host work on the next call
    assert (params.block_q, params.block_k) == (64, 64) and (plan.block_q, plan.block_k) == (64, 64)
    card_bwd = tffa.card_bwd_params(params, d, d, 2)
    assert card_bwd.dq_blocks() == mem_budget.WS_DQ_TILES
    assert card_bwd.dkv_blocks() == mem_budget.WS_DKV_TILES


@pytest.mark.parametrize("case", ["float32", "d256", "dv", "tiles", "pinned", "auto"])
def test_card_default_ranks_below_every_choice(case, clean_env):
    """Nothing moves where the body does not run (float32, d 256, d != dv)
    or where a tile was chosen: other tiles in the params (the caller's or
    the policy's), env pins, the auto-tile policy."""
    (plan, params), sq, sk = _plan()
    d, dv, itemsize, heads = 128, 128, 2, 1
    if case == "float32":
        itemsize = 4
    elif case == "d256":
        d = dv = 256
    elif case == "dv":
        dv = 64
    elif case == "tiles":
        qr, kr, lo, hi, sq, sk = _fwd_masks()["causal"]
        plan, params = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, 128, None, 0.0, 128, 64)
    elif case == "pinned":
        clean_env.setenv("MAGI_ATTENTION_FFA_BLOCK_Q", "64")
    elif case == "auto":
        clean_env.setenv("MAGI_ATTENTION_FFA_AUTO_TILE", "1")
    got = tffa.card_fwd_params(plan, params, d, dv, itemsize, heads, sq, sk)
    assert got[0] is plan and got[1] is params


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as on the card: drives the
    dispatcher's card branch without one."""

    @property
    def is_cuda(self):
        return True


def _spy_dispatch(monkeypatch, pack: bool, card: bool):
    seen = []

    def spy(name):
        def run(q, k, v, plan, params, *rest):
            seen.append((name, plan.block_q, plan.block_k, params.block_q, params.block_k))
            return torch.zeros(q.shape[0], q.shape[1], v.shape[-1]), torch.zeros(q.shape[:2])
        return run

    monkeypatch.setattr(tffa, "ffa_fwd", spy("b1"))
    monkeypatch.setattr(tffa, "ffa_fwd_gqa", spy("b2"))
    if pack:
        monkeypatch.setenv("MAGI_ATTENTION_FFA_GQA_PACK", "1")
    (plan, params), sq, sk = _plan()
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((sq, 4, 128), (sk, 2, 128), (sk, 2, 128)))
    if card:
        q, k, v = (t.as_subclass(_OnCard) for t in (q, k, v))
    tffa.ffa_fwd_dispatch(q, k, v, plan, params)
    tffa.ffa_fwd_dispatch(q, k, v, plan, params, card_tiles=False)
    return seen


@pytest.mark.parametrize("pack", [False, True])
def test_dispatch_applies_the_card_tiles_on_the_card_only(pack, clean_env):
    """``ffa_fwd_dispatch``: on the card (a tensor reporting CUDA) the
    unpacked forward runs at (BQ, BK) and the packed one at (BQ / 2, BK),
    each with matching params; CPU tensors, and the mixed dispatch's
    branches (``card_tiles=False``), keep the caller's 64 x 64 plan."""
    name = "b2" if pack else "b1"
    card = _spy_dispatch(clean_env, pack, card=True)
    bq = BQ // 2 if pack else BQ
    assert card == [(name, bq, BK, bq, BK), (name, 64, 64, 64, 64)]
    cpu = _spy_dispatch(clean_env, pack, card=False)
    assert cpu == [(name, 64, 64, 64, 64)] * 2


def test_cpu_forward_is_the_jax_packages(clean_env):
    """On CPU tensors ``ffa_attn`` never asks for the card's tiles: its plan
    and params are the JAX package's (64 x 64 unless pinned), and the
    forward matches JAX's ffa_attn."""
    qr, kr, lo, hi, sq, sk = _fwd_masks()["causal"]
    calls = []
    orig = tffa.card_fwd_params
    clean_env.setattr(tffa, "card_fwd_params", lambda *a: calls.append(a) or orig(*a))
    plan, params = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, 64, None, 0.0)
    assert (plan.block_q, plan.block_k, params.block_q, params.block_k) == (64, 64, 64, 64)
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((sq, 2, 64), (sk, 1, 64), (sk, 1, 64)))
    out, lse = tffa.ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)
    jout, jlse = jffa.ffa_attn(*(jnp.asarray(t.numpy()) for t in (q, k, v)), qr, kr, d_lo=lo, d_hi=hi)
    assert np.abs(out.detach().numpy() - np.array(jout)).max() <= 1e-5
    assert np.abs(lse.numpy() - np.array(jlse)).max() <= 1e-5
    assert calls == []
