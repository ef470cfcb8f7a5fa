"""The warp-specialised bf16 k-major backward (``csrc/bwd_kv_ws.cuh``: B5/B6
and B8/B9 at 64 x 128, head dims 64 and 128) on the CPU.

The kernel runs on the card only (``chip_smoke.py``'s ``tensor_cores``,
``ffa_bwd``, ``ffa_bwd_fused``, ``tiles``, ``d256_kernels`` and ``kmajor``
phases);
here:

- its bf16 arithmetic in plain PyTorch: per (64-row q tile, 128-row k
  tile) pair, S^T and dP^T in float32, P^T and dS^T each as bf16 hi + lo
  feeding dV and dK of each 64-key half, and dQ as each consumer's half of
  the columns, a depth-128 product of dS's hi over both key halves, added
  to the workspace one step late (the fused body's order: a step's block
  is computed and added in the k tile's next step, the last one after the
  walk; rows outside the pair's live set carry exact zeros). It holds
  against the JAX package's ``ffa_attn`` gradients on the same numpy
  inputs within chip_smoke.py's bf16 gates (atol 2e-2, rel-norm 1e-2) on a
  causal mask, a varlen mask with uncovered rows, a sink window's global
  tokens and a causal mask under softcap 30; dq of an uncovered row is
  exactly 0;
- each compiled instance's shared memory: ``utils/mem_budget.py`` against
  the header's ``Smem`` layout (read from the source: the Q/dO ring's
  stages, the fused body's dS^T tiles and dq staging) and the opt-in limit;
- the routing: the instances the header sends to this body are
  ``mem_budget.ws_dkv``'s;
- the card's default k-major tile: ``card_bwd_params`` moves a bf16 d-64/128
  backward's k-major pass to 64 x 128 and nothing else, and only the
  card's path applies it (CPU plans and params stay the JAX package's);
- the backward-mode cost model prices the k-major instance that runs.
"""

import math
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
from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band
from magiattention_tpu_torch.utils import mem_budget
from tests.test_torch_tensor_cores import _hi_lo, _sink_window
from tests.torch_port_cases import MASKS, _typed

CSRC = Path(tffa.__file__).resolve().parent.parent / "csrc"
BQ, BK = mem_budget.WS_DKV_TILES


def _ws_backward(q, k, v, do, lse, delta, mask, scale, softcap=0.0):
    """The warp-specialised body's arithmetic, pair by pair of the k-major
    walk: (dq, dk, dv) float32."""
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    g = hq // hk
    qf, dof, kf, vf = (t.float() for t in (q, do, k, v))
    dq = torch.zeros(sq, hq, d)
    dk = torch.zeros(sk, hk, d)
    dv = torch.zeros(sk, hk, d)
    for k0 in range(0, sk, BK):
        k1 = min(k0 + BK, sk)
        last = None  # the last step's dq block and its place, added a step late
        for h in range(hq):
            kv = h // g
            for q0 in range(0, sq, BQ):
                q1 = min(q0 + BQ, sq)
                live = mask[q0:q1, k0:k1] & torch.isfinite(lse[q0:q1, h])[:, None]
                if not live.any():
                    continue
                x = qf[q0:q1, h] @ kf[k0:k1, kv].T * scale
                dcap = 1.0
                if softcap > 0:
                    th = torch.tanh(x / softcap)
                    x, dcap = softcap * th, 1.0 - th * th
                p = torch.where(live, torch.exp(x - torch.where(live, lse[q0:q1, h, None], 0.0)), 0.0)
                ds = p * (dof[q0:q1, h] @ vf[k0:k1, kv].T - delta[q0:q1, h, None]) * dcap
                p_hi, p_lo = _hi_lo(p)
                ds_hi, ds_lo = _hi_lo(ds)
                for c in range(0, k1 - k0, 64):  # a consumer's 64 keys
                    rows = slice(k0 + c, min(k0 + c + 64, k1))
                    cols = slice(c, c + 64)
                    dv[rows, kv] += p_hi[:, cols].T @ dof[q0:q1, h] + p_lo[:, cols].T @ dof[q0:q1, h]
                    dk[rows, kv] += ds_hi[:, cols].T @ qf[q0:q1, h] + ds_lo[:, cols].T @ qf[q0:q1, h]
                if last is not None:
                    dq[last[0]] += last[1]
                # each consumer's d / 2 columns, one product over the 128 keys
                block = torch.cat([ds_hi @ kf[k0:k1, kv, c:c + d // 2] for c in (0, d // 2)], 1)
                masked_rows = ~live.any(1)
                assert not block[masked_rows].any()  # exact zeros: the add leaves them
                last = ((slice(q0, q1), h), block)
        if last is not None:
            dq[last[0]] += last[1]
    return dq * scale, dk * scale, dv


def _jax_grads(q, k, v, do, qr, kr, lo, hi, scale, softcap=0.0):
    def f(q_, k_, v_):
        return jffa.ffa_attn(q_, k_, v_, qr, kr, softmax_scale=scale, softcap=softcap,
                             d_lo=lo, d_hi=hi)

    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return np.array(out), np.array(lse), [np.array(g) for g in grads]


def _ws_masks():
    qr, kr, types = _sink_window(256)
    causal = _typed([[0, 256]], [[0, 256]], [1], 256, 256)
    return {  # mask -> (its arrays, softcap)
        "causal": (causal, 0.0),
        "uncovered": (MASKS["uncovered"], 0.0),
        "sink_window": (_typed(qr, kr, types, 256, 256), 0.0),
        "softcap30_causal": (causal, 30.0),
    }


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask", sorted(_ws_masks()))
def test_ws_bf16_arithmetic_matches_jax(mask, d):
    """The body's arithmetic (hi + lo dK and dV per 64-key half, each
    consumer's dQ columns as one depth-128 product of dS's hi, added a
    step late) against the JAX package's ffa_attn gradients on the same
    numpy inputs (bf16-rounded, float32 on the JAX side) within the bf16
    gates; dq of an uncovered row exactly 0."""
    (qr, kr, lo, hi, sq, sk), softcap = _ws_masks()[mask]
    hq, hk = 4, 2
    rng = np.random.default_rng(26 + d)
    q, k, v, do = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
        for shape in ((sq, hq, d), (sk, hk, d), (sk, hk, d), (sq, hq, d))
    )
    scale = d ** -0.5
    jout, jlse, jgrads = _jax_grads(*(t.float().numpy() for t in (q, k, v, do)), qr, kr, lo, hi,
                                    scale, softcap)
    lse = torch.from_numpy(jlse)
    delta = (torch.from_numpy(jout) * do.float()).sum(-1)
    mask_t = build_dense_mask_band(qr, kr, lo, hi, sq, sk, device="cpu")
    got = _ws_backward(q, k, v, do, lse, delta, mask_t, scale, softcap)
    for name, a, w in zip(("dq", "dk", "dv"), got, jgrads):
        a, b = a.double(), torch.from_numpy(w).double()
        assert (a - b).abs().max().item() <= 2e-2, name
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= 1e-2, name
    uncovered = torch.isneginf(lse).all(1)
    if mask == "uncovered":
        assert uncovered.any()
    assert not got[0][uncovered].any()


def _header_smem(d: int, fused: bool, name: str = "bytes") -> int:
    """``kv_ws::Smem<D, FUSED>::<name>`` evaluated from the header's text."""
    src = (CSRC / "bwd_kv_ws.cuh").read_text()
    body = src[src.index("struct Smem {"):]
    body = body[:body.index("};")]
    env = {"D": d, "FUSED": fused, "BQ": BQ, "BK": BK}
    for var, expr in re.findall(r"static constexpr \w+ (\w+) =\s*([^;]+);", body):
        expr = re.sub(r"(\w+) \? ([^:]+) : (.+)", r"(\2 if \1 else \3)", " ".join(expr.split()))
        env[var] = eval(expr.replace("/", "//"), {}, env)
    return env[name]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_ws_smem_matches_the_header(d, fused):
    """Each compiled warp-specialised instance's shared memory, as the
    guards and K1 model it, is the header's layout, within the opt-in
    limit; the instance is compiled and runs one CTA an SM."""
    kernel = "fused" if fused else "dkv"
    want = _header_smem(d, fused)
    assert mem_budget.dkv_smem_bytes(d, BQ, BK, 2, fused=fused) == want <= mem_budget.SMEM_PER_CTA
    assert mem_budget.ws_dkv(d, BQ, BK)
    assert (BQ, BK) in mem_budget.compiled_tiles(kernel, 2, d)
    assert mem_budget.ctas_per_sm(kernel, d, BQ, BK) == 1
    assert _header_smem(d, fused, "STAGES") == mem_budget.WS_DKV_STAGES[fused]
    if d == 128:  # three Q/dO stages alone, two beside the fused dq staging
        assert want == (231_552 if fused else 166_528)
    # the other tiles and widths keep bwd_kv_tc.cuh's body and formula
    assert not mem_budget.ws_dkv(d, 64, 64) and not mem_budget.ws_dkv(256, BQ, BK)
    assert mem_budget.dkv_smem_bytes(128, 64, 64, 2, fused=True) == 108_544


def test_ws_routing_matches_the_header():
    """The bf16 instances the header's ``kv_bf16::WS`` sends to this body
    are ``mem_budget.ws_dkv``'s, at every compiled tile and width of both
    k-major kernels."""
    src = (CSRC / "bwd_kv_ws.cuh").read_text()
    expr = re.search(r"constexpr bool WS = ([^;]+);", src).group(1)
    expr = expr.replace("&&", " and ")
    seen = set()
    for kernel in ("dkv", "fused"):
        for d in (64, 128, 256):
            for bq, bk in mem_budget.compiled_tiles(kernel, 2, d):
                routed = eval(expr, {}, {"D": d, "BQ": bq, "BK": bk})
                assert routed == mem_budget.ws_dkv(d, bq, bk), (kernel, d, bq, bk)
                if routed:
                    seen.add((d, bq, bk))
    assert seen == {(d, BQ, BK) for d in mem_budget.WS_DKV_WIDTHS}


def _params(block_q=64, block_k=64, **kw):
    return tffa.FFAParams(num_q_tiles=4, num_k_tiles=4, block_q=block_q, block_k=block_k,
                          softmax_scale=0.125, softcap=0.0, **kw)


@pytest.fixture
def clean_env(monkeypatch):
    for key in ("MAGI_ATTENTION_FFA_BLOCK_Q", "MAGI_ATTENTION_FFA_BLOCK_K",
                "MAGI_ATTENTION_FFA_BLOCK_Q_DKV", "MAGI_ATTENTION_FFA_BLOCK_K_DKV",
                "MAGI_ATTENTION_FFA_AUTO_TILE"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("d", [64, 128])
def test_card_default_moves_the_kmajor_pass_only(d, clean_env):
    """bf16 at d 64/128 with the default tiles: the k-major pass runs 64 x
    128 on the card, the dq pass its own card tiles (the warp-specialised
    dq body's, tests/test_torch_dq_ws.py), and the forward keeps 64 x 64."""
    got = tffa.card_bwd_params(_params(), d, d, 2)
    assert got.dkv_blocks() == (BQ, BK)
    assert got.dq_blocks() == mem_budget.WS_DQ_TILES and (got.block_q, got.block_k) == (64, 64)


@pytest.mark.parametrize("case", ["float32", "d256", "dv", "tiles", "own_dkv", "pinned", "pinned_dkv", "auto"])
def test_card_default_ranks_below_every_choice(case, clean_env):
    """Nothing moves where the body does not run (float32, d 256, d != dv)
    or where a tile was chosen: other forward tiles, a per-pass tile in the
    params, env pins (forward or k-major pass), the auto-tile policy."""
    d, dv, itemsize, params = 128, 128, 2, _params()
    if case == "float32":
        itemsize = 4
    elif case == "d256":
        d = dv = 256
    elif case == "dv":
        dv = 64
    elif case == "tiles":
        params = _params(128, 64)
    elif case == "own_dkv":
        params = _params(block_q_dkv=128, block_k_dkv=64)
    elif case == "pinned":
        clean_env.setenv("MAGI_ATTENTION_FFA_BLOCK_Q", "64")
    elif case == "pinned_dkv":
        clean_env.setenv("MAGI_ATTENTION_FFA_BLOCK_K_DKV", "64")
    elif case == "auto":
        clean_env.setenv("MAGI_ATTENTION_FFA_AUTO_TILE", "1")
    assert tffa.card_bwd_params(params, d, dv, itemsize) is params


def test_cpu_backward_keeps_the_plan_tiles(clean_env):
    """``ffa_bwd`` on CPU tensors runs its k-major pass at the forward
    plan's tiles (the JAX package's): the card default is the card's."""
    qr, kr, lo, hi, sq, sk = MASKS["causal"]
    plan, params = tffa.plan_params(qr, kr, None, lo, hi, sq, sk, 64, None, 0.0)
    assert (params.block_q_dkv, params.block_k_dkv) == (0, 0)
    seen = []
    orig = tffa.ffa_bwd_fused

    def spy(*args):
        seen.append((args[6].block_q, args[6].block_k))
        return orig(*args)

    clean_env.setattr(tffa, "ffa_bwd_fused", spy)
    clean_env.setenv("MAGI_ATTENTION_BACKEND_FFA_BWD", "fused")
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                   for s in ((sq, 2, 64), (sk, 1, 64), (sk, 1, 64), (sq, 2, 64)))
    out, lse = tffa.sdpa_attn(q.float(), k.float(), v.float(), qr, kr, d_lo=lo, d_hi=hi)
    tffa.ffa_bwd(q, k, v, do, lse, tffa.ffa_delta_plain(out, do.float()), plan, params)
    assert seen == [(64, 64)]


def test_mode_model_prices_the_instance_that_runs(clean_env):
    """On the card the mode model reads the k-major pass at 64 x 128 (its
    shape's k-major tiles, half the k-major runs' items of 64 x 64, one CTA
    an SM at the refitted constants), and the mode it picks at the train
    shape, with the dq pass at its own card tiles beside it, is split (the
    card times the split pair 7% faster there: tests/test_torch_dq_ws.py)."""
    from tests.test_torch_tensor_cores import BWD_MODE_MASKS

    qr, kr, types, sq, sk, hq, hk, _ = BWD_MODE_MASKS["train_docs_8192_bf16"]
    plan, params = tffa.plan_params(qr, kr, types, None, None, sq, sk, 128, None, 0.0)
    card = tffa.card_bwd_params(params, 128, 128, 2)
    plan_dq, plan_dkv = tffa.bwd_plans(plan, card, sq, sk)
    assert (plan_dkv.block_q, plan_dkv.block_k) == (BQ, BK)
    assert (plan_dq.block_q, plan_dq.block_k) == mem_budget.WS_DQ_TILES
    shape = tffa.bwd_shape(plan_dq, hq, hk, 128, 128, 2, plan_dkv)
    assert shape.dkv_blocks() == (BQ, BK)
    assert tile_policy.tile_area(shape, "fused") == 2.0
    assert tffa.ffa_bwd_mode(plan, card, 128, 128, 2, hq, hk) == "split"
    modeled = tile_policy.kernel_ms(shape)
    assert math.isfinite(modeled["fused"]) and modeled["fused"] > 0
