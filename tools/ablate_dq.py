#!/usr/bin/env python3
"""Rank the parts of the bf16 FFA dq body (B3) by timing copies of it with
one part taken out, on one CUDA card.

Run from the root of a checkout, with the kernel sources to ablate and the
body:

    python3 tools/ablate_dq.py build/parent/magiattention_tpu_torch/csrc
    python3 tools/ablate_dq.py magiattention_tpu_torch/csrc ws

``tc`` (the default) is the cp.async body, ``dq_narrow`` of
``csrc/ffa_bwd_dq_tc.cuh`` (a parent's, unpacked by ``git archive <commit>
magiattention_tpu_torch/csrc | tar -x -C build/parent``, or this tree's,
whose instances off the warp-specialised ones keep it), timed at 64 x 64
and 128 x 128; ``ws`` the warp-specialised body of
``csrc/ffa_bwd_dq_ws.cuh``, timed at its 128 x 128 (and 128 x 64). Each variant is
a copy of the sources under ``build/ablate/<variant>/``
(``tools/ablate_bwd_kv.py:variant_sources``) with textual edits of the
body's header (the repository's sources are not touched), built for the
d-128 instances timed only, and timed against the unedited copy in
interleaved rounds by CUDA-graph replays with a cold L2
(``chip_smoke.paired_graph_ms``: the device's time, not the wrapper's) at
bench.py's headline shape (bf16, causal, seq 8192, hq 16, hk 8, d 128):

- ``copy_ds``: the elementwise pass (scale, softcap, mask, exp, dS) cut
  to a copy, dS = dP;
- ``no_s``: no S = Q K^T product (the pass runs on zeros);
- ``no_dp``: no dP = dO V^T product;
- ``no_dq``: no dQ += dS K product;
- ``loads_only``: every item loads its K and V and waits for them, and
  runs nothing else (the products are compiled, never run; ws: the
  consumers wait for each stage and release it);
- ``fixed_branches`` (tc): the softcap and mask tests taken once an item
  into template instances (``ds_of``'s form) instead of once an element
  (the ws body does so already).

The ``ws`` body's design alternatives are built and timed beside them
(``WS_CANDIDATES``): ``lse_select``, the full-item pass keeping the rows'
lse test as a select (the body's first form); ``fmul``, the exponent's
multiply rounded apart from the lse subtraction; ``ex2_fast``, the full
uncapped pass on the bare ex2 unit where no exponent of the block is
below -126; ``bk64``, B3 at 128 x 64 on this body with three K/V stages
(``base`` runs the cp.async body at that tile).

Prints one JSON line a tile pair with each variant's median ms, its rounds
and its saving against ``base``, and each candidate's elements of dq that
differ from ``base``'s; the outputs of an ablated kernel are meaningless
and not checked.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

from ablate_bwd_kv import build, variant_sources  # noqa: E402

# the elementwise pass of dq_narrow: per element, run-time tests of the
# softcap and the item's mask
TC_PASS = """#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int row = r0 + hh * 8;                  // q row of the tile
        const int col = (i >> 2) * 8 + c0 + (i & 1);  // k row of the block
        float x = s[i] * qk_scale, dcap = 1.f;
        if (capped) {
          const float th = tanhf(x / softcap);
          x = softcap * th;
          dcap = 1.f - th * th;
        }
        const bool live = row_lse[hh] != -INFINITY &&
                          (item.full || item.live(q0 + row, k0 + col));
        const float p =
            live ? (capped ? expf(x - row_lse[hh]) : exp2f(x - row_lse[hh]))
                 : 0.f;
        dp[i] = p * (dp[i] - row_delta[hh]) * dcap;
      }
"""
# the same pass with the two tests taken once an item
FIXED_PASS = """      auto pass = [&](auto cap, auto full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int row = r0 + hh * 8;
        const int col = (i >> 2) * 8 + c0 + (i & 1);
        float x = s[i] * qk_scale, dcap = 1.f;
        if constexpr (decltype(cap)::value) {
          const float th = tanhf(x / softcap);
          x = softcap * th;
          dcap = 1.f - th * th;
        }
        const bool live = row_lse[hh] != -INFINITY &&
                          (decltype(full)::value || item.live(q0 + row, k0 + col));
        const float p = live ? (decltype(cap)::value ? expf(x - row_lse[hh])
                                                     : exp2f(x - row_lse[hh]))
                             : 0.f;
        dp[i] = p * (dp[i] - row_delta[hh]) * dcap;
      }
      };
      using T_ = std::true_type;
      using F_ = std::false_type;
      if (capped) {
        if (item.full) pass(T_{}, T_{}); else pass(T_{}, F_{});
      } else if (item.full) {
        pass(F_{}, T_{});
      } else {
        pass(F_{}, F_{});
      }
"""
# variant -> [(text, replacement)]: each text must occur exactly once in the
# body's header
EDITS = {
    "copy_ds": [(TC_PASS, "      fence_regs(s);\n")],
    "no_s": [("wgmma_ss_n64_t00(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk), 1);", ";")],
    "no_dp": [("wgmma_ss_n64_t00(dp, desc_k(dOs, kk), desc_k<BK>(Vs, kk), 1);", ";")],
    "no_dq": [("wgmma_rs_t1<D>(acc, da[kk], desc_mn<BK>(Ks, kk));", ";")],
    "loads_only": [(
        "    const magi::Item item(meta + (long)w * META_DIM);\n#pragma unroll 1\n",
        "    if (opaque(1u)) {  // ablation: nothing but the loads\n"
        "      __syncthreads();\n"
        "      w = wn;\n"
        "      stage ^= 1;\n"
        "      continue;\n"
        "    }\n"
        "    const magi::Item item(meta + (long)w * META_DIM);\n#pragma unroll 1\n",
    )],
    "fixed_branches": [
        (TC_PASS, FIXED_PASS),
        ('#include "tc.cuh"\n', '#include "tc.cuh"\n#include <type_traits>\n'),
    ],
}
# the warp-specialised body's edits (ffa_bwd_dq_ws.cuh)
WS_EDITS = {
    "copy_ds": [(
        "float softcap) {\n  const bool full",
        "float softcap) {\n"
        "  if (opaque(1u)) {  // ablation: dS = dP\n"
        "    fence_regs(dp);\n"
        "    return;\n"
        "  }\n"
        "  const bool full",
    )],
    "no_s": [("wgmma_ss_n64_t00(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk), 1);", ";")],
    "no_dp": [("wgmma_ss_n64_t00(dp, desc_k(dOs, kk), desc_k<BK>(Vs, kk), 1);", ";")],
    "no_dq": [("wgmma_rs_t1<D>(acc, da[kk], desc_mn<BK>(Ks, kk));", ";")],
    "loads_only": [(
        "  if (w < w_end) {\n    // the turn to issue products",
        "  if (w < w_end && opaque(1u)) {  // ablation: nothing but the loads\n"
        "    for (int it = 0; w < w_end; ++it) {\n"
        "      mbar_wait(bar_full(bars, it % S::STAGES), (it / S::STAGES) & 1);\n"
        "      if (lane == 0) mbar_arrive(bar_empty(bars, it % S::STAGES));\n"
        "      w = next_real(w + 1);\n"
        "    }\n"
        "    w = w_end;\n"
        "  }\n"
        "  if (w < w_end) {\n    // the turn to issue products",
    )],
}
# the warp-specialised body's design alternatives (not ablations: each
# computes dq, held to the bits of the unedited copy)
WS_CANDIDATES = {
    # the full-item pass keeping the rows' lse test as a select (its first
    # form)
    "lse_select": [(
        "    float p = CAP ? expf(e) : exp2f(e);\n"
        "    if constexpr (!FULL) {\n"
        "      if (!(lse[hh] != -INFINITY && item.live(q0 + row, k0 + col))) p = 0.f;\n"
        "    }\n",
        "    const bool live = lse[hh] != -INFINITY && (FULL || item.live(q0 + row, k0 + col));\n"
        "    const float p = live ? (CAP ? expf(e) : exp2f(e)) : 0.f;\n",
    ), (
        "  const bool full = item.full && lse[0] != -INFINITY && lse[1] != -INFINITY;\n",
        "  const bool full = item.full;\n",
    )],
    # the exponent's multiply taken apart from the lse subtraction
    "fmul": [
        ("e = __fmaf_rn(softcap, th, -lse[hh]);", "e = __fmul_rn(softcap, th) - lse[hh];"),
        ("e = __fmaf_rn(s[i], qk_scale, -lse[hh]);", "e = __fmul_rn(s[i], qk_scale) - lse[hh];"),
    ],
    # the full uncapped pass on the bare ex2 unit where no exponent of the
    # block is below -126 (exp2f's own sequence scales only those)
    "ex2_fast": [(
        "  const float qk_scale = CAP ? scale : scale * LOG2E;\n",
        "  const float qk_scale = CAP ? scale : scale * LOG2E;\n"
        "  if constexpr (FULL && !CAP) {\n"
        "    float e[32], lowest = INFINITY;\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < 32; ++i) {\n"
        "      e[i] = __fmaf_rn(s[i], qk_scale, -lse[(i >> 1) & 1]);\n"
        "      lowest = fminf(lowest, e[i]);\n"
        "    }\n"
        "    if (lowest >= -126.f) {\n"
        "#pragma unroll\n"
        "      for (int i = 0; i < 32; ++i) {\n"
        "        float p;\n"
        "        asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(p) : \"f\"(e[i]));\n"
        "        dp[i] = p * (dp[i] - delta[(i >> 1) & 1]);\n"
        "      }\n"
        "      return;\n"
        "    }\n"
        "  }\n",
    )],
    # B3 at 128 x 64 on this body, three K/V stages (base runs the cp.async
    # body there)
    "bk64": [
        ("(D == 64 || D == 128) && BK == 128 &&", "(D == 64 || D == 128) && (BK == 64 || BK == 128) &&"),
        ("  static constexpr int STAGES = 2;\n", "  static constexpr int STAGES = BK == 128 ? 2 : 3;\n"),
    ],
}
BODIES = {  # body -> (its header, its edits, its candidates, the (bq, bk) instances timed)
    "tc": ("ffa_bwd_dq_tc.cuh", EDITS, {}, ((64, 64), (128, 128))),
    "ws": ("ffa_bwd_dq_ws.cuh", WS_EDITS, WS_CANDIDATES, ((128, 64), (128, 128))),
}
LIBRARIES = {"dq": "ffa_bwd_dq"}


def main() -> int:
    import dataclasses

    import torch

    import chip_smoke as c
    from magiattention_tpu_torch.kernels.ffa import (
        ffa_bwd_dq_kernel, ffa_delta_plain, ffa_fwd_kernel,
    )
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve()
    header, edits_of, candidates, tiles = BODIES[sys.argv[2] if len(sys.argv) == 3 else "tc"]
    jobs = {("base", "dq"): variant_sources(csrc, "base", [], header, tiles)}
    for name, edits in {**edits_of, **candidates}.items():
        jobs[(name, "dq")] = variant_sources(csrc, name, edits, header, tiles)
    libs = {variant: lib for (variant, _), lib in build(jobs, LIBRARIES).items()}
    print(json.dumps({"phase": "ablate_device", "name": torch.cuda.get_device_name(0),
                      "nvidia_smi": c.nvidia_smi("name,power.limit")}), flush=True)

    case = c.mask_cases()["causal_8192_bf16"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    (q, k, v, do), (qr, kr, lo, hi), plan, params = c.case_inputs(case, gen, with_do=True)
    do = (do / 4).to(q.dtype)
    out, lse = ffa_fwd_kernel(q, k, v, plan, params)
    delta = ffa_delta_plain(out, do)
    for bq, bk in tiles:
        p = get_ffa_plan(qr, kr, lo, hi, case["sq"], case["sk"], bq, bk)
        pr = dataclasses.replace(params, num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles,
                                 block_q=bq, block_k=bk)
        runs = {
            variant: (lambda L=lib: c.with_libraries(
                {"ffa_bwd_dq": L}, lambda: ffa_bwd_dq_kernel(q, k, v, do, lse, delta, p, pr)))
            for variant, lib in libs.items()
        }
        want = runs["base"]()
        differing = {n: int((runs[n]() != want).sum().item()) for n in candidates}
        t = c.paired_graph_ms(runs, rounds=5)
        med = {n: statistics.median(x) for n, x in t.items()}
        print(json.dumps({
            "phase": "ablate_dq", "kernel": "ffa_bwd_dq", "tiles": [bq, bk], "device_ms": med,
            "saving_ms": {n: med["base"] - m for n, m in med.items() if n != "base"},
            "candidates_differing_elements": differing, "rounds": t,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
