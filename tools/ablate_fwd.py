#!/usr/bin/env python3
"""Rank the parts of the bf16 FFA forward body (B1) by timing copies of it
with one part taken out, on one CUDA card.

Run from the root of a checkout, with the kernel sources to ablate and the
body:

    python3 tools/ablate_fwd.py build/parent/magiattention_tpu_torch/csrc
    python3 tools/ablate_fwd.py magiattention_tpu_torch/csrc ws

``tc`` (the default) is the cp.async body of ``csrc/ffa_fwd_tc.cuh`` (a
parent's, unpacked by ``git archive <commit> magiattention_tpu_torch/csrc
| tar -x -C build/parent``, or this tree's, whose instances off the
warp-specialised ones keep it), timed at 64 x 64 and 128 x 128; ``ws`` the
warp-specialised body of ``csrc/ffa_fwd_ws.cuh``, timed at its 128 x 128. Each variant is a copy of the sources under
``build/ablate/<variant>/`` (``tools/ablate_bwd_kv.py:variant_sources``)
with textual edits of the body's header
(the repository's sources are not touched), built for the d-128 instances
timed only, and timed against the unedited copy in interleaved rounds by
CUDA-graph replays with a cold L2 (``chip_smoke.paired_graph_ms``: the
device's time, not the wrapper's) at bench.py's headline shape (bf16,
causal, seq 8192, hq 16, hk 8, d 128):

- ``copy_softmax``: the online softmax (scale, softcap, mask, row max,
  exp2, the O rescale) cut to a copy, P = S;
- ``no_pv``: no O += P V product;
- ``no_s``: no S = Q K^T product (the softmax runs on zeros);
- ``loads_only``: every item loads its K and V and waits for them, and
  runs nothing else (the products are compiled, never run; ws: the
  consumers wait for each stage and release it);
- ``fixed_branches`` (tc): the softcap and mask tests taken once an item
  into template instances instead of once an element (the ws body does so
  already).

Prints one JSON line a tile pair with each variant's median ms, its rounds
and its saving against ``base``; the outputs of an ablated kernel are
meaningless and not checked.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

from ablate_bwd_kv import build, variant_sources  # noqa: E402

# the elementwise loop of ffa_fwd_tc.cuh: per element, two run-time tests
TC_LOOP = """      float x = s[i] * qk_scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap) * LOG2E;
      if (!item.full && !item.live(q0 + row, k0 + col)) x = -INFINITY;
      s[i] = x;
      rmax[(i >> 1) & 1] = fmaxf(rmax[(i >> 1) & 1], x);
    }
"""
# variant -> [(text, replacement)]: each text must occur exactly once in the
# body's header
EDITS = {
    "copy_softmax": [(
        "    float rmax[2] = {-INFINITY, -INFINITY};",
        "    fence_regs(s);\n    float m_use[2], alpha[2];\n    if (opaque(0u)) {\n"
        "    float rmax[2] = {-INFINITY, -INFINITY};",
    ), (
        "    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];\n",
        "    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];\n    }\n",
    ), (
        "    float m_use[2], alpha[2];\n#pragma unroll\n    for (int hh = 0; hh < 2; ++hh) {\n"
        "      float mx = rmax[hh];",
        "#pragma unroll\n    for (int hh = 0; hh < 2; ++hh) {\n      float mx = rmax[hh];",
    )],
    "no_pv": [("      wgmma_rs_t1<D>(acc, pa[kk], desc_mn<BK>(Vs, kk));", "      ;")],
    "no_s": [("      wgmma_ss_t00<BK>(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk));", "      ;")],
    "loads_only": [(
        "    const magi::Item item(meta + (long)w * META_DIM);\n    const int k0 = work_kt[w] * BK;\n",
        "    if (opaque(1u)) {  // ablation: nothing but the loads\n"
        "      __syncthreads();\n"
        "      if constexpr (S::STAGES == 1) {\n"
        "        if (wn < w_end) load_kv(wn, 0);\n"
        "        cp_async_commit();\n"
        "      }\n"
        "      w = wn;\n"
        "      stage ^= S::STAGES - 1;\n"
        "      continue;\n"
        "    }\n"
        "    const magi::Item item(meta + (long)w * META_DIM);\n    const int k0 = work_kt[w] * BK;\n",
    )],
    "fixed_branches": [(
        "    float rmax[2] = {-INFINITY, -INFINITY};\n#pragma unroll\n    for (int i = 0; i < NS; ++i) {\n"
        "      const int row = r0 + ((i >> 1) & 1) * 8;\n"
        "      const int col = (i >> 2) * 8 + c0 + (i & 1);\n" + TC_LOOP,
        "    float rmax[2] = {-INFINITY, -INFINITY};\n"
        "    auto pass = [&](auto cap, auto full) {\n"
        "#pragma unroll\n    for (int i = 0; i < NS; ++i) {\n"
        "      const int row = r0 + ((i >> 1) & 1) * 8;\n"
        "      const int col = (i >> 2) * 8 + c0 + (i & 1);\n"
        "      float x = s[i] * qk_scale;\n"
        "      if constexpr (decltype(cap)::value) x = softcap * tanhf(x / softcap) * LOG2E;\n"
        "      if constexpr (!decltype(full)::value)\n"
        "        if (!item.live(q0 + row, k0 + col)) x = -INFINITY;\n"
        "      s[i] = x;\n"
        "      rmax[(i >> 1) & 1] = fmaxf(rmax[(i >> 1) & 1], x);\n"
        "    }\n    };\n"
        "    using T_ = std::true_type;\n    using F_ = std::false_type;\n"
        "    if (softcap > 0.f) {\n"
        "      if (item.full) pass(T_{}, T_{}); else pass(T_{}, F_{});\n"
        "    } else if (item.full) {\n      pass(F_{}, T_{});\n    } else {\n      pass(F_{}, F_{});\n    }\n",
    ), ('#include "tc.cuh"\n', '#include "tc.cuh"\n#include <type_traits>\n')],
}
# the warp-specialised body's edits (ffa_fwd_ws.cuh)
WS_EDITS = {
    "copy_softmax": [(
        "                                             float softcap) {\n  if (softcap > 0.f) {\n",
        "                                             float softcap) {\n"
        "  if (opaque(1u)) {  // ablation: P = S\n"
        "    fence_regs(s);\n"
        "    alpha[0] = alpha[1] = 1.f;\n"
        "    return;\n"
        "  }\n"
        "  if (softcap > 0.f) {\n",
    )],
    "no_pv": [("wgmma_rs_t1<D>(acc, pa[kk], desc_mn<BK>(Vs, kk));", ";")],
    "no_s": [("wgmma_ss_t00<BK>(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk), kk > 0);", ";")],
    "loads_only": [(
        "  if (w < w_end) {\n    // the turn to issue products",
        "  if (w < w_end && opaque(1u)) {  // ablation: nothing but the loads\n"
        "    for (int it = 0; w < w_end; ++it) {\n"
        "      mbar_wait(bar_full(bars, it % S::STAGES), (it / S::STAGES) & 1);\n"
        "      if (lane == 0) mbar_arrive(bar_empty(bars, it % S::STAGES));\n"
        "      w = next_real(w + 1);\n"
        "    }\n"
        "    return;\n"
        "  }\n"
        "  if (w < w_end) {\n    // the turn to issue products",
    )],
}
BODIES = {  # body -> (its header, its edits, the (bq, bk) instances timed)
    "tc": ("ffa_fwd_tc.cuh", EDITS, ((64, 64), (128, 128))),
    "ws": ("ffa_fwd_ws.cuh", WS_EDITS, ((128, 128),)),
}
LIBRARIES = {"fwd": "ffa_fwd"}


def main() -> int:
    import torch

    import chip_smoke as c
    from magiattention_tpu_torch.kernels.ffa import FFAParams, ffa_fwd_kernel
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve()
    header, edits_of, tiles = BODIES[sys.argv[2] if len(sys.argv) == 3 else "tc"]
    jobs = {("base", "fwd"): variant_sources(csrc, "base", [], header, tiles)}
    for name, edits in edits_of.items():
        jobs[(name, "fwd")] = variant_sources(csrc, name, edits, header, tiles)
    libs = {variant: lib for (variant, _), lib in build(jobs, LIBRARIES).items()}
    print(json.dumps({"phase": "ablate_device", "name": torch.cuda.get_device_name(0),
                      "nvidia_smi": c.nvidia_smi("name,power.limit")}), flush=True)

    case = c.mask_cases()["causal_8192_bf16"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    (q, k, v), (qr, kr, lo, hi), _, params = c.case_inputs(case, gen)
    for bq, bk in tiles:
        p = get_ffa_plan(qr, kr, lo, hi, case["sq"], case["sk"], bq, bk)
        pr = FFAParams(num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles, block_q=bq,
                       block_k=bk, softmax_scale=params.softmax_scale, softcap=0.0)
        runs = {
            variant: (lambda L=lib: c.with_libraries(
                {"ffa_fwd": L}, lambda: ffa_fwd_kernel(q, k, v, p, pr)))
            for variant, lib in libs.items()
        }
        t = c.paired_graph_ms(runs, rounds=5)
        med = {n: statistics.median(x) for n, x in t.items()}
        print(json.dumps({
            "phase": "ablate_fwd", "kernel": "ffa_fwd", "tiles": [bq, bk], "device_ms": med,
            "saving_ms": {n: med["base"] - m for n, m in med.items() if n != "base"},
            "rounds": t,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
