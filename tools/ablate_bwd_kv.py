#!/usr/bin/env python3
"""Rank the parts of a k-major backward body (B5/B6 without dq, B8/B9 with
it) by timing copies of it with one part taken out, on one CUDA card.

Run from the root of a checkout, with the kernel sources to ablate and the
body:

    python3 tools/ablate_bwd_kv.py build/parent/magiattention_tpu_torch/csrc
    python3 tools/ablate_bwd_kv.py build/parent/magiattention_tpu_torch/csrc ws_serial
    python3 tools/ablate_bwd_kv.py magiattention_tpu_torch/csrc ws

``tc`` (the default) is the cp.async body, the d <= 128 branch of
``csrc/bwd_kv_tc.cuh`` (a parent's, unpacked by ``git archive <commit>
magiattention_tpu_torch/csrc | tar -x -C build/parent``, or this tree's,
whose instances off 64 x 128 keep it), timed at 64 x 64 and 64 x 128;
``ws_serial`` the first warp-specialised body of ``csrc/bwd_kv_ws.cuh`` (each
consumer's products and elementwise pass in one serial chain, no order
between the consumers: commit de90d09's, the last before the pass ran
under the products; its edits match that header's text only), ``ws``
this tree's (the pass under the products in flight, the consumers in
ping-pong), both timed at 64 x 128. Each variant is a copy of the sources
under ``build/ablate/<variant>/`` with textual edits of the body's header
(the repository's sources are not touched), built for the bf16 instances
timed only (d 128, and d 64 for the warp-specialised bodies), and timed
against the unedited copy in interleaved rounds by CUDA-graph replays with
a cold L2 (``chip_smoke.paired_graph_ms``: the device's time) at bench.py's
headline shape (bf16, causal, seq 8192, hq 16, hk 8, d 128), and for the
warp-specialised bodies also at the train shape (hq 32, two causal
documents), at d 64 and under the sink-window mask (d 128; long k-major
runs of mostly masked items):

- ``no_dq_atomics`` (tc) / ``no_dq_adds`` (ws): the fused kernel's dq
  block is computed (and, ws, staged) but not added to the workspace (tc:
  its 16 ``red.add.v4`` a lane and 64 columns; ws: the bulk reduce);
- ``no_lo``: the lo halves of the P^T / dS^T hi + lo products are not run;
- ``copy_elementwise``: the elementwise pass (softcap, mask, exp, dS) is
  cut to a copy (P^T = S^T, dS^T = dP^T);
- ``loads_only``: every step loads its Q, dO, lse and delta and waits for
  them, and runs nothing else (the products are compiled, never run; ws:
  the consumers wait for each stage and release it);
- ``no_s``, ``no_dp``, ``no_dv``, ``no_dk`` (ws): one product left out
  (the pass runs on what its registers hold).

Design alternatives (candidates: each computes dk and dv, and the count of
their elements that differ from the unedited copy's, at softcap 0 and 30,
is printed; the fused dq adds in no fixed order and is not counted):

- ``split_pass`` (ws_serial): the body's one elementwise pass replaced by the
  two halves this tree's body runs apart (``p_pass`` / ``ds_pass``,
  ``th_pass`` / ``cap_pass``, read from this tree's header), run back to
  back where the pass ran;
- ``three_stages`` (ws_serial, dk/dv only): the Q/dO ring at three stages;
- ``live_bits`` (ws_serial): the body as it is but for the item's mask,
  tested once a step into a 32-bit mask (this tree's ``live_bits``) while
  S^T and dP^T run, in place of a test per element in the pass;
- ``tree_body`` (ws_serial): this tree's sources unedited, so that its
  body runs in the same rounds (its differing elements: its dk/dv against
  the serial body's);
- ``two_stages`` (ws, dk/dv only): the Q/dO ring at two stages;
- ``four_stages`` (ws, dk/dv only): the Q/dO ring at four stages;
- ``exp_fma_score``, ``exp_fma_lse`` (ws, dk/dv only): the uncapped
  exponent with its contraction written out, one form for every element
  (``__fmaf_rn`` of the score's product and the lse term, or of the lse
  term's product and the rounded score);
- ``no_pingpong`` (ws): the two consumers issue their products in no
  order (the named barriers of the turn left out).

Prints one JSON line a (kernel, tile, shape) with each variant's median
device ms, its rounds and its saving against ``base``, and the card's SM
clock and power draw through the rounds (least, median, largest); the
outputs of an ablated kernel are meaningless and not checked.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (variant, kernels it applies to, [(text, replacement)]): each text must
# occur exactly once in the body's header
EDITS = {
    "no_dq_atomics": (("fused",), [(
        "if (add) atomicAdd(reinterpret_cast<float4*>(dst + 8 * j), val);", ";",
    )]),
    "no_lo": (("fused", "dkv"), [
        ("wgmma_rs_t1<W>(dv_acc, fl[kk], desc_mn<BQ>(dOs + chq, kk));", ";"),
        ("wgmma_rs_t1<W>(dk_acc, fl[kk], desc_mn<BQ>(Qs + chq, kk));", ";"),
    ]),
    "copy_elementwise": (("fused", "dkv"), [(
        """          const int row = r0 + ((i >> 1) & 1) * 8;        // k row of the tile
          const int col = (i >> 2) * 8 + c0 + (i & 1);    // q row of the tile
          const float lv = Ls[col];
          float x = st[i] * qk_scale, dcap = 1.f;
          if (capped) {
            const float th = tanhf(x / softcap);
            x = softcap * th;
            dcap = 1.f - th * th;
          }
          const bool live = lv != -INFINITY &&
                            (item.full || item.live(q0 + col, k0 + row));
          const float p =
              live ? (capped ? expf(x - lv) : exp2f(x - lv * LOG2E)) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - Dls[col]) * dcap;""",
        "          fence_regs(st);",
    )]),
    "loads_only": (("fused", "dkv"), [(
        "    const int h = hkv * g + gi;\n",
        "    const int h = hkv * g + gi;\n"
        "    if (opaque(1u)) {  // ablation: nothing but the loads\n"
        "      __syncthreads();\n"
        "      w = wn;\n"
        "      gi = gn;\n"
        "      stage ^= 1;\n"
        "      continue;\n"
        "    }\n",
    )]),
}
# the first warp-specialised body's pass, called by the item's softcap and mask
WS_SERIAL_CALLS = """    if (softcap > 0.f) {
      if (item.full)
        p_ds<true, true>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
      else
        p_ds<true, false>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    } else if (item.full) {
      p_ds<false, true>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    } else {
      p_ds<false, false>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    }"""
# the first warp-specialised body's edits (its bwd_kv_ws.cuh, the consumers' serial chains)
WS_SERIAL_EDITS = {
    "no_dq_adds": (("fused",), [
        ("          reduce_add_3d(&tm_dq, base + stg, 64 * panel, h, rows);\n"
         "          reduce_add_3d(&tm_dq, base + stg + 8192, 64 * panel + 32, h, rows);\n", ""),
    ]),
    "no_lo": (("fused", "dkv"), [
        ("wgmma_rs_t1<D>(dv_acc, fl[kk], desc_mn(dOs, kk));", ";"),
        ("wgmma_rs_t1<D>(dk_acc, fl[kk], desc_mn(Qs, kk));", ";"),
    ]),
    "copy_elementwise": (("fused", "dkv"), [(WS_SERIAL_CALLS, "    fence_regs(st);")]),
    "loads_only": (("fused", "dkv"), [(
        "    mbar_wait(bar_full(bars, stage), (it >> 1) & 1);\n",
        "    mbar_wait(bar_full(bars, stage), (it >> 1) & 1);\n"
        "    if (opaque(1u)) {  // ablation: nothing but the loads\n"
        "      if (lane == 0) mbar_arrive(bar_empty(bars, stage));\n"
        "      if (++gi == g) {\n"
        "        gi = 0;\n"
        "        w = next_real(w + 1);\n"
        "      }\n"
        "      continue;\n"
        "    }\n",
    )]),
}
# the first warp-specialised body's whole elementwise pass
WS_SERIAL_PASS = """template <bool CAP, bool FULL>
__device__ __forceinline__ void p_ds(float (&st)[32], float (&dpt)[32], const float* Ls,
                                     const float* Dls, const magi::Item& item, int q0,
                                     int k0, int r0, int c0, float scale, float softcap) {
  const float qk_scale = CAP ? scale : scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    const float lv = Ls[col];
    float x = st[i] * qk_scale, dcap = 1.f;
    if (CAP) {
      const float th = tanhf(x / softcap);
      x = softcap * th;
      dcap = 1.f - th * th;
    }
    const bool live = lv != -INFINITY && (FULL || item.live(q0 + col, k0 + row));
    const float p = live ? (CAP ? expf(x - lv) : exp2f(x - lv * LOG2E)) : 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - Dls[col]) * dcap;
  }
}
"""
# the two halves of the pass as this tree's body runs them
TREE_CSRC = ROOT / "magiattention_tpu_torch" / "csrc"
_OWN = (TREE_CSRC / "bwd_kv_ws.cuh").read_text()
HALVES = _OWN[_OWN.index("// ---- the elementwise pass in two halves ----"):
              _OWN.index("// ---- end of the two halves ----")]
# the serial pass with the item's mask read from a once-a-step bit mask
WS_SERIAL_PASS_BITS = (
    _OWN[_OWN.index("// the item's slice over the thread's 32 pairs"):
         _OWN.index("// ---- end of the two halves ----")]
    + WS_SERIAL_PASS.replace("const magi::Item& item", "uint32_t bits")
    .replace("    const int row = r0 + ((i >> 1) & 1) * 8;\n", "")
    .replace("item.live(q0 + col, k0 + row)", "((bits >> i) & 1u)"))
WS_SERIAL_CANDIDATES = {
    "split_pass": (("fused", "dkv"), [(WS_SERIAL_PASS, HALVES + """template <bool CAP, bool FULL>
__device__ __forceinline__ void p_ds(float (&st)[32], float (&dpt)[32], const float* Ls,
                                     const float* Dls, const magi::Item& item, int q0,
                                     int k0, int r0, int c0, float scale, float softcap) {
  const uint32_t bits = FULL ? ~0u : live_bits(item, q0, k0, r0, c0);
  if constexpr (CAP) {
    th_pass(st, scale, softcap);
    cap_pass<FULL>(st, dpt, Ls, Dls, bits, c0, softcap);
  } else {
    p_pass<FULL>(st, Ls, bits, c0, scale);
    ds_pass(st, dpt, Dls, c0);
  }
}
""")]),
    "three_stages": (("dkv",), [
        ("  static constexpr uint32_t DS = QDO + 4 * TILE;",
         "  static constexpr uint32_t DS = QDO + 6 * TILE;"),
        ("  static constexpr uint32_t BARS = STATS + 2 * 2 * BQ * 4;",
         "  static constexpr uint32_t BARS = STATS + 3 * 2 * BQ * 4;"),
        ("{ return bars + 16 + 8 * s; }", "{ return bars + 24 + 8 * s; }"),
        ("kv_full = bars + 32;", "kv_full = bars + 48;"),
        ("    mbar_init(bar_empty(bars, 1), 8);\n",
         "    mbar_init(bar_empty(bars, 1), 8);\n"
         "    mbar_init(bar_full(bars, 2), 33);\n"
         "    mbar_init(bar_empty(bars, 2), 8);\n"),
        ("      const int stage = it & 1;\n      mbar_wait(bar_empty(bars, stage), ((it >> 1) & 1) ^ 1);",
         "      const int stage = it % 3;\n      mbar_wait(bar_empty(bars, stage), ((it / 3) & 1) ^ 1);"),
        ("    const int stage = it & 1;\n    const magi::Item item",
         "    const int stage = it % 3;\n    const magi::Item item"),
        ("    mbar_wait(bar_full(bars, stage), (it >> 1) & 1);",
         "    mbar_wait(bar_full(bars, stage), (it / 3) & 1);"),
    ]),
    "live_bits": (("fused", "dkv"), [
        (WS_SERIAL_PASS, WS_SERIAL_PASS_BITS),
        (WS_SERIAL_CALLS, WS_SERIAL_CALLS.replace("Dls, item, q0", "Dls, bits, q0")),
        ("    wgmma_commit();\n    wgmma_wait<0>();\n    fence_regs(st);\n",
         "    wgmma_commit();\n"
         "    const uint32_t bits = item.full ? ~0u : live_bits(item, q0, k0, r0, c0);\n"
         "    wgmma_wait<0>();\n    fence_regs(st);\n"),
    ]),
    # None: this tree's sources, unedited
    "tree_body": (("fused", "dkv"), None),
}
# this tree's warp-specialised body's edits (bwd_kv_ws.cuh)
WS_EDITS = {
    "no_dq_adds": (("fused",), [(
        "        reduce_add_3d(&tm_dq, base + stg + b * 8192, c * (D / 2) + 32 * b, at[1], at[0]);\n", "",
    )]),
    "no_lo": (("fused", "dkv"), [("wgmma_rs_t1<D>(acc, fl[kk], desc_mn(B, kk));", ";")]),
    "copy_elementwise": (("fused", "dkv"), [(
        """      if (softcap > 0.f)
        th_pass(st, scale, softcap);
      else if (full)
        p_pass<true>(st, Ls, bits, c0, scale);
      else
        p_pass<false>(st, Ls, bits, c0, scale);
""",
        "      fence_regs(st);\n",
    ), (
        """      if (softcap > 0.f) {
        if (full)
          cap_pass<true>(st, dpt, Ls, Dls, bits, c0, softcap);
        else
          cap_pass<false>(st, dpt, Ls, Dls, bits, c0, softcap);
      } else {
        ds_pass(st, dpt, Dls, c0);
      }
""",
        "      fence_regs(dpt);\n",
    )]),
    "no_s": (("fused", "dkv"), [("wgmma_ss_n64_t00(st, desc_k(Ks, kk), desc_k(Qs, kk), 1);", ";")]),
    "no_dp": (("fused", "dkv"), [("wgmma_ss_n64_t00(dpt, desc_k(Vs, kk), desc_k(dOs, kk), 1);", ";")]),
    "no_dv": (("fused", "dkv"), [("      issue_hi_lo<D>(dv_acc, fh, fl, dOs);\n", "")]),
    "no_dk": (("fused", "dkv"), [("      issue_hi_lo<D>(dk_acc, fh, fl, Qs);\n", "")]),
    # the consumers wait for each stage and release it; it stays 0 (the
    # fused epilogue's dQ then reads the tiles before the first step, whose
    # barrier wait passes; its add runs on what they hold)
    "loads_only": (("fused", "dkv"), [(
        "      mbar_wait(bar_full<ST>(bars, stage), phase);\n",
        "      mbar_wait(bar_full<ST>(bars, stage), phase);\n"
        "      if (opaque(1u)) {  // ablation: nothing but the loads\n"
        "        if (lane == 0) mbar_arrive(bar_empty<ST>(bars, stage));\n"
        "        if (++stage == ST) {\n"
        "          stage = 0;\n"
        "          phase ^= 1;\n"
        "        }\n"
        "        if (++gi == g) {\n"
        "          gi = 0;\n"
        "          w = next_real(w + 1);\n"
        "        }\n"
        "        it = -1;\n"
        "        continue;\n"
        "      }\n",
    )]),
}
# this tree's body's design alternatives
WS_CANDIDATES = {
    # the uncapped exponent's contraction written out, one form for every
    # element: the score's product fused with the lse term's subtraction,
    # or the lse term's product fused with the rounded score
    "exp_fma_score": (("dkv",), [(
        "    st[i] = live ? exp2f(x - lv * LOG2E) : 0.f;\n",
        "    st[i] = live ? exp2f(__fmaf_rn(st[i], qk_scale, -__fmul_rn(lv, LOG2E))) : 0.f;\n",
    )]),
    "exp_fma_lse": (("dkv",), [(
        "    st[i] = live ? exp2f(x - lv * LOG2E) : 0.f;\n",
        "    st[i] = live ? exp2f(__fmaf_rn(-lv, LOG2E, __fmul_rn(st[i], qk_scale))) : 0.f;\n",
    )]),
    # the dk/dv kernel's Q/dO ring at two stages, or four
    "two_stages": (("dkv",), [(
        "  static constexpr int STAGES = FUSED ? 2 : 3;", "  static constexpr int STAGES = 2;",
    )]),
    "four_stages": (("dkv",), [(
        "  static constexpr int STAGES = FUSED ? 2 : 3;", "  static constexpr int STAGES = FUSED ? 2 : 4;",
    )]),
    # the two consumers issue their products in no order: the turn's named
    # barriers left out
    "no_pingpong": (("fused", "dkv"), [
        ("      bar_sync(TURN + c, 256);  // this consumer's turn\n", ""),
        ("      bar_arrive(TURN + 1 - c, 256);\n", ""),
        ("    if (cw() == 0) bar_arrive(TURN, 256);  // consumer 0 takes the first turn\n", ""),
        ("    if (cw() == 0) bar_sync(TURN, 256);  // consumer 1's last hand-over\n", ""),
    ]),
}
# body -> (its header, its edits, its candidates, the (bq, bk) instances
# timed, the head dims built)
BODIES = {
    "tc": ("bwd_kv_tc.cuh", EDITS, {}, ((64, 64), (64, 128)), (128,)),
    "ws_serial": ("bwd_kv_ws.cuh", WS_SERIAL_EDITS, WS_SERIAL_CANDIDATES, ((64, 128),), (128, 64)),
    "ws": ("bwd_kv_ws.cuh", WS_EDITS, WS_CANDIDATES, ((64, 128),), (128, 64)),
}
# the shapes timed: (chip_smoke.mask_cases key, head dim); the cp.async
# body at the headline only
SHAPES = (("causal_8192_bf16", 128), ("train_docs_8192_bf16", 128), ("causal_8192_bf16", 64),
          ("sink_window_8192_bf16", 128))
LIBRARIES = {"fused": "ffa_bwd_fused", "dkv": "ffa_bwd_dkv"}


class ClockSampler:
    """The card's SM clock (MHz) and power draw (W) from ``nvidia-smi``
    every 0.2 s while the block runs; ``stat(i)``: their least, median and
    largest."""

    def __enter__(self):
        import threading

        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
            self.samples.append(tuple(float(x) for x in out.split(",")))
            self._stop.wait(0.2)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def stat(self, i: int) -> list[float]:
        x = sorted(sample[i] for sample in self.samples)
        return [x[0], x[len(x) // 2], x[-1]] if x else []


def variant_sources(csrc: Path, name: str, edits, header: str, tiles, dims=(128,)) -> Path:
    out = ROOT / "build" / "ablate" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(csrc, out)
    body = (out / header).read_text()
    for text, repl in edits:
        if body.count(text) != 1:
            raise SystemExit(f"{name}: the edit's text occurs {body.count(text)} times")
        body = body.replace(text, repl)
    (out / header).write_text(body)
    # only the timed instances are compiled in each copy
    common = (out / "common.cuh").read_text()
    start = common.index("#define MAGI_FFA_TILES(X)")
    end = common.index("\n\n", start)
    listed = " ".join(f"X({d}, {bq}, {bk})" for d in dims for bq, bk in tiles)
    (out / "common.cuh").write_text(
        common[:start] + f"#define MAGI_FFA_TILES(X) {listed}\n" + common[end + 1:])
    return out


def build(jobs: dict, libraries: dict = LIBRARIES) -> dict:
    """(variant, kernel) -> bound library (``libraries[kernel]``, a
    ``csrc/<name>.cu``), one nvcc a library at once."""
    import ctypes

    from magiattention_tpu_torch.kernels import _build
    from magiattention_tpu_torch.kernels.ffa import bind_library

    procs = {}
    for (variant, kernel), src in jobs.items():
        lib = libraries[kernel]
        so = src / f"{lib}.so"
        log = open(so.with_suffix(".log"), "w")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src / f"{lib}.cu")]
        procs[(variant, kernel)] = (so, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    libs = {}
    for key, (so, log, proc) in procs.items():
        if proc.wait():
            raise SystemExit(f"{key}: nvcc failed\n{so.with_suffix('.log').read_text()}")
        log.close()
        lib = ctypes.CDLL(str(so))
        lib.magi_error_string.argtypes = [ctypes.c_int]
        lib.magi_error_string.restype = ctypes.c_char_p
        libs[key] = bind_library(lib, libraries[key[1]])
    return libs


def main() -> int:
    import dataclasses

    import torch

    import chip_smoke as c
    from magiattention_tpu_torch.kernels.ffa import (
        ffa_bwd_dkv_kernel, ffa_bwd_fused_kernel, ffa_delta_plain, ffa_fwd_kernel,
    )
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve()
    body = sys.argv[2] if len(sys.argv) == 3 else "tc"
    header, edits_of, candidates, tiles, dims = BODIES[body]
    base = variant_sources(csrc, "base", [], header, tiles, dims)
    jobs = {("base", k): base for k in LIBRARIES}
    for name, (kernels, edits) in {**edits_of, **candidates}.items():
        src = variant_sources(csrc if edits is not None else TREE_CSRC, name, edits or [],
                              header, tiles, dims)
        jobs.update({(name, k): src for k in kernels})
    libs = build(jobs)
    print(json.dumps({"phase": "ablate_device", "name": torch.cuda.get_device_name(0),
                      "nvidia_smi": c.nvidia_smi("name,power.limit")}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for key, d in SHAPES if body != "tc" else SHAPES[:1]:
        case = dict(c.mask_cases()[key], d=d)
        (q, k, v, do), (qr, kr, lo, hi), plan, params = c.case_inputs(case, gen, with_do=True)
        do = (do / 4).to(q.dtype)
        caps = {}  # softcap -> its forward's lse and delta
        for cap in (30.0, 0.0):
            out, lse = ffa_fwd_kernel(q, k, v, plan, dataclasses.replace(params, softcap=cap))
            caps[cap] = (lse, ffa_delta_plain(out, do))
        lse, delta = caps[0.0]
        for bq, bk in tiles:
            p = get_ffa_plan(qr, kr, lo, hi, case["sq"], case["sk"], bq, bk)
            pr = dataclasses.replace(params, num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles,
                                     block_q=bq, block_k=bk)
            for kernel, fn in (("fused", ffa_bwd_fused_kernel), ("dkv", ffa_bwd_dkv_kernel)):
                lib = LIBRARIES[kernel]
                runs = {
                    variant: (lambda L=libs[(variant, kernel)]: c.with_libraries(
                        {lib: L}, lambda: fn(q, k, v, do, lse, delta, p, pr)))
                    for variant, kn in libs if kn == kernel
                }
                differing = {n: {} for n in candidates if n in runs}
                for cap, (lse_c, delta_c) in caps.items():  # dk, dv against base's
                    pc = dataclasses.replace(pr, softcap=cap)
                    at = lambda n: c.with_libraries(  # noqa: E731
                        {lib: libs[(n, kernel)]}, lambda: fn(q, k, v, do, lse_c, delta_c, p, pc))[-2:]
                    want = at("base")
                    for n in differing:
                        differing[n][f"softcap_{cap:g}"] = sum(
                            int((a != b).sum().item()) for a, b in zip(at(n), want))
                    del want
                with ClockSampler() as clocks:
                    t = c.paired_graph_ms(runs, rounds=3)
                med = {n: statistics.median(x) for n, x in t.items()}
                print(json.dumps({
                    "phase": "ablate", "kernel": lib, "tiles": [bq, bk], "case": key, "d": d,
                    "device_ms": med,
                    "saving_ms": {n: med["base"] - m for n, m in med.items() if n != "base"},
                    "candidates_differing_elements": differing, "rounds": t,
                    "sm_clock_mhz": clocks.stat(0), "power_w": clocks.stat(1),
                }), flush=True)
        del q, k, v, do, out, lse, delta, caps
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
