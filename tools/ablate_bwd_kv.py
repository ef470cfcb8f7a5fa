#!/usr/bin/env python3
"""Rank the parts of a k-major backward body (B5/B6 without dq, B8/B9 with
it) by timing copies of it with one part taken out, on one CUDA card.

Run from the root of a checkout, with the kernel sources to ablate and the
body:

    python3 tools/ablate_bwd_kv.py build/parent/magiattention_tpu_torch/csrc
    python3 tools/ablate_bwd_kv.py magiattention_tpu_torch/csrc ws

``tc`` (the default) is the cp.async body, the d <= 128 branch of
``csrc/bwd_kv_tc.cuh`` (a parent's, unpacked by ``git archive <commit>
magiattention_tpu_torch/csrc | tar -x -C build/parent``, or this tree's,
whose instances off 64 x 128 keep it), timed at 64 x 64 and 64 x 128;
``ws`` the warp-specialised body of ``csrc/bwd_kv_ws.cuh``, timed at its
64 x 128. Each variant is a copy of the sources under
``build/ablate/<variant>/`` with one textual edit of the body's header
(the repository's sources are not touched), built for the d-128 bf16
instances timed only, and timed against the unedited copy in interleaved
rounds (``chip_smoke.paired_ms``) at bench.py's headline shape (bf16,
causal, seq 8192, hq 16, hk 8, d 128):

- ``no_dq_atomics`` (tc) / ``no_dq_adds`` (ws): the fused kernel's dq
  block is computed (and, ws, staged) but not added to the workspace (tc:
  its 16 ``red.add.v4`` a lane and 64 columns; ws: the bulk reduce);
- ``no_lo``: the lo halves of the P^T / dS^T hi + lo products are not run;
- ``copy_elementwise``: the elementwise pass (softcap, mask, exp, dS) is
  cut to a copy (P^T = S^T, dS^T = dP^T);
- ``loads_only``: every step loads its Q, dO, lse and delta and waits for
  them, and runs nothing else (the products are compiled, never run; ws:
  the consumers wait for each stage and release it).

Prints one JSON line a (kernel, tile) with each variant's median ms, its
rounds and its saving against ``base``; the outputs of an ablated kernel
are meaningless and not checked.
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
# the warp-specialised body's edits (bwd_kv_ws.cuh)
WS_EDITS = {
    "no_dq_adds": (("fused",), [
        ("          reduce_add_3d(&tm_dq, base + stg, 64 * panel, h, rows);\n"
         "          reduce_add_3d(&tm_dq, base + stg + 8192, 64 * panel + 32, h, rows);\n", ""),
    ]),
    "no_lo": (("fused", "dkv"), [
        ("wgmma_rs_t1<D>(dv_acc, fl[kk], desc_mn(dOs, kk));", ";"),
        ("wgmma_rs_t1<D>(dk_acc, fl[kk], desc_mn(Qs, kk));", ";"),
    ]),
    "copy_elementwise": (("fused", "dkv"), [(
        """    if (softcap > 0.f) {
      if (item.full)
        p_ds<true, true>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
      else
        p_ds<true, false>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    } else if (item.full) {
      p_ds<false, true>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    } else {
      p_ds<false, false>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    }""",
        "    fence_regs(st);",
    )]),
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
BODIES = {  # body -> (its header, its edits, the (bq, bk) instances timed)
    "tc": ("bwd_kv_tc.cuh", EDITS, ((64, 64), (64, 128))),
    "ws": ("bwd_kv_ws.cuh", WS_EDITS, ((64, 128),)),
}
LIBRARIES = {"fused": "ffa_bwd_fused", "dkv": "ffa_bwd_dkv"}


def variant_sources(csrc: Path, name: str, edits, header: str, tiles) -> Path:
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
    listed = " ".join(f"X(128, {bq}, {bk})" for bq, bk in tiles)
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
    import torch

    import chip_smoke as c
    from magiattention_tpu_torch.kernels.ffa import (
        FFAParams, ffa_bwd_dkv_kernel, ffa_bwd_fused_kernel, ffa_delta_plain, ffa_fwd_kernel,
    )
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    csrc = Path(sys.argv[1]).resolve()
    header, edits_of, tiles = BODIES[sys.argv[2] if len(sys.argv) == 3 else "tc"]
    base = variant_sources(csrc, "base", [], header, tiles)
    jobs = {("base", k): base for k in LIBRARIES}
    for name, (kernels, edits) in edits_of.items():
        src = variant_sources(csrc, name, edits, header, tiles)
        jobs.update({(name, k): src for k in kernels})
    libs = build(jobs)
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
        pr = FFAParams(num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles, block_q=bq,
                       block_k=bk, softmax_scale=params.softmax_scale, softcap=0.0)
        for kernel, fn in (("fused", ffa_bwd_fused_kernel), ("dkv", ffa_bwd_dkv_kernel)):
            lib = LIBRARIES[kernel]
            runs = {
                variant: (lambda L=libs[(variant, kernel)]: c.with_libraries(
                    {lib: L}, lambda: fn(q, k, v, do, lse, delta, p, pr)))
                for variant, kn in libs if kn == kernel
            }
            t = c.paired_ms(runs, rounds=7, samples=5)
            med = {n: statistics.median(x) for n, x in t.items()}
            print(json.dumps({
                "phase": "ablate", "kernel": lib, "tiles": [bq, bk], "ms": med,
                "saving_ms": {n: med["base"] - m for n, m in med.items() if n != "base"},
                "rounds": t,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
