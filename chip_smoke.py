#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the port's kernels from ``csrc/`` first.

Phases, each printing one JSON line (any failure raises, exit code != 0):

1. ``device``: the card's name, power limit and NVIDIA driver version,
   and the build time.
2. ``ffa_fwd``: the FFA forward kernel against its plain version
   (``sdpa_attn``) at (a) the serving prefill shape, (b) the bf16 causal
   headline shape and (c) a bf16 varlen mask with uncovered rows.
3. ``paged_decode``: the paged-decode kernel against ``paged_decode_plain``
   on 8 ragged slots, in float32 and bfloat16.
4. ``serve``: ``ServeEngine`` at Llama-3.1-8B attention widths on 16
   requests; every generated row is held against the sequential replay
   oracle (FFA kernel) on the card, the first two requests against the
   port's own engine on the CPU, and the kernels' launch counters must have
   risen while the plain versions were never called.
5. ``edge_cases``: head_dim 64, ragged tiles, softcap, g = 1 and 8 and
   other page sizes, kernel against plain version (not timed).
6. ``serve_profile``: the serve run again under ``torch.profiler``.
7. ``kernels``: one line per-kernel summary (launches from the serve phase,
   error, kernel / plain / library time and the card's bound).

Before the last line it prints ``nvidia-smi``'s ``name, power.limit`` line;
the last line is ``{"ok": true, "device": {...}}``.

Bounds use the card's data-sheet peaks (H100 SXM: 989 TFLOP/s bf16 tensor
cores, 67 TFLOP/s float32 CUDA cores, 3.35 TB/s HBM3); other H100 forms
use their own figures, named in the device line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
RNORM = {"float32": 1e-5, "bfloat16": 1e-2}
SERVE_ATOL, SERVE_RNORM = 1e-4, 1e-5

# (name substring, bf16 dense TFLOP/s, fp32 CUDA-core TFLOP/s, HBM TB/s)
PEAKS = (
    ("H100 NVL", 835e12, 60e12, 3.9e12),
    ("H100 PCIe", 756e12, 51e12, 2.0e12),
    ("H100", 989e12, 67e12, 3.35e12),  # SXM5 (HBM3)
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_peaks(name: str) -> dict:
    for key, bf16, f32, bw in PEAKS:
        if key in name:
            return {"form": key, "bfloat16": bf16, "float32": f32, "bytes_s": bw}
    raise RuntimeError(f"no peak figures for card {name!r}")


def time_ms(fn, warmup: int = 3, samples: int = 10) -> float:
    """Median device ms of one call: CUDA events around a batch of calls
    sized to about 2 ms, median over ``samples`` batches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, min(200, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(samples):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str, peaks: dict) -> tuple[float, str]:
    t_ops = flops / peaks[dtype] * 1e3
    t_bytes = nbytes / peaks["bytes_s"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def errors(out_k, lse_k, out_p, lse_p) -> dict:
    import torch

    if not torch.equal(torch.isneginf(lse_k), torch.isneginf(lse_p)):
        raise AssertionError("kernel and plain disagree on which rows are empty")
    if not (torch.isfinite(out_k).all() and not torch.isnan(lse_k).any()):
        raise AssertionError("kernel output is not finite")
    a, b = out_k.double(), out_p.double()
    fin = torch.isfinite(lse_p)
    return {
        "max_abs_err": (a - b).abs().max().item(),
        "rel_norm_err": ((a - b).norm() / b.norm()).item(),
        "lse_max_abs_err": (
            (lse_k[fin].double() - lse_p[fin].double()).abs().max().item()
            if fin.any() else 0.0
        ),
    }


def check(name: str, err: dict, dtype: str) -> None:
    atol, rnorm = ATOL[dtype], RNORM[dtype]
    if not (
        err["max_abs_err"] <= atol
        and err["lse_max_abs_err"] <= atol
        and err["rel_norm_err"] <= rnorm
    ):
        raise AssertionError(
            f"{name}: kernel vs plain {err} beyond atol {atol}, rel-norm {rnorm}"
        )


def ffa_phase(peaks: dict) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from magiattention_tpu_torch.kernels.ffa import (
        FFAParams, default_blocks, ffa_fwd_kernel,
    )
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan
    from magiattention_tpu_torch.kernels.mask_utils import (
        BAND_INF, build_dense_mask_band, types_to_bands,
    )
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    # (a) serving prefill chunk: 512 queries at positions 1536.. over the
    # 4096 gathered rows of a 256-page table, kv_len 2048
    cases.append(dict(
        name="a_serving_prefill_f32", dtype=torch.float32, sq=512, sk=4096,
        hq=32, hk=8, qr=[[0, 512]], kr=[[0, 2048]],
        lo=[-BAND_INF], hi=[1536],
    ))
    # (b) bench.py headline shape, forward only
    S = 8192
    lo, hi = types_to_bands(np.array([[0, S]]), np.array([[0, S]]), np.array([1]))
    cases.append(dict(
        name="b_causal_8192_bf16", dtype=torch.bfloat16, sq=S, sk=S, hq=16,
        hk=8, qr=[[0, S]], kr=[[0, S]], lo=lo, hi=hi, library="causal",
    ))
    # (c) varlen: two block-causal documents, an INVCAUSAL slice, a
    # BICAUSAL (sliding-band) slice and uncovered rows [7680, 8192)
    qr = np.array([[0, 3072], [3072, 6144], [6144, 7168], [7168, 7680]])
    kr = np.array([[0, 3072], [3072, 6144], [6144, 7168], [6144, 7680]])
    lo, hi = types_to_bands(qr, kr, np.array([1, 1, 2, 3]))
    cases.append(dict(
        name="c_varlen_8192_bf16", dtype=torch.bfloat16, sq=S, sk=S, hq=16,
        hk=8, qr=qr, kr=kr, lo=lo, hi=hi, uncovered=(7680, 8192),
    ))

    results = []
    for c in cases:
        dt, d = c["dtype"], 128
        dname = str(dt).removeprefix("torch.")
        q = torch.randn((c["sq"], c["hq"], d), generator=gen, device="cuda").to(dt)
        k = torch.randn((c["sk"], c["hk"], d), generator=gen, device="cuda").to(dt)
        v = torch.randn((c["sk"], c["hk"], d), generator=gen, device="cuda").to(dt)
        qr = np.asarray(c["qr"], np.int32)
        kr = np.asarray(c["kr"], np.int32)
        lo = np.asarray(c["lo"], np.int32)
        hi = np.asarray(c["hi"], np.int32)
        scale = d ** -0.5
        bq, bk = default_blocks(c["sq"], c["sk"])
        plan = get_ffa_plan(qr, kr, lo, hi, c["sq"], c["sk"], bq, bk)
        params = FFAParams(
            num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
            block_q=bq, block_k=bk, softmax_scale=scale, softcap=0.0,
        )

        def kernel():
            return ffa_fwd_kernel(q, k, v, plan, params)

        def plain():
            return sdpa_attn(q, k, v, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi)

        out_k, lse_k = kernel()
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        err = errors(out_k, lse_k, out_p, lse_p)
        check(c["name"], err, dname)
        if "uncovered" in c:
            r0, r1 = c["uncovered"]
            if out_k[r0:r1].any() or not torch.isneginf(lse_k[r0:r1]).all():
                raise AssertionError(f"{c['name']}: uncovered rows are not (0, -inf)")
        mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
        live = int(mask.sum().item())
        flops = 4.0 * c["hq"] * d * live
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + lse_k.numel() * 4
        b_ms, b_by = bound(flops, nbytes, dname, peaks)
        library_ms = None
        if c.get("library") == "causal":
            qt, kt, vt = (t.transpose(0, 1)[None] for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        elif "uncovered" not in c:  # every row covered: SDPA with the mask
            qt, kt, vt = (t.transpose(0, 1)[None] for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        res = dict(
            case=c["name"], dtype=dname, q=list(q.shape), kv=list(k.shape),
            live_pairs=live, work_items=plan.num_work, **err,
            ms=time_ms(kernel), plain_ms=time_ms(plain, warmup=1, samples=10),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        results.append(res)
        emit({"phase": "ffa_fwd", **res})
        del mask, out_p, lse_p
        torch.cuda.empty_cache()
    return results


def decode_phase(peaks: dict) -> list[dict]:
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_kernel, paged_decode_plain,
    )
    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, assign_pages

    S, hq, hk, d, ps, P, N = 8, 32, 8, 128, 16, 256, 1024
    lengths = [0, 1, 15, 16, 17, 1000, 4095, 4096]
    rng = np.random.default_rng(1)
    perm = rng.permutation(N)
    gen = torch.Generator(device="cuda").manual_seed(1)
    kf = torch.randn((N, ps, hk, d), generator=gen, device="cuda")
    vf = torch.randn((N, ps, hk, d), generator=gen, device="cuda")
    qf = torch.randn((S, hq, d), generator=gen, device="cuda")
    results = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        cache = PagedKVCache.create(N, ps, hk, d, S, P, dtype=dt, device="cuda")
        cache.k_pages.copy_(kf)
        cache.v_pages.copy_(vf)  # every page holds data, dead ones too
        used = 0
        for s, length in enumerate(lengths):
            n = -(-length // ps)
            assign_pages(cache, s, perm[used : used + n])
            used += n
        cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
        q = qf.to(dt)
        scale = d ** -0.5

        def kernel():
            return paged_decode_kernel(q, cache, scale)

        def plain():
            return paged_decode_plain(q, cache, scale)

        out_k, lse_k = kernel()
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        err = errors(out_k, lse_k, out_p, lse_p)
        check(f"paged_decode_{dname}", err, dname)
        if out_k[0].any() or not torch.isneginf(lse_k[0]).all():
            raise AssertionError("paged_decode: empty slot is not (0, -inf)")
        tokens = sum(lengths)
        isz = q.element_size()
        nbytes = (
            2 * q.numel() * isz + lse_k.numel() * 4
            + tokens * hk * d * 2 * isz
            + sum(-(-n // ps) for n in lengths) * 4 + S * 4
        )
        b_ms, b_by = bound(4.0 * hq * d * tokens, nbytes, dname, peaks)
        res = dict(
            case=f"decode_8slots_{dname}", dtype=dname, lengths=lengths,
            q=list(q.shape), pages=list(cache.k_pages.shape), **err,
            ms=time_ms(kernel), plain_ms=time_ms(plain, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        res["gb_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
        results.append(res)
        emit({"phase": "paged_decode", **res})
    return results


def edge_phase() -> None:
    """Kernel paths the main shapes do not reach, checked (not timed):
    head_dim 64, a ragged last k tile (sk % 64 != 0), softcap, g = 1 and
    g = 8, a page size below and above the 64-token chunk."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import ffa_attn
    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_kernel, paged_decode_plain,
    )
    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, assign_pages
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst: dict[str, float] = {}
    qr = np.array([[0, 40], [40, 150], [150, 200]])
    kr = np.array([[0, 50], [30, 170], [100, 203]])
    types = np.array([1, 0, 3])
    for d, hq, hk, dt, softcap in (
        (64, 6, 3, torch.float32, 30.0),
        (64, 4, 4, torch.bfloat16, 0.0),
        (128, 8, 1, torch.float32, 0.0),
    ):
        dname = str(dt).removeprefix("torch.")
        q = torch.randn((230, hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((203, hk, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((203, hk, d), generator=gen, device="cuda").to(dt)
        got = ffa_attn(q, k, v, qr, kr, attn_type_map=types, softcap=softcap)
        want = sdpa_attn(q, k, v, qr, kr, attn_type_map=types, softcap=softcap)
        name = f"ffa_d{d}_g{hq // hk}_{dname}_cap{softcap:g}"
        err = errors(*got, *want)
        check(name, err, dname)
        if got[0][200:].any() or not torch.isneginf(got[1][200:]).all():
            raise AssertionError(f"{name}: uncovered rows are not (0, -inf)")
        worst[name] = err["max_abs_err"]
    for d, hq, hk, ps, dt in (
        (64, 8, 1, 8, torch.float32),
        (128, 8, 2, 128, torch.bfloat16),
    ):
        dname = str(dt).removeprefix("torch.")
        lengths = [300, 0, 1, 129]
        N, P = 64, 40
        cache = PagedKVCache.create(N, ps, hk, d, 4, P, dtype=dt, device="cuda")
        cache.k_pages.copy_(torch.randn(cache.k_pages.shape, generator=gen, device="cuda"))
        cache.v_pages.copy_(torch.randn(cache.v_pages.shape, generator=gen, device="cuda"))
        perm, used = np.random.default_rng(d + ps).permutation(N), 0
        for s, length in enumerate(lengths):
            n = -(-length // ps)
            assign_pages(cache, s, perm[used : used + n])
            used += n
        cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
        q = torch.randn((4, hq, d), generator=gen, device="cuda").to(dt)
        name = f"decode_d{d}_g{hq // hk}_ps{ps}_{dname}"
        err = errors(*paged_decode_kernel(q, cache, d ** -0.5),
                     *paged_decode_plain(q, cache, d ** -0.5))
        check(name, err, dname)
        worst[name] = err["max_abs_err"]
    emit({"phase": "edge_cases", "max_abs_err": worst})


# (prompt_len, new_tokens): short requests first (held against the CPU
# engine), then lengths spread over 1..3968 incl. the page and chunk
# boundaries 16, 512, 513
SERVE_REQUESTS = [
    (1, 8), (16, 32), (512, 16), (513, 24), (3968, 8), (100, 12),
    (1000, 20), (2047, 28), (2048, 10), (3000, 14), (250, 18), (777, 22),
    (1500, 26), (3500, 30), (64, 9), (2600, 11),
]


def serve_phase() -> dict:
    import torch

    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts
    from magiattention_tpu_torch.serving import (
        ServeConfig, ServeEngine, ServeRequest, ToyModel, run_reference,
    )

    t0 = time.perf_counter()
    model = ToyModel.create(
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, seed=0,
        device="cuda",
    )
    config = ServeConfig(
        page_size=16, num_pages=2048, max_slots=8, max_pages_per_seq=256,
        prefill_chunk=512,
    )

    def requests(m):
        return [
            ServeRequest(i, m.prompt(length, seed=1000 + i), new)
            for i, (length, new) in enumerate(SERVE_REQUESTS)
        ]

    reqs = requests(model)
    engine = ServeEngine(model, config)
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    reset_launch_counts()
    t1 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = launch_counts()

    if len(finished) != len(reqs) or any(
        len(r.generated) != r.max_new_tokens for r in reqs
    ):
        raise AssertionError(f"serve: {len(finished)}/{len(reqs)} requests completed")
    if counts["ffa_fwd"] == 0 or counts["paged_decode"] == 0:
        raise AssertionError(f"serve: a kernel was never launched: {counts}")
    if counts["sdpa_attn"] or counts["paged_decode_plain"]:
        raise AssertionError(f"serve: a plain version ran on the card: {counts}")

    def row_errs(rows_a, rows_b):
        a = np.stack(rows_a).astype(np.float64)
        b = np.stack(rows_b).astype(np.float64)
        if not np.isfinite(a).all():
            raise AssertionError("serve: non-finite generated rows")
        return float(np.abs(a - b).max()), float(np.linalg.norm(a - b) / np.linalg.norm(b))

    reference = run_reference(model, reqs, config)
    worst_abs = worst_rn = 0.0
    for r in reqs:
        ea, en = row_errs(r.generated, reference[r.req_id])
        worst_abs, worst_rn = max(worst_abs, ea), max(worst_rn, en)
    if worst_abs > SERVE_ATOL or worst_rn > SERVE_RNORM:
        raise AssertionError(
            f"serve: engine vs replay oracle max abs {worst_abs:.3e}, "
            f"rel-norm {worst_rn:.3e} beyond {SERVE_ATOL}, {SERVE_RNORM}"
        )

    # the first two requests through the port's own engine on the CPU
    cpu_model = ToyModel.from_numpy(
        {n: getattr(model, n).cpu().numpy() for n in ("wq", "wk", "wv", "wo")},
        32, 8, 128, device="cpu",
    )
    cpu_config = ServeConfig(
        page_size=16, num_pages=64, max_slots=2, max_pages_per_seq=256,
        prefill_chunk=512,
    )
    cpu_reqs = requests(cpu_model)[:2]
    ServeEngine(cpu_model, cpu_config).run(cpu_reqs)
    cpu_abs = cpu_rn = 0.0
    for r_gpu, r_cpu in zip(reqs[:2], cpu_reqs):
        ea, en = row_errs(r_gpu.generated, r_cpu.generated)
        cpu_abs, cpu_rn = max(cpu_abs, ea), max(cpu_rn, en)
    if cpu_abs > SERVE_ATOL or cpu_rn > SERVE_RNORM:
        raise AssertionError(
            f"serve: card vs CPU engine max abs {cpu_abs:.3e}, "
            f"rel-norm {cpu_rn:.3e} beyond {SERVE_ATOL}, {SERVE_RNORM}"
        )

    prompt_tokens = sum(r.prompt_len for r in reqs)
    gen_tokens = sum(len(r.generated) for r in reqs)
    res = dict(
        model="ToyModel d_model=4096 hq=32 hk=8 head_dim=128 (Llama-3.1-8B attention widths)",
        requests=len(reqs), prompt_tokens=prompt_tokens,
        generated_tokens=gen_tokens, ticks=engine.step_count,
        evictions=sum(r.evictions for r in reqs), setup_s=setup_s,
        wall_s=wall, generated_tokens_per_s=gen_tokens / wall,
        total_tokens_per_s=(prompt_tokens + gen_tokens) / wall,
        kernel_launches={k: counts[k] for k in ("ffa_fwd", "paged_decode")},
        plain_calls={k: counts[k] for k in ("sdpa_attn", "paged_decode_plain")},
        oracle_max_abs_err=worst_abs, oracle_rel_norm_err=worst_rn,
        cpu_max_abs_err=cpu_abs, cpu_rel_norm_err=cpu_rn,
        atol=SERVE_ATOL, rnorm=SERVE_RNORM,
    )
    emit({"phase": "serve", **res})
    emit({"phase": "serve_profile", **serve_profile(model, config, requests)})
    return res


def serve_profile(model, config, make_requests) -> dict:
    """The same serve run once more under ``torch.profiler``: device time
    by kernel, device busy time against the wall (the profiler's own cost
    inflates the wall, so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from magiattention_tpu_torch.serving import ServeEngine

    reqs = make_requests(model)
    engine = ServeEngine(model, config)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((e.key, us, e.count))
    kernels.sort(key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    return dict(
        wall_s=wall, device_busy_s=busy_s,
        idle_share=1.0 - busy_s / wall if wall > 0 else None,
        ticks=engine.step_count,
        top_kernels=[
            {"name": k[:90], "device_ms": us / 1e3, "count": c}
            for k, us, c in kernels[:12]
        ],
    )


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from magiattention_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1

    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for src in _build.SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[{src}] {line.strip()}", file=sys.stderr)
    emit({
        "phase": "device", "name": name, "nvidia_smi": smi,
        "driver": nvidia_smi("driver_version"), "torch": torch.__version__,
        "cuda": torch.version.cuda, "peaks_for": peaks["form"],
        "peak_bf16_tflops": peaks["bfloat16"] / 1e12,
        "peak_f32_tflops": peaks["float32"] / 1e12,
        "peak_tb_s": peaks["bytes_s"] / 1e12, "build_s": build_s,
    })

    ffa = ffa_phase(peaks)
    dec = decode_phase(peaks)
    edge_phase()
    serve = serve_phase()

    a, d32 = ffa[0], dec[0]
    emit({"kernels": [
        {
            "name": "ffa_fwd", "route": "cuda",
            "source": "magiattention_tpu_torch/csrc/ffa_fwd.cu",
            "replaces": "magiattention_tpu/kernels/ffa.py:251",
            "launches": serve["kernel_launches"]["ffa_fwd"],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        },
        {
            "name": "paged_decode", "route": "cuda",
            "source": "magiattention_tpu_torch/csrc/paged_decode.cu",
            "replaces": "magiattention_tpu/kernels/paged_decode.py:71",
            "launches": serve["kernel_launches"]["paged_decode"],
            "max_abs_err": d32["max_abs_err"], "ms": d32["ms"],
            "plain_ms": d32["plain_ms"], "bound_ms": d32["bound_ms"],
            "bound_by": d32["bound_by"], "library_ms": None,
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
