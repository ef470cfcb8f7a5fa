#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and context-parallel paths on
one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the port's kernels from ``csrc/`` first.
To iterate on one kernel, call its phase alone (kernels build at first
use), e.g. ``python3 -c "import torch, chip_smoke as c;
c.ffa_bwd_phase(c.card_peaks(torch.cuda.get_device_name(0)))"``.

Phases, each printing JSON lines (any failure raises, exit code != 0):

1. ``device``: the card's name, power limit and NVIDIA driver version,
   and the build time.
2. ``ffa_fwd``: the FFA forward kernel against its plain version
   (``sdpa_attn``) at (a) the serving prefill shape, (b) the bf16 causal
   headline shape and (c) a bf16 varlen mask with uncovered rows.
3. ``ffa_bwd``: the split backward kernels (delta, dq, dk/dv) against their
   plain versions at (a) the bf16 causal headline shape, (b) the bf16
   varlen mask, (c) float32 at the serving prefill shape and (d) the train
   phase's attention shape, plus the whole forward + backward of
   ``ffa_attn`` against SDPA's.
4. ``ffa_bwd_fused``: the fused one-pass backward kernel at the same four
   shapes, against its plain version and against the split kernels.
5. ``paged_decode``: the paged-decode kernel against ``paged_decode_plain``
   on 8 ragged slots, in float32 and bfloat16.
6. ``edge_cases``: head_dim 64, ragged tiles, softcap, g = 1 and 8, other
   page sizes, a k tile no slice reaches and uncovered rows, forward and
   gradients (both backward modes), kernel against plain version (not
   timed).
7. ``serve``: ``ServeEngine`` at Llama-3.1-8B attention widths on 16
   requests; every generated row is held against the sequential replay
   oracle (FFA kernel) on the card, the first two requests against the
   port's own engine on the CPU, and the kernels' launch counters must have
   risen while the plain versions were never called. ``serve_profile``:
   the serve run again under ``torch.profiler``.
8. ``cp_api``: ``magi_attn_flex_key -> dispatch -> calc_attn ->
   undispatch`` at cp = 1, forward and backward, at the train phase's
   attention shape, against ``flex_flash_attn_func``.
9. ``cp_stages``: the multi-stage compute (``multi_ffa`` over the host and
   remote kv parts, lse merge, per-part backward) of every rank of a
   cp = 4, overlap-degree-2 plan, against the plain dense reference.
10. ``train``: ``models.llama.train_step`` through the API at
    Llama-3.1-8B widths, depth cut to 2 layers, bf16 over float32 master
    weights, 8192 packed tokens in two causal documents: 3 SGD steps under
    the fused backward and one under the split pin; launch counts per
    step, one step under ``torch.profiler``, and a kernel-vs-plain check
    of loss and gradients at 2048 tokens.
11. ``kernels``: one line per-kernel summary (launches from the serve or
    train phase, error, kernel / plain / library time and the card's
    bound).

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


def mask_cases() -> dict[str, dict]:
    """The masks and shapes the FFA phases run (head_dim 128)."""
    import torch

    from magiattention_tpu_torch.kernels.mask_utils import BAND_INF, types_to_bands

    S = 8192
    causal = types_to_bands(np.array([[0, S]]), np.array([[0, S]]), np.array([1]))
    qr = np.array([[0, 3072], [3072, 6144], [6144, 7168], [7168, 7680]])
    kr = np.array([[0, 3072], [3072, 6144], [6144, 7168], [6144, 7680]])
    docs = np.array([[0, S // 2], [S // 2, S]])
    return {
        # serving prefill chunk: 512 queries at positions 1536.. over the
        # 4096 gathered rows of a 256-page table, kv_len 2048
        "serving_prefill_f32": dict(
            dtype=torch.float32, sq=512, sk=4096, hq=32, hk=8,
            qr=[[0, 512]], kr=[[0, 2048]], lo=[-BAND_INF], hi=[1536],
            unreached_k=(2048, 4096),
        ),
        # bench.py headline shape
        "causal_8192_bf16": dict(
            dtype=torch.bfloat16, sq=S, sk=S, hq=16, hk=8, qr=[[0, S]],
            kr=[[0, S]], lo=causal[0], hi=causal[1], library="causal",
        ),
        # varlen: two block-causal documents, an INVCAUSAL slice, a
        # BICAUSAL (sliding-band) slice and uncovered rows [7680, 8192)
        "varlen_8192_bf16": dict(
            dtype=torch.bfloat16, sq=S, sk=S, hq=16, hk=8, qr=qr, kr=kr,
            lo=types_to_bands(qr, kr, np.array([1, 1, 2, 3]))[0],
            hi=types_to_bands(qr, kr, np.array([1, 1, 2, 3]))[1],
            uncovered=(7680, 8192),
        ),
        # the train phase's attention: Llama-3.1-8B heads, two causal
        # documents of 4096 (the README quick-start mask)
        "train_docs_8192_bf16": dict(
            dtype=torch.bfloat16, sq=S, sk=S, hq=32, hk=8, qr=docs, kr=docs,
            lo=types_to_bands(docs, docs, np.array([1, 1]))[0],
            hi=types_to_bands(docs, docs, np.array([1, 1]))[1],
        ),
    }


def case_inputs(c: dict, gen, with_do: bool = False):
    """Random q, k, v (and dO) of a mask case, its plan and params."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import FFAParams, default_blocks
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    dt, d = c["dtype"], 128
    shapes = [(c["sq"], c["hq"], d), (c["sk"], c["hk"], d), (c["sk"], c["hk"], d)]
    if with_do:
        shapes.append((c["sq"], c["hq"], d))
    tensors = [torch.randn(sh, generator=gen, device="cuda").to(dt) for sh in shapes]
    qr, kr = np.asarray(c["qr"], np.int32), np.asarray(c["kr"], np.int32)
    lo, hi = np.asarray(c["lo"], np.int32), np.asarray(c["hi"], np.int32)
    bq, bk = default_blocks(c["sq"], c["sk"])
    plan = get_ffa_plan(qr, kr, lo, hi, c["sq"], c["sk"], bq, bk)
    params = FFAParams(
        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
        block_q=bq, block_k=bk, softmax_scale=d ** -0.5, softcap=0.0,
    )
    return tensors, (qr, kr, lo, hi), plan, params


def ffa_phase(peaks: dict) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from magiattention_tpu_torch.kernels.ffa import ffa_fwd_kernel
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    gen = torch.Generator(device="cuda").manual_seed(0)
    all_cases = mask_cases()
    cases = [
        dict(all_cases[key], name=name) for key, name in (
            ("serving_prefill_f32", "a_serving_prefill_f32"),
            ("causal_8192_bf16", "b_causal_8192_bf16"),
            ("varlen_8192_bf16", "c_varlen_8192_bf16"),
        )
    ]

    results = []
    for c in cases:
        dt, d = c["dtype"], 128
        dname = str(dt).removeprefix("torch.")
        (q, k, v), (qr, kr, lo, hi), plan, params = case_inputs(c, gen)
        scale = params.softmax_scale

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


def grad_check(name: str, got, want, dtype: str) -> dict:
    """Max abs and rel-norm error of a kernel's result against its plain
    version; raises if it is not finite or beyond the dtype's tolerance."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel result is not finite")
    a, b = got.double(), want.double()
    err = {
        "max_abs_err": (a - b).abs().max().item(),
        "rel_norm_err": ((a - b).norm() / b.norm().clamp_min(1e-30)).item(),
    }
    atol, rnorm = ATOL[dtype], RNORM[dtype]
    if not (err["max_abs_err"] <= atol and err["rel_norm_err"] <= rnorm):
        raise AssertionError(
            f"{name}: kernel vs plain {err} beyond atol {atol}, rel-norm {rnorm}"
        )
    return err


def ffa_bwd_phase(peaks: dict) -> dict[str, dict]:
    """The backward kernels against their plain versions, on the same
    inputs (the forward kernel's out and lse, the plain delta). Bounds:
    delta is bytes; dq does 3 tile products (S, dP, dS K), 6 flops per live
    pair per head and d; dk/dv 4 (S, dP, P^T dO, dS^T Q), 8 flops. The
    whole backward's bound is bench.py's count, 2.5/3.5 of its fwd + bwd
    4 * pairs * d * hq * 3.5, i.e. 10 flops per live pair per head and d."""
    import torch
    import torch.nn.functional as F

    from magiattention_tpu_torch.kernels.ffa import (
        ffa_attn, ffa_bwd_dkv_kernel, ffa_bwd_dkv_plain, ffa_bwd_dq_kernel,
        ffa_bwd_dq_plain, ffa_delta_kernel, ffa_delta_plain, ffa_fwd_kernel,
    )
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band

    gen = torch.Generator(device="cuda").manual_seed(3)
    all_cases = mask_cases()
    results = {}
    for key, name in (
        ("causal_8192_bf16", "a_causal_8192_bf16"),
        ("varlen_8192_bf16", "b_varlen_8192_bf16"),
        ("serving_prefill_f32", "c_serving_prefill_f32"),
        ("train_docs_8192_bf16", "d_train_docs_8192_bf16"),
    ):
        c = all_cases[key]
        d = 128
        dname = str(c["dtype"]).removeprefix("torch.")
        (q, k, v, do), (qr, kr, lo, hi), plan, params = case_inputs(c, gen, with_do=True)
        out, lse = ffa_fwd_kernel(q, k, v, plan, params)
        delta = ffa_delta_plain(out, do)
        args = (q, k, v, do, lse, delta, plan, params)
        err = {
            "ffa_bwd_delta": grad_check(
                f"{name} delta", ffa_delta_kernel(out, do), delta, dname),
            "ffa_bwd_dq": grad_check(
                f"{name} dq", ffa_bwd_dq_kernel(*args), ffa_bwd_dq_plain(*args), dname),
        }
        (dk, dv), (dk_p, dv_p) = ffa_bwd_dkv_kernel(*args), ffa_bwd_dkv_plain(*args)
        ek = grad_check(f"{name} dk", dk, dk_p, dname)
        ev = grad_check(f"{name} dv", dv, dv_p, dname)
        err["ffa_bwd_dkv"] = {m: max(ek[m], ev[m]) for m in ek}
        del dk_p, dv_p
        if "uncovered" in c:
            r0, r1 = c["uncovered"]
            if ffa_bwd_dq_kernel(*args)[r0:r1].any():
                raise AssertionError(f"{name}: dq of uncovered rows is not 0")
        if "unreached_k" in c:
            r0, r1 = c["unreached_k"]
            if dk[r0:r1].any() or dv[r0:r1].any():
                raise AssertionError(f"{name}: dk/dv of unreached k rows are not 0")
        torch.cuda.synchronize()

        mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
        live = int(mask.sum().item())
        isz, hq = q.element_size(), c["hq"]
        n_q, n_kv, rows = q.numel(), k.numel(), c["sq"] * c["hq"]
        in_bytes = (2 * n_q + 2 * n_kv) * isz + 2 * rows * 4  # q k v dO lse delta
        kernels = {
            "ffa_bwd_delta": (
                lambda: ffa_delta_kernel(out, do), lambda: ffa_delta_plain(out, do),
                2.0 * n_q, 2 * n_q * isz + rows * 4,
            ),
            "ffa_bwd_dq": (
                lambda: ffa_bwd_dq_kernel(*args), lambda: ffa_bwd_dq_plain(*args),
                6.0 * hq * d * live, in_bytes + n_q * 4,
            ),
            "ffa_bwd_dkv": (
                lambda: ffa_bwd_dkv_kernel(*args), lambda: ffa_bwd_dkv_plain(*args),
                8.0 * hq * d * live, in_bytes + 2 * n_kv * 4,
            ),
        }
        res = dict(
            case=name, dtype=dname, q=list(q.shape), kv=list(k.shape),
            live_pairs=live, work_items=plan.num_work,
            work_items_t=plan.num_work_t, atol=ATOL[dname], rnorm=RNORM[dname],
        )
        total_ms = 0.0
        for kname, (kern, plain, flops, nbytes) in kernels.items():
            b_ms, b_by = bound(flops, nbytes, dname, peaks)
            ms = time_ms(kern)
            total_ms += ms
            res[kname] = dict(
                **err[kname], ms=ms, plain_ms=time_ms(plain, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                tflops=flops / (ms * 1e-3) / 1e12,
            )
        res["bwd_kernels_ms"] = total_ms
        res["bwd_bound_ms"], res["bwd_bound_by"] = bound(
            10.0 * hq * d * live, in_bytes + (n_q + 2 * n_kv) * 4, dname, peaks
        )

        # whole forward + backward: ffa_attn (kernels) against SDPA
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        def ffa_fwd_bwd():
            o, _ = ffa_attn(qg, kg, vg, qr, kr, d_lo=lo, d_hi=hi)
            torch.autograd.grad(o, (qg, kg, vg), do)

        res["ffa_fwd_bwd_ms"] = time_ms(ffa_fwd_bwd, samples=5)
        res["fwd_bwd_bound_ms"] = bound(
            14.0 * hq * d * live, (3 * n_q + 2 * n_kv) * isz + in_bytes, dname, peaks
        )[0]
        sdpa_kw = (
            dict(is_causal=True) if c.get("library") == "causal"
            else dict(attn_mask=mask)
        )

        def sdpa_fwd_bwd():
            qt, kt, vt = (t.transpose(0, 1)[None] for t in (qg, kg, vg))
            o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)
            torch.autograd.grad(o, (qg, kg, vg), do.transpose(0, 1)[None])

        # SDPA gives NaN on rows a bool mask leaves empty; it is timed only
        res["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, samples=5)
        res["sdpa_fwd_bwd_call"] = (
            "scaled_dot_product_attention(" + ("is_causal=True" if "is_causal" in sdpa_kw
                                              else "attn_mask=bool") + ", enable_gqa=True)"
        )
        emit({"phase": "ffa_bwd", **res})
        results[name] = res
        del mask, qg, kg, vg
        torch.cuda.empty_cache()
    return results


def ffa_bwd_fused_phase(peaks: dict, bwd: dict) -> dict[str, dict]:
    """The fused one-pass backward kernel at the ``ffa_bwd`` shapes, on the
    same kind of inputs: against its plain version and against the split
    kernels (dq, dk/dv), both within the dtype's tolerance. Asserts that
    uncovered rows get dq exactly 0 and unreached k rows dk = dv = 0. Bound:
    10 flops per live pair per head and d (its 5 tile products); the
    library time is SDPA's forward + backward from the ``ffa_bwd`` phase.
    Atomic traffic: one 64 x d float32 read-modify-write per (work item, q
    head)."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import (
        ffa_bwd_dkv_kernel, ffa_bwd_dq_kernel, ffa_bwd_fused_convert,
        ffa_bwd_fused_kernel, ffa_bwd_fused_plain, ffa_bwd_mode,
        ffa_delta_plain, ffa_fwd_kernel,
    )
    from magiattention_tpu_torch.kernels.ffa_plan import QE, QS
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band

    gen = torch.Generator(device="cuda").manual_seed(5)
    all_cases = mask_cases()
    results = {}
    for key, name in (
        ("causal_8192_bf16", "a_causal_8192_bf16"),
        ("varlen_8192_bf16", "b_varlen_8192_bf16"),
        ("serving_prefill_f32", "c_serving_prefill_f32"),
        ("train_docs_8192_bf16", "d_train_docs_8192_bf16"),
    ):
        c = all_cases[key]
        d = 128
        dname = str(c["dtype"]).removeprefix("torch.")
        (q, k, v, do), (qr, kr, lo, hi), plan, params = case_inputs(c, gen, with_do=True)
        out, lse = ffa_fwd_kernel(q, k, v, plan, params)
        delta = ffa_delta_plain(out, do)
        args = (q, k, v, do, lse, delta, plan, params)
        fused = ffa_bwd_fused_kernel(*args)
        plain = ffa_bwd_fused_plain(*args)
        split = (ffa_bwd_dq_kernel(*args), *ffa_bwd_dkv_kernel(*args))
        torch.cuda.synchronize()
        err, err_split = {}, {}
        for i, g in enumerate(("dq", "dk", "dv")):
            err[g] = grad_check(f"{name} fused {g}", fused[i], plain[i], dname)
            err_split[g] = grad_check(f"{name} fused vs split {g}", fused[i], split[i], dname)
        del plain, split
        if "uncovered" in c:
            r0, r1 = c["uncovered"]
            if fused[0][r0:r1].any():
                raise AssertionError(f"{name}: fused dq of uncovered rows is not 0")
        if "unreached_k" in c:
            r0, r1 = c["unreached_k"]
            if fused[1][r0:r1].any() or fused[2][r0:r1].any():
                raise AssertionError(f"{name}: fused dk/dv of unreached k rows are not 0")

        mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
        live = int(mask.sum().item())
        del mask
        isz, hq = q.element_size(), c["hq"]
        n_q, n_kv, rows = q.numel(), k.numel(), c["sq"] * c["hq"]
        in_bytes = (2 * n_q + 2 * n_kv) * isz + 2 * rows * 4
        flops = 10.0 * hq * d * live
        b_ms, b_by = bound(flops, in_bytes + (n_q + 2 * n_kv) * 4, dname, peaks)
        ms = time_ms(lambda: ffa_bwd_fused_kernel(*args))
        ws = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        convert_ms = time_ms(lambda: ffa_bwd_fused_convert(ws, 1.0))
        real_items = int((plan.meta_t[:, QE] > plan.meta_t[:, QS]).sum())
        res = dict(
            case=name, dtype=dname, q=list(q.shape), kv=list(k.shape),
            live_pairs=live, work_items_t=plan.num_work_t,
            cost_model_mode=ffa_bwd_mode(plan, params, d, d, isz, hq // c["hk"]),
            vs_plain=err, vs_split=err_split,
            max_abs_err=max(e["max_abs_err"] for e in err.values()),
            ms=ms, convert_ms=convert_ms,
            plain_ms=time_ms(lambda: ffa_bwd_fused_plain(*args), warmup=1),
            split_ms=bwd[name]["ffa_bwd_dq"]["ms"] + bwd[name]["ffa_bwd_dkv"]["ms"],
            bound_ms=b_ms, bound_by=b_by,
            library_ms=bwd[name]["sdpa_fwd_bwd_ms"],
            library_call=bwd[name]["sdpa_fwd_bwd_call"] + " forward + backward",
            tflops=flops / (ms * 1e-3) / 1e12,
            atomic_rmw_bytes=real_items * hq * 64 * d * 4 * 2,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        emit({"phase": "ffa_bwd_fused", **res})
        results[name] = res
        del fused, ws
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
    head_dim 64, a ragged last q and k tile, softcap, g = 1 and g = 8, a k
    tile no slice reaches and uncovered rows (forward and gradients), a
    page size below and above the 64-token chunk."""
    import torch

    from magiattention_tpu_torch.env.general import scoped_env
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
    # gradients, kernels (through ffa_attn's autograd.Function) against
    # sdpa_attn's autograd: k rows [203, 256) no live pair touches, the
    # ragged k tile [256, 260) no slice reaches (dk/dv exactly 0 in both),
    # uncovered q rows [200, 230) (dq exactly 0). dO is scaled by 1/4 so
    # the gradients stay below 2, where one bf16 ulp (both sides round
    # their float32 gradients to bf16) is below the bf16 atol.
    for d, hq, hk, dt, softcap in (
        (64, 6, 3, torch.float32, 30.0),
        (64, 4, 4, torch.bfloat16, 0.0),
        (128, 8, 1, torch.float32, 0.0),
        (128, 16, 2, torch.bfloat16, 30.0),
    ):
        dname = str(dt).removeprefix("torch.")
        inputs = [
            torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((230, hq, d), (260, hk, d), (260, hk, d))
        ]
        do = (torch.randn((230, hq, d), generator=gen, device="cuda") / 4).to(dt)

        def grads_of(attn):
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out, _ = attn(*leaves, qr, kr, attn_type_map=types, softcap=softcap)
            return torch.autograd.grad(out, leaves, do)

        want = grads_of(sdpa_attn)
        for pin in ("split", "fused"):  # both backward modes, pinned
            with scoped_env({"MAGI_ATTENTION_BACKEND_FFA_BWD": pin}):
                got = grads_of(ffa_attn)
            name = f"grad_{pin}_d{d}_g{hq // hk}_{dname}_cap{softcap:g}"
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                err = grad_check(f"{name} {gname}", a.float(), b.float(), dname)
                worst[f"{name}_{gname}"] = err["max_abs_err"]
            dq, dk, dv = got
            if dq[200:].any() or dk[203:].any() or dv[203:].any():
                raise AssertionError(f"{name}: gradients of untouched rows are not 0")
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


def profile_run(fn) -> dict:
    """``fn()`` under ``torch.profiler``: device time by kernel, device
    busy time against the wall (the profiler's own cost inflates the wall,
    so the idle share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        top_kernels=[
            {"name": k[:90], "device_ms": us / 1e3, "count": c}
            for k, us, c in kernels[:12]
        ],
    )


def serve_profile(model, config, make_requests) -> dict:
    """The same serve run once more under ``torch.profiler``."""
    from magiattention_tpu_torch.serving import ServeEngine

    reqs = make_requests(model)
    engine = ServeEngine(model, config)
    res = profile_run(lambda: engine.run(reqs))
    return dict(res, ticks=engine.step_count)


# the train phase's attention: Llama-3.1-8B heads, two causal documents
CP_SEQ, CP_DOC, CP_HQ, CP_HK, CP_D = 8192, 4096, 32, 8, 128


def _docs(seq: int, doc: int) -> list[list[int]]:
    return [[s, s + doc] for s in range(0, seq, doc)]


def _bwd_kernels(mode: str) -> tuple[str, ...]:
    return ("ffa_bwd_fused",) if mode == "fused" else ("ffa_bwd_dq", "ffa_bwd_dkv")


def cp_api_phase() -> dict:
    """The user path ``magi_attn_flex_key -> dispatch -> calc_attn ->
    undispatch`` at cp = 1 on the card, forward and backward, at the train
    phase's attention shape (bf16), against ``flex_flash_attn_func`` on
    the same inputs. Reports the backward mode the port resolved and the
    kernels the path launched (counts reset just before it)."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.functional import flex_flash_attn_func
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode

    docs = _docs(CP_SEQ, CP_DOC)
    gen = torch.Generator(device="cuda").manual_seed(11)
    shapes = ((CP_SEQ, CP_HQ, CP_D), (CP_SEQ, CP_HK, CP_D), (CP_SEQ, CP_HK, CP_D))
    inputs = [torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes]
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    t0 = time.perf_counter()
    key = api.magi_attn_flex_key(docs, docs, [1, 1], CP_SEQ, CP_SEQ)
    plan_s = time.perf_counter() - t0
    runtime = _mgr(key).runtime
    plan = runtime.plans[0]
    mode = ffa_bwd_mode(plan, runtime._params(CP_D)[0], CP_D, CP_D, 2, CP_HQ // CP_HK)

    def api_path():
        q, k, v = (t.detach().requires_grad_(True) for t in inputs)
        out_d, meta = api.calc_attn(
            api.dispatch(q, key), api.dispatch(k, key, role="kv"),
            api.dispatch(v, key, role="kv"), key,
        )
        out = api.undispatch(out_d, key)
        return (out, *torch.autograd.grad(out, (q, k, v), do))

    def direct_path():
        q, k, v = (t.detach().requires_grad_(True) for t in inputs)
        out, _ = flex_flash_attn_func(q, k, v, np.array(docs), np.array(docs), np.array([1, 1]))
        return (out, *torch.autograd.grad(out, (q, k, v), do))

    torch.cuda.synchronize()
    reset_launch_counts()
    got = api_path()
    torch.cuda.synchronize()
    counts = launch_counts()
    want = direct_path()
    err = {
        name: grad_check(f"cp_api {name}", a.float(), b.float(), "bfloat16")
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)
    }
    expected = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels(mode))
    if any(counts[k] != 1 for k in expected) or any(counts[k] for k in PLAIN_NAMES):
        raise AssertionError(f"cp_api: launched {counts}, want one of each of {expected}")
    res = dict(
        shape=f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}, two causal documents",
        cp=1, resolved_bwd_mode=mode, plan_s=plan_s, work_items=plan.num_work,
        launches={k: v for k, v in counts.items() if v}, vs_flex_flash_attn=err,
        fwd_bwd_ms=time_ms(api_path, samples=5),
        flex_flash_attn_fwd_bwd_ms=time_ms(direct_path, samples=5),
        atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"],
    )
    emit({"phase": "cp_api", **res})
    return res


def cp_stages_phase() -> dict:
    """The multi-stage compute of a cp = 4, overlap-degree-2 plan at the
    train phase's attention shape (bf16), for each rank, on this one card:
    the port's ``multi_ffa`` gets the rank's dispatched q, its own kv shard
    and each stage's receive buffer, gathered here from the full tensors by
    the stage's send indices (exactly the rows the GroupCast delivers; the
    collectives themselves are held on the CPU by tests/test_torch_cp.py).
    Each rank's out, lse and gradients are held against the plain dense
    reference (``sdpa_attn``, and ``ffa_bwd_fused_plain`` over the global
    mask with dO on that rank's rows only)."""
    import torch

    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig
    from magiattention_tpu_torch.functional.dist_attn import DistAttnRuntime, multi_ffa
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import (
        ffa_bwd_fused_plain, ffa_bwd_mode, ffa_delta_plain, plan_params,
    )
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn
    from magiattention_tpu_torch.meta import (
        make_attn_meta_from_dispatch_meta, make_dispatch_meta_from_qk_ranges,
    )

    cp, degree, chunk = 4, 2, 512
    docs = _docs(CP_SEQ, CP_DOC)
    config = DistAttnConfig(overlap_config=OverlapConfig(degree=degree))
    t0 = time.perf_counter()
    mq, mkv, bucket = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(docs), AttnRanges.from_ranges(docs),
        [AttnMaskType.CAUSAL] * 2, CP_SEQ, CP_SEQ, chunk, cp, config.dispatch_config,
    )
    comm, calc = make_attn_meta_from_dispatch_meta(bucket, mq, config, dispatch_meta_kv=mkv)
    plan_s = time.perf_counter() - t0
    if len(comm.kv_stages) != degree:
        raise AssertionError(f"cp_stages: {len(comm.kv_stages)} stages, want {degree}")

    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = ((CP_SEQ, CP_HQ, CP_D), (CP_SEQ, CP_HK, CP_D), (CP_SEQ, CP_HK, CP_D))
    q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes)
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    qr, kr, types = np.array(docs), np.array(docs), np.array([1, 1])
    with torch.no_grad():
        out_ref, lse_ref = sdpa_attn(q, k, v, qr, kr, types)
    gplan, gparams = plan_params(qr, kr, types, None, None, CP_SEQ, CP_SEQ, CP_D, None, 0.0)
    pos = [torch.as_tensor(p, dtype=torch.int64, device="cuda") for p in mq.position_ids]
    pos_kv = [torch.as_tensor(p, dtype=torch.int64, device="cuda") for p in mkv.position_ids]

    ranks = []
    for r in range(cp):
        runtime = DistAttnRuntime(comm, calc, cp_rank=r, use_overlap=True)
        parts_k, parts_v, rows = [k[pos_kv[r]]], [v[pos_kv[r]]], [pos_kv[r]]
        for stage, cast in zip(comm.kv_stages, runtime.cast_plans):
            src_rows = torch.cat([
                pos_kv[s][torch.as_tensor(
                    stage.send_idx[s, r, : stage.send_counts[s, r]], dtype=torch.int64,
                    device="cuda",
                )]
                for s in range(cp)
            ])
            bk_, bv_ = (t.new_zeros((cast.buf_len, CP_HK, CP_D)) for t in (k, v))
            bk_[: len(src_rows)], bv_[: len(src_rows)] = k[src_rows], v[src_rows]
            parts_k.append(bk_)
            parts_v.append(bv_)
            rows.append(src_rows)
        leaves_q = q[pos[r]].detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(True) for t in (*parts_k, *parts_v)]
        n = len(parts_k)
        torch.cuda.synchronize()
        reset_launch_counts()
        out_r, lse_r = multi_ffa(
            leaves_q, leaves[:n], leaves[n:], runtime.plans, runtime._params(CP_D)
        )
        grads = torch.autograd.grad(out_r, (leaves_q, *leaves), do[pos[r]])
        torch.cuda.synchronize()
        counts = launch_counts()
        if any(counts[p] for p in PLAIN_NAMES) or counts["ffa_fwd"] != n:
            raise AssertionError(f"cp_stages rank {r}: launched {counts}")

        # reference gradients: dO on this rank's rows only
        do_r = torch.zeros_like(do)
        do_r[pos[r]] = do[pos[r]]
        delta = ffa_delta_plain(out_ref, do_r)
        dq_ref, dk_ref, dv_ref = ffa_bwd_fused_plain(
            q, k, v, do_r, lse_ref, delta, gplan, gparams
        )
        dk_got = torch.zeros_like(dk_ref)
        dv_got = torch.zeros_like(dv_ref)
        for i, idx in enumerate(rows):
            dk_got.index_add_(0, idx, grads[1 + i][: len(idx)].float())
            dv_got.index_add_(0, idx, grads[1 + n + i][: len(idx)].float())
        err = {
            "out": grad_check(f"cp_stages r{r} out", out_r.float(), out_ref[pos[r]], "bfloat16"),
            "lse": grad_check(f"cp_stages r{r} lse", lse_r, lse_ref[pos[r]], "bfloat16"),
            "dq": grad_check(f"cp_stages r{r} dq", grads[0].float(), dq_ref[pos[r]], "bfloat16"),
            "dk": grad_check(f"cp_stages r{r} dk", dk_got, dk_ref, "bfloat16"),
            "dv": grad_check(f"cp_stages r{r} dv", dv_got, dv_ref, "bfloat16"),
        }
        del dq_ref, dk_ref, dv_ref, delta, do_r
        torch.cuda.empty_cache()
        ranks.append(dict(
            rank=r, stages=runtime.num_stages,
            part_rows=[int(parts_k[0].shape[0])] + [
                dict(valid=c.recv_len, buffer=c.buf_len) for c in runtime.cast_plans
            ],
            bwd_modes=[
                ffa_bwd_mode(p, prm, CP_D, CP_D, 2, CP_HQ // CP_HK)
                for p, prm in zip(runtime.plans, runtime._params(CP_D))
            ],
            launches={k_: v_ for k_, v_ in counts.items() if v_},
            **{f"{name}_max_abs_err": e["max_abs_err"] for name, e in err.items()},
            **{f"{name}_rel_norm_err": e["rel_norm_err"] for name, e in err.items()},
        ))
    res = dict(
        shape=f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}, two causal documents",
        cp=cp, overlap_degree=degree, chunk_size=chunk, plan_s=plan_s,
        partitions=mq.partitions, ranks=ranks,
        atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"],
    )
    emit({"phase": "cp_stages", **res})
    return res


# meta-llama/Llama-3.1-8B config.json widths; depth cut from 32 layers
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_DOC, TRAIN_STEPS, TRAIN_LR = 2, 8192, 4096, 3, 1e-4
CHECK_SEQ, CHECK_DOC = 2048, 1024
TRAIN_LOSS_RTOL, TRAIN_GRAD_RNORM = 1e-2, 2e-2
FFA_KERNELS = ("ffa_fwd", "ffa_bwd_delta", "ffa_bwd_dq", "ffa_bwd_dkv", "ffa_bwd_fused")


def train_phase() -> dict:
    """``models.llama.train_step`` on the card, attention through the API
    (``magi_attn_flex_key`` at cp = 1, ``calc_attn`` per layer); asserts
    finite losses, one launch of each FFA kernel of the resolved backward
    mode per layer per step, no plain version on the path. The steps run
    the fused backward (the cost model's choice, or a fused pin where the
    model picks split); one more step runs under the split pin, so both
    modes have a step time. Then the kernels' loss and gradients against
    the plain path's (``MAGI_ATTENTION_KERNEL_BACKEND=sdpa``: dense float32
    attention under autograd) at CHECK_SEQ tokens: the plain path keeps
    float32 (32, S, S) tensors per layer for autograd, which at 8192
    tokens do not fit twice over on 80 GB."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels import (
        PLAIN_NAMES, launch_counts, reset_launch_counts,
    )
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode
    from magiattention_tpu_torch.models.llama import (
        LlamaConfig, init_params, param_names, train_step, value_and_grad,
    )

    cfg = LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=TRAIN_LAYERS, n_heads=32,
        n_kv_heads=8, head_dim=128, ffn_hidden=14336, rope_theta=500000.0,
        norm_eps=1e-5, dtype="bfloat16",
    )
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(
        0, cfg.vocab_size, (TRAIN_SEQ,), generator=gen, device="cuda"
    )

    def labels_of(tok, doc):
        """Next token; -100 (ignored) at each document's end."""
        labels = torch.roll(tok, -1).clone()
        labels[doc - 1 :: doc] = -100
        return labels

    def key_of(seq, doc, **env):
        docs = _docs(seq, doc)
        with scoped_env(env):
            return api.magi_attn_flex_key(docs, docs, [1] * len(docs), seq, seq)

    labels = labels_of(tokens, TRAIN_DOC)
    key = key_of(TRAIN_SEQ, TRAIN_DOC)
    runtime = _mgr(key).runtime
    model_mode = ffa_bwd_mode(
        runtime.plans[0], runtime._params(cfg.head_dim)[0], cfg.head_dim,
        cfg.head_dim, 2, cfg.n_heads // cfg.n_kv_heads,
    )
    pin = {} if model_mode == "fused" else {"MAGI_ATTENTION_BACKEND_FFA_BWD": "fused"}
    key = key_of(TRAIN_SEQ, TRAIN_DOC, **pin)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step(i, key, mode):
        before = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nonlocal params
        with scoped_env(pin if mode == "fused" else {"MAGI_ATTENTION_BACKEND_FFA_BWD": "split"}):
            params, loss = train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR)
            loss = loss.item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        kernels = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels(mode))
        rec = dict(
            step=i, bwd_mode=mode, loss=loss, ms=ms,
            tokens_per_s=TRAIN_SEQ / (ms * 1e-3),
            launches={k: v for k, v in launches.items() if v},
        )
        emit({"phase": "train_step", **rec})
        if not np.isfinite(loss):
            raise AssertionError(f"train: step {i} loss {loss} is not finite")
        others = set(FFA_KERNELS) - set(kernels)
        if any(launches[k] != cfg.n_layers for k in kernels) or any(launches[k] for k in others):
            raise AssertionError(
                f"train: step {i} launched {launches}, want {cfg.n_layers} "
                f"of each of {kernels}"
            )
        if any(launches[k] for k in PLAIN_NAMES):
            raise AssertionError(f"train: a plain version ran on the card: {launches}")
        return rec, launches

    reset_launch_counts()
    steps = [step(i, key, "fused")[0] for i in range(TRAIN_STEPS)]
    fused_counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split_key = key_of(TRAIN_SEQ, TRAIN_DOC, MAGI_ATTENTION_BACKEND_FFA_BWD="split")
    reset_launch_counts()
    split_step, _ = step(TRAIN_STEPS, split_key, "split")
    split_counts = launch_counts()

    with scoped_env(pin):
        prof = profile_run(
            lambda: train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR)
        )

    # kernels against the plain path, same weights and tokens
    tok2 = tokens[:CHECK_SEQ]
    lab2 = labels_of(tok2, CHECK_DOC)
    with scoped_env(pin):
        loss_k, g_k = value_and_grad(params, cfg, tok2, lab2, key_of(CHECK_SEQ, CHECK_DOC, **pin))
    plain_env = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}
    with scoped_env(plain_env):
        loss_p, g_p = value_and_grad(
            params, cfg, tok2, lab2, key_of(CHECK_SEQ, CHECK_DOC, **plain_env)
        )
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    grad_rn = {
        n: ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()
        for n, a, b in zip(param_names(params), g_k, g_p)
    }
    worst = max(grad_rn, key=grad_rn.get)
    if loss_rel > TRAIN_LOSS_RTOL or grad_rn[worst] > TRAIN_GRAD_RNORM:
        raise AssertionError(
            f"train: kernels vs plain loss rel {loss_rel:.3e}, worst gradient "
            f"{worst} rel-norm {grad_rn[worst]:.3e} beyond {TRAIN_LOSS_RTOL}, "
            f"{TRAIN_GRAD_RNORM}"
        )
    del g_k, g_p
    torch.cuda.empty_cache()

    res = dict(
        model=(
            "Llama-3.1-8B widths (hidden 4096, 32/8 heads, head_dim 128, "
            f"ffn 14336, vocab 128256, rope_theta 500000), {cfg.n_layers} of "
            "32 layers, bf16 compute over float32 master weights, seed 0"
        ),
        attention="api: magi_attn_flex_key (cp 1) -> dispatch -> calc_attn per layer",
        tokens=TRAIN_SEQ, documents=TRAIN_SEQ // TRAIN_DOC, lr=TRAIN_LR,
        cost_model_bwd_mode=model_mode, pin=pin, setup_s=setup_s, steps=steps,
        losses=[s["loss"] for s in steps], split_step=split_step,
        launches={k: fused_counts[k] for k in FFA_KERNELS},
        split_launches={k: split_counts[k] for k in FFA_KERNELS},
        plain_calls={k: fused_counts[k] for k in PLAIN_NAMES},
        peak_memory_gb=peak_gb, profile_step=prof,
        check=dict(
            tokens=CHECK_SEQ, documents=CHECK_SEQ // CHECK_DOC,
            loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
            loss_rel_err=loss_rel, worst_grad=worst,
            worst_grad_rel_norm_err=grad_rn[worst],
            loss_rtol=TRAIN_LOSS_RTOL, grad_rnorm=TRAIN_GRAD_RNORM,
        ),
    )
    emit({"phase": "train", **res})
    return res


def kernel_entry(name: str, source: str, replaces: str, launches: int, r: dict) -> dict:
    return {
        "name": name, "route": "cuda",
        "source": f"magiattention_tpu_torch/csrc/{source}",
        "replaces": replaces, "launches": launches,
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    }


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
    bwd = ffa_bwd_phase(peaks)
    fused = ffa_bwd_fused_phase(peaks, bwd)
    dec = decode_phase(peaks)
    edge_phase()
    serve = serve_phase()
    cp_api_phase()
    cp_stages_phase()
    train = train_phase()

    t = bwd["d_train_docs_8192_bf16"]
    emit({"kernels": [
        kernel_entry(
            "ffa_fwd", "ffa_fwd.cu", "magiattention_tpu/kernels/ffa.py:251",
            serve["kernel_launches"]["ffa_fwd"], ffa[0],
        ),
        kernel_entry(
            "paged_decode", "paged_decode.cu",
            "magiattention_tpu/kernels/paged_decode.py:71",
            serve["kernel_launches"]["paged_decode"], dec[0],
        ),
        kernel_entry(
            "ffa_bwd_delta", "ffa_bwd_delta.cu",
            "magiattention_tpu/kernels/ffa.py:1722",
            train["launches"]["ffa_bwd_delta"], t["ffa_bwd_delta"],
        ),
        kernel_entry(
            "ffa_bwd_dq", "ffa_bwd_dq.cu", "magiattention_tpu/kernels/ffa.py:751",
            train["split_launches"]["ffa_bwd_dq"], t["ffa_bwd_dq"],
        ),
        kernel_entry(
            "ffa_bwd_dkv", "ffa_bwd_dkv.cu",
            "magiattention_tpu/kernels/ffa.py:1208 and :1451",
            train["split_launches"]["ffa_bwd_dkv"], t["ffa_bwd_dkv"],
        ),
        kernel_entry(
            "ffa_bwd_fused", "ffa_bwd_fused.cu",
            "magiattention_tpu/kernels/ffa.py:1780 and :2082",
            train["launches"]["ffa_bwd_fused"], fused["d_train_docs_8192_bf16"],
        ),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
