#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, context-parallel and NSA
paths on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the port's kernels from ``csrc/`` first.
To iterate on one kernel, call its phase alone (kernels build at first
use), e.g. ``python3 -c "import torch, chip_smoke as c;
c.ffa_bwd_phase(c.card_peaks(torch.cuda.get_device_name(0)))"``.

Phases, each printing JSON lines (any failure raises, exit code != 0):

1. ``device``: the card's name, power limit and NVIDIA driver version,
   and the build time (``testing/precompile.py:precompile_kernels``: every
   library, one ``nvcc`` a source at once, and the host library);
   ``precompile``: that time, a second call's and the headline
   configuration's warm-up (``precompile_ffa``). ``tensor_cores``: per library of the tensor-core
   kernels (``ffa_fwd``, ``ffa_fwd_gqa``: bf16 and the float32 3xTF32
   body; ``ffa_bwd_dq``, ``ffa_bwd_dq_gqa``, ``ffa_bwd_dkv``,
   ``ffa_bwd_fused``: bf16), the HGMMA, HMMA and atomic (RED/ATOM) counts
   of each kernel's SASS (``cuobjdump -sass``) and each tensor-core
   instance's registers, spills and shared memory; fails if one has no
   HGMMA, has HMMA or spills, if its shared memory is not the guard's, if
   a forward library has no float32 (tf32) instance, or if a split
   (deterministic) kernel has an atomic. ``tf32_probe``: 3xTF32 on wgmma
   (``csrc/tf32_probe.cu``) at the serving prefill shape, one
   accumulator against the forward body's accumulators, beside float32
   FMA, all against float64 (fails if the body's layout loses more than
   twice float32 FMA's rms error).
2. ``ffa_fwd``: the FFA forward kernel against its plain version
   (``sdpa_attn``) at (a) the serving prefill shape (float32, also against
   a float64 run beside the float32 plain version's own error, the bound
   that of three tf32 products a pair beside float32 FMA's), (b) the bf16
   causal headline shape, (c) a bf16 varlen mask with uncovered rows and
   (d) the train phase's attention shape.
3. ``ffa_bwd``: the split backward kernels (delta, dq, dk/dv) against their
   plain versions at (a) the bf16 causal headline shape, (b) the bf16
   varlen mask, (c) float32 at the serving prefill shape and (d) the train
   phase's attention shape, plus the whole forward + backward of
   ``ffa_attn`` against SDPA's, and SDPA's backward alone where every row
   is covered (with the split pair's ratio to it), and whether the split
   dk/dv equal the fused kernel's to the bit.
4. ``ffa_bwd_fused``: the fused one-pass backward kernel at the same four
   shapes, against its plain version and against the split kernels.
   ``ffa_fwd_gqa`` / ``ffa_bwd_dq_gqa``: the GQA-packed forward and dq
   kernels against their plain versions and, bit for bit, against the
   unpacked kernels, over group sizes 2, 4, 8, head dims 64 and 128,
   float32 and bf16, causal, varlen and train-docs masks (the guard's
   heads per CTA printed). ``max_logits``: the forward's max-logits output
   against ``dense_max_logits``, softcap off and on, and its cost.
   ``bwd_mode``: the unpinned backward mode against the fused and split
   times, taken together in interleaved rounds, at the four shapes and a
   sink-window mask (fails where the model picks the slower by more than
   5%), and the model's constants from this run. ``kernel_audit`` (after
   ``tiles``): ``analysis/kernel_check.py``'s K1 over every library (FFA,
   decode, block-sparse: each ``<name>_smem_bytes`` against the host
   model, 0 where not compiled, within the card's opt-in limit), then K3
   and K5 over the corpus.
5. ``paged_decode``: the paged-decode kernel against ``paged_decode_plain``
   on 8 ragged slots, in float32 and bfloat16, with the split plan it
   launched (``splits``, ``split_len``). ``paged_decode_spec``: the
   speculative-verify kernel on the same slots, spec_k 2 and 4 (8, 16 and
   32 rows per CTA), against ``paged_decode_spec_plain``, bit for bit
   against the paged-decode kernel at spec_k 1. ``paged_decode_int8``: the
   int8 kernel over pages written by the port's own append, q float32 and
   bf16, against ``paged_decode_int8_plain``; ``int8_append``: the
   wave-batched quantized append of 512 rows against the row-by-row loop,
   bit for bit. Their ``ms`` is the time per call, host included
   (:func:`time_ms`, as for every kernel), ``device_ms`` the device time
   from a CUDA graph with a cold L2 (:func:`graph_ms`).
   ``decode_split_edges``: B10, B11 and B12 at slot lengths around the
   split length and the full table, spec rows ending in an earlier split,
   against the plain versions, two launches equal to the bit (not timed).
   ``decode_long_slot``: one live 4096-token slot of eight, the case only
   the split moves (B10, B11, B12), timed beside the 8-slot case.
   ``decode_sass``: every instance of the split walk in B10, B11 and B12
   shows LDGSTS (cp.async) and no spill.
6. ``edge_cases``: head_dim 64, ragged tiles, softcap, g = 1 and 8, other
   page sizes, a k tile no slice reaches and uncovered rows, forward and
   gradients (both backward modes), kernel against plain version (not
   timed); and ROADMAP C4's and C4b's head dims (d 32, d 96, d 64 with dv
   128, d 256, d 192 with dv 128, d 256 with dv 128, padded to the
   kernels' widths) through FFA (the packed forward where its guard
   admits the width), B10-B12 and B13/B14, a d of 320 raising in each
   family.
7. ``serve``: ``ServeEngine`` at Llama-3.1-8B attention widths on 16
   requests; every generated row is held against the sequential replay
   oracle (FFA kernel) on the card, the first two requests against the
   port's own engine on the CPU, and the kernels' launch counters must have
   risen while the plain versions were never called. ``serve_profile``:
   the serve run again under ``torch.profiler``. ``serve_spec``: the same
   requests with ``spec_tokens = 4`` (greedy draft; the oracle draft's
   accept rate reported), held against the same replay. ``serve_int8``: the
   same requests on an int8 cache, held against the int8 replay, the CPU
   int8 engine and (within the quantization bound) the float32 rows.
   ``serve_int8`` also runs at ``spec_tokens = 4`` (verify through the
   dequantized gather + B1, held to the int8 bound of the int8 replays).
   ``serve_pinned``: ``serve``, ``serve_spec`` (greedy and oracle drafts)
   and ``serve_int8`` under MAGI_ATTENTION_BACKEND_SERVE_DECODE=gather_ffa,
   every row equal to its replay's to the bit, the oracle draft's accept
   rate, and whether B1's multi-row call equals its single-row calls.
   ``decode_sharded``: the head-sharded step (B10 once per kv-head shard)
   at the decode phase's shape with 2, 4 and 8 shards on this card, equal
   to the unsharded step to the bit, ms beside it; ``ServeEngine`` with
   ``decode_shards=2`` on one card takes the next feasible rung.
   ``serve_profile``, ``serve_spec_profile`` and ``serve_int8_profile``
   give the paged-decode kernels' device time (``decode_device_ms``) and
   the FFA forward's (``forward_device_ms``).
8. ``cp_api``: ``magi_attn_flex_key -> dispatch -> calc_attn ->
   undispatch`` at cp = 1, forward and backward, at the train phase's
   attention shape, against ``flex_flash_attn_func``, with max-logits.
   ``deterministic``: two forward + backward runs at that shape through
   ``calc_attn`` under MAGI_ATTENTION_DETERMINISTIC_MODE=1 and two through
   ``flex_flash_attn_func(deterministic=True)``, equal to the bit; the
   drift of two unpinned (fused) runs reported.
9. ``cp_stages``: the multi-stage compute (``multi_ffa`` over the host and
   remote kv parts, lse merge, per-part backward) of every rank of a
   cp = 4, overlap-degree-2 plan, against the plain dense reference.
   ``qo_comm``: the dynamic runtime at cp 1 through the API and a cp 4
   dynamic plan's steps on this card. ``cp_baselines``: every rank's body
   of each CP baseline of ``parallel/`` (ring P2P contig and zigzag, ring
   all-gather, all-gather, Ulysses, USP, two LoongTrain meshes, HybridCP)
   at a world of 4 on this card, with MagiAttention's own cp 4 plan
   beside them, on two masks: out, lse and the summed gradients against
   the plain dense reference, empty parts, per-rank ms. ``cp_hier_tp``:
   four processes on this card over gloo run the API at the train
   attention shape on the same masks: (dcn 2, ici 2) under
   MAGI_ATTENTION_HIERARCHICAL_COMM=1 against the flat cast (every
   stage's receive buffer, out and lse equal to the bit; gradients in the
   bf16 gates of the flat run and of the single-device ``ffa_attn``;
   ``dcn_rows`` beside the flat cast's cross-node rows), both casts under
   MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE=1 (the forward sends bf16,
   out unchanged to the bit), and (cp 2, tp 2) with ``head_axis`` (16 q
   and 4 kv heads a process against ``ffa_attn`` on those heads, one
   solve a process); then ``fa3_func_with_sink`` and
   ``fa3_varlen_func_with_sink`` (causal, a 4096-token window, a sink)
   against their ``sdpa`` versions; launch counts, the slowest rank's ms.
10. ``train``: ``models.llama.train_step`` through the API at
    Llama-3.1-8B widths, depth cut to 2 layers, bf16 over float32 master
    weights, 8192 packed tokens in two causal documents: 3 SGD steps
    unpinned (the model resolves fused), one under the split pin, one
    under the GQA pack flags with the split pin and one under the pack
    flags unpinned; one step's loss and gradients with ``remat=True``
    against the same without (B1 twice a layer, each run's peak memory);
    launch counts per step, one step under ``torch.profiler`` (device ms
    by kernel family), and a kernel-vs-plain check of loss and gradients
    at 2048 tokens. ``train_padded``: the same model on 8000 tokens in two
    documents padded to 8192 (``compute_pad_size``, ``apply_padding``,
    ``pad_at_dim``), one step, its loss against the unpadded step's and
    the pad rows' attention 0. ``moe``: ``models.moe`` at Mixtral-8x7B's
    widths (2 of 32 layers, 8 experts top-2, capacity factor 1.25) on the
    same 8192 tokens at cp 1: three ``moe_train_step``s (B1, B7, B8/B9 a
    layer a step), step ms, tokens/s, a profiled step; the routed FFN
    against ``moe_ffn_reference`` at capacity 8 in both dtypes, and loss
    and gradients against the plain attention path at 2048 tokens in
    float32 (bf16 reported). ``video_dit``: ``models.video_dit`` at
    DiT-XL's widths (head dim 72, padded to the 128-wide instances), 32
    frames of 256 tokens under the block-causal video mask: three AdamW
    steps, step ms, tokens/s, a profiled step, and loss and gradients
    against the dense float32 twin at 8 frames.
11. ``d256_kernels``: each family's 256 instance (the column split) timed
    against its plain version and bound: B1 bf16 at Gemma-2-9B's attention
    against SDPA with B2 (packed, 2 heads a CTA) on the same inputs, B1
    float32 at the serving prefill shape, B3 + B5 and B8
    against SDPA's backward alone (``bwd_mode``'s rule held at d 256), B10
    on 8 slots in both dtypes. ``hybrid_d256``: Gemma-2-9B attention
    (softcap 50) through the API, the global causal dispatch key and its
    4096-token sliding window re-keyed onto it, fwd+bwd against the plain
    versions, ms, bound and share per key.
12. ``block_sparse``: the NSA selected-branch kernels B13 and B14 (its
    dq and dk/dv walks) against their plain versions over chunk tables
    with duplicate chunks: g 1, 2, 4, 8, head_dim 64, 128 and 256, float32
    and bf16, d_stride 16 and 32, and the nsa phase's shape and its d 256
    twin at Gemma-2-9B's heads (timed: B14 whole
    and by launch and key-table build; two backward runs equal to the bit;
    the ``ptxas`` report). ``nsa``: ``parallel.nsa_attn`` forward and
    backward at Llama-3.1-8B attention widths over 8192 tokens in two
    documents with the NSA paper's sparse settings: the kernel route (B13,
    B14's two walks, B1, B7, the resolved backward; launch counts) against
    the gathered route on equal selections, in bf16 and at 2048 tokens in
    float32. ``usp_nsa``: ``usp_nsa_attn``'s per-rank body at (ring 2,
    ulysses 2) against ``nsa_attn`` on the whole, the gradients (the
    parameters' all-reduced) summed, per-rank ms.
13. ``observability``: the cp 1 API path at the train attention shape
    with MAGI_ATTENTION_TELEMETRY on against off (``paired_ms``, and a
    loop of 20 steps that runs ahead, no sync between them), the
    JSONL of a freshly planned step (``plan_solve``, ``ffa_plan``,
    ``attn_step``: host-exact fields against this phase's recomputation,
    ``device_ms`` within 0.5-2x of the phase's own CUDA events,
    ``bwd_device_ms`` within 0.5-1x of its pair around the whole
    backward), a step
    under MAGI_ATTENTION_PROFILE_MODE=1 and ``torch.profiler`` (every scope
    the path reaches; B1 launched inside ``ffa_fwd_stage0``, B7 inside
    ``ffa_bwd_delta``, B8/B9 inside ``ffa_bwd``), and a registry decision
    persisted, reset and resolved again from the store (source
    ``policy``, no heuristic run). ``resilience``: on the same shape,
    ``kernel_lowering`` without MAGI_ATTENTION_FALLBACK raises; with it,
    one ladder hop from 128 x 128 to 128 x 64 bitwise the run pinned
    there; every FFA attempt failing walks the tile ladder and raises
    ``FallbackExhaustedError`` (no plain rung on the card); a failed fused
    backward falls to split bitwise the split pin; the numeric guard
    raising and recording; the step watchdog re-running ``ffa`` bitwise the
    unfaulted step; a ``serve_decode`` fault on the serve engine (one
    token a tick, and spec verify) descending to ``gather_ffa`` within the
    serve tolerance of the replay; the guard's cost a step.
    ``resilience_elsewhere``: the resilience layer's action counts
    (telemetry's ``resilience.*`` counters, kept with telemetry off too)
    before those two phases and after them, which must be zero.
14. ``plan_tiers`` (after ``deterministic``): the plan control plane at
    the train attention shape over a fresh store directory, three ways
    (cold under MAGI_ATTENTION_VERIFY_PLANS=1; loaded from the store; the
    store file with one flipped byte, rejected, cold-solved and healed),
    each a step unpinned (B1, B7, B8/B9) and one under deterministic mode,
    bitwise the cold way (the unpinned dq, summed by the fused backward's
    atomics, within the bf16 gates); each key's ``plan_s``, the load
    (decode + verify) and the verify alone, the blob's bytes.
    ``native_host`` (after it): the headline shape through the API at
    cp 1 planned by the native host backend (MAGI_ATTENTION_NATIVE_FFA_PLAN=1,
    MAGI_ATTENTION_CPP_BACKEND=1, its calls counted) against the Python
    planners (0/0): plans array-equal, the deterministic step's out, lse
    and gradients bitwise (the unpinned step's too but for the fused dq),
    each way's ``plan_s``.
15. ``kernels``: one line per-kernel summary (launches from the serve,
    train or nsa phase plus qo_comm, cp_baselines and usp_nsa, error,
    kernel / plain / library time and the card's bound; launches also
    from cp_hier_tp, decode_sharded, serve_int8's spec pass, the remat
    step, moe, video_dit, observability, resilience, plan_tiers and
    native_host).

It refuses to start when MAGI_ATTENTION_FALLBACK, _FAULT_INJECT,
_NUMERIC_GUARD, _STEP_RETRIES or _STRAGGLER_DETECT is set: its resilience
phases set them themselves, and no other phase may run under them; nor
with MAGI_ATTENTION_VERIFY_PLANS, _PLAN_STORE or _PLAN_BROADCAST set: the
plan phases set them over a fresh temporary directory, and a stale store
must not feed any other phase.

Before the last line it prints ``nvidia-smi``'s ``name, power.limit`` line;
the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --cp4`` needs four cards of one host and runs
``cp4`` alone: every baseline of ``cp_baselines`` (and LoongTrain's
context-first placement) and MagiAttention's API at cp 4 through their
entry points, with the API's two-level run at (dcn 2, ici 2) and TP run
at (cp 2, tp 2) beside the flat one, one process per card, the
collectives over NCCL; each
rank's shard of out, lse and the gradients against the single-device
``ffa_attn`` (bf16 gates) and every rank's fwd+bwd ms; the API's
runtime at overlap degree 1 (merged), 1 with overlap forced, 2 and 4
(``overlap``: the staged backward bitwise against the unstaged order
under deterministic mode, ``assert_overlap_safe``, both orders' ms);
each collective of a degree-2 plan alone per stage (``collectives``:
GroupCast, GroupReduce bf16 and float32, the two-level phases A and B);
then ``cp4_moe_ep``: the ``moe`` phase's model at cp 4 = ep 4 (two
experts a card; one layer, float32, capacity factor 8, held against a
cp 1 run of the same weights; then bf16 at the default capacity: three
steps, each loss the sum of the ranks' shares, step ms, one slot
exchange's ms) and ``cp4_video_dit`` (the ``video_dit`` phase's model at
cp 4 against cp 1, step ms), ``cp4_resilience`` (every rank under the
same ``kernel_lowering:count=1`` spec with MAGI_ATTENTION_FALLBACK=1 takes
the same one hop, no rank hangs, each rank's out and gradients bitwise its
run pinned at the rung; then a NaN on rank 0 alone under
MAGI_ATTENTION_STEP_RETRIES=1: every rank agrees on it and hops once,
bitwise its unfaulted step, and the agreement's cost a step, watchdog on
against off), ``cp4_plan_tiers`` (the API at cp 4 on a group with a 60 s
timeout: rank 0 solves, ranks 1-3 receive the plan over NCCL, verify and
run, every rank bitwise its cold step, each rank's ``plan_s`` cold
against received and its load alone; a ``plan_broadcast`` fault under
MAGI_ATTENTION_FALLBACK=1, the followers solving locally, bitwise too)
and ``cp4_c9`` (rank 1 alone raising ``KernelLaunchError`` before the
static runtime's casts, between its casts and the max-logits all-reduce,
and in the qo-comm runtime before its return cast, under
MAGI_ATTENTION_STEP_RETRIES=1: it issues the collectives it did not
reach, every rank hops once, each bitwise its unfaulted step) and
``cp4_native_solve`` (every rank's plans from the native host backend
field-equal to the Python planners', ``plan_s`` of each)
and ``cp4_straggler`` (rank 3 slowed each step,
every rank fed the all-gathered step ms, identical capacity vectors on
every rank, one weighted re-solve, the weighted output within bf16 limits
of the unweighted, the slowest rank's ms before and after); then, in the
parent process,
``ServeEngine`` at ``decode_shards`` 2 and 4 over the cards, equal to the
one-card engine's rows to the bit (``cp4_sharded_engine``); the four
cards' ``name, power.limit`` lines and the same last line.

Bounds use the card's data-sheet peaks (H100 SXM: 989 TFLOP/s bf16 and
494.7 TFLOP/s TF32 dense tensor cores, 67 TFLOP/s float32 CUDA cores,
3.35 TB/s HBM3); other H100 forms use their own figures, named in the
device line.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
RNORM = {"float32": 1e-5, "bfloat16": 1e-2}
SERVE_ATOL, SERVE_RNORM = 1e-4, 1e-5

# (name substring, bf16 dense TFLOP/s, fp32 CUDA-core TFLOP/s, TF32 dense
# TFLOP/s, HBM TB/s)
PEAKS = (
    ("H100 NVL", 835e12, 60e12, 417.5e12, 3.9e12),
    ("H100 PCIe", 756e12, 51e12, 378e12, 2.0e12),
    ("H100", 989e12, 67e12, 494.7e12, 3.35e12),  # SXM5 (HBM3)
)
# tf32 products a pair of the float32 forward (csrc/ffa_fwd_tf32.cuh)
TF32_PRODUCTS = 3


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_peaks(name: str) -> dict:
    for key, bf16, f32, tf32, bw in PEAKS:
        if key in name:
            return {"form": key, "bfloat16": bf16, "float32": f32, "tfloat32": tf32,
                    "bytes_s": bw}
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


def graph_ms(fn, reps: int = 20, samples: int = 10) -> float:
    """Median device ms of one call of ``fn`` with a cold L2: ``reps``
    calls, each after a 64 MiB write that evicts the 50 MB L2, captured in
    one CUDA graph and replayed (so no host work between the launches),
    less the same graph's writes alone. For kernels shorter than their
    host wrapper, whose :func:`time_ms` is the host's time."""
    import torch

    flush = torch.empty(1 << 24, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # builds, shared-memory attributes, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(g)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = {True: [], False: []}
    for _ in range(samples):
        for with_fn, g in zip((True, False), graphs):
            g.replay()  # warm
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times[with_fn].append(start.elapsed_time(end) / reps)
    del graphs
    return statistics.median(times[True]) - statistics.median(times[False])


def bound(flops: float, nbytes: float, dtype: str, peaks: dict) -> tuple[float, str]:
    t_ops = flops / peaks[dtype] * 1e3
    t_bytes = nbytes / peaks["bytes_s"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fwd_bound(flops: float, nbytes: float, dtype: str, peaks: dict) -> tuple[float, str]:
    """The FFA forward's bound: bf16 at the bf16 tensor-core peak; float32
    as the 3xTF32 body runs it, three tf32 products a pair at the TF32
    peak (float32 FMA's bound at the CUDA-core peak: :func:`bound`)."""
    if dtype == "float32":
        return bound(TF32_PRODUCTS * flops, nbytes, "tfloat32", peaks)
    return bound(flops, nbytes, dtype, peaks)


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


def sink_window_mask(seq: int, global_tokens: int = 64, window: int = 64):
    """(q_ranges, k_ranges, types) of a sliding causal window of
    ``window`` keys behind every query plus the first ``global_tokens``
    keys for every query (global / sink tokens), through the port's own
    mask compiler (``magi_attn_varlen_key``'s ``window_size`` and
    ``global_window_size``)."""
    from magiattention_tpu_torch.api.functools import infer_attn_mask_from_cu_seqlens

    qr, kr, types = infer_attn_mask_from_cu_seqlens(
        [0, seq], causal=False, window_size=(window, 0), global_window_size=global_tokens,
    )
    return (
        np.array(qr.to_naive_ranges()), np.array(kr.to_naive_ranges()),
        np.array([t.to_int_type() for t in types]),
    )


def mask_cases() -> dict[str, dict]:
    """The masks and shapes the FFA phases run (head_dim 128 unless a case
    names ``d``)."""
    import torch

    from magiattention_tpu_torch.kernels.mask_utils import BAND_INF, types_to_bands

    S = 8192
    causal = types_to_bands(np.array([[0, S]]), np.array([[0, S]]), np.array([1]))
    qr = np.array([[0, 3072], [3072, 6144], [6144, 7168], [7168, 7680]])
    kr = np.array([[0, 3072], [3072, 6144], [6144, 7168], [6144, 7680]])
    docs = np.array([[0, S // 2], [S // 2, S]])
    sqr, skr, stypes = sink_window_mask(S)
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
        # 64 global tokens and a 64-key sliding window at the train heads:
        # every q tile reaches k tile 0, so one k-major run is 129 items
        # long while the q-major runs are 2-3 (where split should beat fused)
        "sink_window_8192_bf16": dict(
            dtype=torch.bfloat16, sq=S, sk=S, hq=32, hk=8, qr=sqr, kr=skr,
            lo=types_to_bands(sqr, skr, stypes)[0], hi=types_to_bands(sqr, skr, stypes)[1],
        ),
    }


def case_inputs(c: dict, gen, with_do: bool = False):
    """Random q, k, v (and dO) of a mask case, its plan and params."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import FFAParams, default_blocks
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    dt, d = c["dtype"], c.get("d", 128)
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
            ("train_docs_8192_bf16", "d_train_docs_8192_bf16"),
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
        f64 = {}
        if dname == "float32":
            f64 = float64_report(q, k, v, out_k, lse_k, out_p, lse_p, qr, kr, lo, hi, scale)
        mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
        live = int(mask.sum().item())
        flops = 4.0 * c["hq"] * d * live
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + lse_k.numel() * 4
        b_ms, b_by = fwd_bound(flops, nbytes, dname, peaks)
        if dname == "float32":
            f64["fma_bound_ms"] = bound(flops, nbytes, dname, peaks)[0]
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
            atol=ATOL[dname], rnorm=RNORM[dname], **f64,
        )
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        results.append(res)
        emit({"phase": "ffa_fwd", **res})
        del mask, out_p, lse_p
        torch.cuda.empty_cache()
    return results


def float64_report(q, k, v, out_k, lse_k, out_p, lse_p, qr, kr, lo, hi, scale) -> dict:
    """A float32 forward case against a float64 run of the plain version:
    the kernel's errors (3xTF32) beside the float32 plain version's own
    (cuBLAS float32 FMA), and the scores of the last q tile's rows (the
    longest) from the 3xTF32 split emulated exactly in float64
    (``scores_3xtf32``: the split's error alone, without the tensor cores'
    accumulation) and from float32 FMA, against float64 q k^T."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import scores_3xtf32
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    out_64, lse_64 = sdpa_attn(q.double(), k.double(), v.double(), qr, kr, softmax_scale=scale,
                               d_lo=lo, d_hi=hi, compute_dtype=torch.float64)
    g = q.shape[1] // k.shape[1]
    qt = q[-64:]
    kx = k.repeat_interleave(g, dim=1)
    s64 = torch.einsum("qhd,khd->hqk", qt.double(), kx.double())
    s32 = torch.einsum("qhd,khd->hqk", qt, kx)
    s3 = scores_3xtf32(qt, k)
    return {
        "vs_float64": errors(out_k, lse_k, out_64, lse_64),
        "plain_float32_vs_float64": errors(out_p, lse_p, out_64, lse_64),
        "scores_3xtf32_emulated_max_abs_err": (s3 - s64).abs().max().item(),
        "scores_float32_fma_max_abs_err": (s32.double() - s64).abs().max().item(),
        "scores_max_abs": s64.abs().max().item(),
    }


TF32_PROBE_MODES = {1: "tf32_1x", 3: "tf32_3x_one_accumulator", 4: "tf32_3x_body"}


def tf32_probe_phase() -> dict:
    """The 3xTF32 probe (``csrc/tf32_probe.cu``) at the serving prefill
    shape (q 512 x 32 x 128, k/v 4096 x 8 x 128, seed 0): S = Q K^T and O
    = P V (P uniform in [0, 1) over all 4096 keys) by wgmma from tf32
    hi / lo splits, one product (mode 1), three into one accumulator (3)
    and the forward body's accumulators (4), against float64; beside them
    float32 FMA's (cuBLAS, TF32 off) and the split's own error with every
    product and sum exact (``scores_3xtf32``). Fails if the body's layout
    loses more than twice float32 FMA's rms error."""
    import ctypes

    import torch

    from magiattention_tpu_torch.kernels import _build
    from magiattention_tpu_torch.kernels.ffa import scores_3xtf32

    lib = _build.library("tf32_probe")
    for fn in (lib.tf32_probe_s, lib.tf32_probe_pv):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    sq, sk, hq, hk, d = 512, 4096, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda")
               for sh in ((sq, hq, d), (sk, hk, d), (sk, hk, d)))
    kx, vx = (t.repeat_interleave(hq // hk, dim=1) for t in (k, v))

    def err(got, want) -> dict:
        e = (got.double() - want).abs()
        return {"max_abs": e.max().item(), "rms": e.pow(2).mean().sqrt().item()}

    res = {}
    s64 = torch.einsum("qhd,khd->hqk", q.double(), kx.double())
    res["s_float32_fma"] = err(torch.einsum("qhd,khd->hqk", q, kx), s64)
    res["s_3xtf32_exact_sums"] = err(scores_3xtf32(q, k), s64)
    for mode, name in TF32_PROBE_MODES.items():
        out = torch.empty((hq, sq, sk), device="cuda")
        _build.check(lib, lib.tf32_probe_s(q.data_ptr(), k.data_ptr(), out.data_ptr(),
                                           sq, sk, hq, hk, mode), "tf32_probe_s")
        torch.cuda.synchronize()
        res[f"s_{name}"] = err(out, s64)
    del s64, out
    p = torch.rand((hq, sq, sk), generator=gen, device="cuda")
    o64 = torch.einsum("hqk,khd->hqd", p.double(), vx.double())
    res["o_float32_fma"] = err(torch.einsum("hqk,khd->hqd", p, vx), o64)
    for mode, name in TF32_PROBE_MODES.items():
        out = torch.empty((hq, sq, d), device="cuda")
        _build.check(lib, lib.tf32_probe_pv(p.data_ptr(), v.data_ptr(), out.data_ptr(),
                                            sq, sk, hq, hk, mode), "tf32_probe_pv")
        torch.cuda.synchronize()
        res[f"o_{name}"] = err(out, o64)
    res["o_max_abs"] = o64.abs().max().item()
    del p, o64, out
    torch.cuda.empty_cache()
    emit({"phase": "tf32_probe", **res})
    for x in ("s", "o"):
        if res[f"{x}_tf32_3x_body"]["rms"] > 2 * res[f"{x}_float32_fma"]["rms"]:
            raise AssertionError(f"tf32_probe: the body's {x} loses more than 2x float32 FMA: {res}")
    return res


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
        ffa_bwd_dq_plain, ffa_bwd_fused_kernel, ffa_delta_kernel,
        ffa_delta_plain, ffa_fwd_kernel,
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
        # the split dk/dv run the fused kernel's dk/dv products in its order
        # (the same body in both dtypes): reported, not gated
        _, dk_f, dv_f = ffa_bwd_fused_kernel(*args)
        dkv_equal_fused = bool(torch.equal(dk, dk_f) and torch.equal(dv, dv_f))
        del dk_f, dv_f
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
            dkv_bitwise_equal_to_fused=dkv_equal_fused,
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
        # SDPA's backward alone, where every row is covered: the forward
        # runs once outside the timer, the graph is kept for every call
        res["sdpa_bwd_ms"] = None
        if "uncovered" not in c:
            qt, kt, vt = (t.transpose(0, 1)[None] for t in (qg, kg, vg))
            o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)
            do_t = do.transpose(0, 1)[None]
            res["sdpa_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(o, (qg, kg, vg), do_t, retain_graph=True), samples=5
            )
            del o
        # the split pair (dq, then dk/dv) over SDPA's backward alone
        res["split_over_sdpa_bwd"] = (
            (res["ffa_bwd_dq"]["ms"] + res["ffa_bwd_dkv"]["ms"]) / res["sdpa_bwd_ms"]
            if res["sdpa_bwd_ms"] else None
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
    library time is SDPA's backward alone from the ``ffa_bwd`` phase where
    every row is covered, else its forward + backward.
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
            cost_model_mode=ffa_bwd_mode(plan, params, d, d, isz, hq, c["hk"]),
            vs_plain=err, vs_split=err_split,
            max_abs_err=max(e["max_abs_err"] for e in err.values()),
            ms=ms, convert_ms=convert_ms,
            plain_ms=time_ms(lambda: ffa_bwd_fused_plain(*args), warmup=1),
            split_ms=bwd[name]["ffa_bwd_dq"]["ms"] + bwd[name]["ffa_bwd_dkv"]["ms"],
            bound_ms=b_ms, bound_by=b_by,
            library_ms=bwd[name]["sdpa_bwd_ms"] or bwd[name]["sdpa_fwd_bwd_ms"],
            library_call=bwd[name]["sdpa_fwd_bwd_call"] + (
                " backward alone" if bwd[name]["sdpa_bwd_ms"] else " forward + backward"
            ),
            tflops=flops / (ms * 1e-3) / 1e12,
            atomic_rmw_bytes=real_items * hq * 64 * d * 4 * 2,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        emit({"phase": "ffa_bwd_fused", **res})
        results[name] = res
        del fused, ws
        torch.cuda.empty_cache()
    return results


# the GQA-packed kernels' cases: every group size (2, 4, 8), head dim (64,
# 128), dtype and mask (causal, varlen with uncovered rows, train documents)
# appears: (mask case, name, dtype, head_dim, hq, hk)
GQA_CASES = (
    ("train_docs_8192_bf16", "a_docs_bf16_d128_g4", "bfloat16", 128, 32, 8),
    ("causal_8192_bf16", "b_causal_bf16_d128_g2", "bfloat16", 128, 16, 8),
    ("varlen_8192_bf16", "c_varlen_bf16_d128_g8", "bfloat16", 128, 32, 4),
    ("causal_8192_bf16", "d_causal_f32_d64_g8", "float32", 64, 32, 4),
    ("varlen_8192_bf16", "e_varlen_f32_d64_g4", "float32", 64, 16, 4),
    ("train_docs_8192_bf16", "f_docs_f32_d128_g2", "float32", 128, 16, 8),
)


def gqa_case(key: str, name: str, dtype: str, d: int, hq: int, hk: int) -> dict:
    import torch

    return dict(mask_cases()[key], name=name, dtype=getattr(torch, dtype), d=d, hq=hq, hk=hk)


def live_pairs(c: dict) -> tuple[int, object]:
    """Live (q, k) pairs of a case's mask, and the dense bool mask."""
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band

    qr, kr = np.asarray(c["qr"], np.int32), np.asarray(c["kr"], np.int32)
    lo, hi = np.asarray(c["lo"], np.int32), np.asarray(c["hi"], np.int32)
    mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
    return int(mask.sum().item()), mask


def sdpa_ms(c: dict, q, k, v, mask) -> tuple[float | None, str | None]:
    """SDPA's forward time on the case (is_causal for a causal mask, else
    the bool mask where every row is covered; None where rows are empty,
    which SDPA turns into NaN)."""
    import torch.nn.functional as F

    if "uncovered" in c:
        return None, None
    qt, kt, vt = (t.transpose(0, 1)[None] for t in (q, k, v))
    if c.get("library") == "causal":
        kw, call = dict(is_causal=True), "is_causal=True"
    else:
        kw, call = dict(attn_mask=mask), "attn_mask=bool"
    ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw))
    return ms, f"scaled_dot_product_attention({call}, enable_gqa=True)"


def ffa_fwd_gqa_phase(peaks: dict) -> dict[str, dict]:
    """The packed forward kernel (B2) against its plain version
    (``sdpa_attn``) and against the unpacked kernel (B1) on the same
    inputs: out and lse must be bit-identical to B1's. Prints the guard's
    decision (heads per CTA) and checks the packed CTA's shared memory
    against the guard's figure. Bound: B1's (the same function; K/V
    streamed per item drop by the heads per CTA, reported apart)."""
    import torch

    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.kernels.ffa import (
        ffa_fwd_gqa_kernel, ffa_fwd_kernel, fwd_pack_heads, fwd_pack_smem_bytes,
    )
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    gen = torch.Generator(device="cuda").manual_seed(21)
    results = {}
    for spec in GQA_CASES:
        c = gqa_case(*spec)
        name, d, hq, hk = c["name"], c["d"], c["hq"], c["hk"]
        dname = str(c["dtype"]).removeprefix("torch.")
        isz = c["dtype"].itemsize
        heads = fwd_pack_heads(hq // hk, d, d, isz)
        decision = dict(case=name, group=hq // hk, head_dim=d, heads_per_cta=heads)
        if heads < 2:
            emit({"phase": "ffa_fwd_gqa", **decision, "route": "unpacked (guard)"})
            continue
        lib_smem = kffa._lib("ffa_fwd_gqa").ffa_fwd_gqa_smem_bytes(d, heads, 64, 64, int(isz == 2))
        if lib_smem != fwd_pack_smem_bytes(d, heads, isz):
            raise AssertionError(
                f"{name}: kernel smem {lib_smem} != guard's {fwd_pack_smem_bytes(d, heads, isz)}"
            )
        (q, k, v), (qr, kr, lo, hi), plan, params = case_inputs(c, gen)

        def kernel():
            return ffa_fwd_gqa_kernel(q, k, v, plan, params)

        def unpacked():
            return ffa_fwd_kernel(q, k, v, plan, params)

        def plain():
            return sdpa_attn(q, k, v, qr, kr, softmax_scale=params.softmax_scale, d_lo=lo, d_hi=hi)

        out_k, lse_k = kernel()
        out_u, lse_u = unpacked()
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        err = errors(out_k, lse_k, out_p, lse_p)
        check(name, err, dname)
        bitwise = bool(torch.equal(out_k, out_u) and torch.equal(lse_k, lse_u))
        if not bitwise:
            raise AssertionError(f"{name}: packed forward is not bit-identical to the unpacked one")
        if "uncovered" in c:
            r0, r1 = c["uncovered"]
            if out_k[r0:r1].any() or not torch.isneginf(lse_k[r0:r1]).all():
                raise AssertionError(f"{name}: uncovered rows are not (0, -inf)")
        del out_p, lse_p, out_u, lse_u
        live, mask = live_pairs(c)
        flops = 4.0 * hq * d * live
        isz = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + lse_k.numel() * 4
        b_ms, b_by = fwd_bound(flops, nbytes, dname, peaks)
        lib_ms, lib_call = sdpa_ms(c, q, k, v, mask)
        del mask
        kv_tile = 2 * 64 * d * isz  # a k and a v tile
        res = dict(
            **decision, dtype=dname, q=list(q.shape), kv=list(k.shape),
            live_pairs=live, work_items=plan.num_work, **err, bit_identical_to_unpacked=bitwise,
            smem_bytes=lib_smem, ms=time_ms(kernel), unpacked_ms=time_ms(unpacked),
            plain_ms=time_ms(plain, warmup=1, samples=5), bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library_call=lib_call,
            kv_streamed_gb=plan.num_work * hq // heads * kv_tile / 1e9,
            kv_streamed_gb_unpacked=plan.num_work * hq * kv_tile / 1e9,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        emit({"phase": "ffa_fwd_gqa", **res})
        results[name] = res
        torch.cuda.empty_cache()
    return results


def ffa_bwd_gqa_phase(peaks: dict) -> dict[str, dict]:
    """The packed dq kernel (B4) against its plain version
    (``ffa_bwd_dq_plain``) and against the unpacked dq kernel (B3) on the
    same inputs (B1's out and lse, the plain delta): dq must be
    bit-identical to B3's, and 0 on uncovered rows. Bound: B3's, 6 flops
    per live pair per head and d."""
    import torch

    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.kernels.ffa import (
        dq_pack_heads, dq_pack_smem_bytes, ffa_bwd_dq_gqa_kernel, ffa_bwd_dq_kernel,
        ffa_bwd_dq_plain, ffa_delta_plain, ffa_fwd_kernel,
    )

    gen = torch.Generator(device="cuda").manual_seed(23)
    results = {}
    for spec in GQA_CASES:
        c = gqa_case(*spec)
        name, d, hq, hk = c["name"], c["d"], c["hq"], c["hk"]
        dname = str(c["dtype"]).removeprefix("torch.")
        isz = c["dtype"].itemsize
        heads = dq_pack_heads(hq // hk, d, d, isz)
        decision = dict(case=name, group=hq // hk, head_dim=d, heads_per_cta=heads)
        if heads < 2:
            emit({"phase": "ffa_bwd_dq_gqa", **decision, "route": "unpacked (guard)"})
            continue
        lib_smem = kffa._lib("ffa_bwd_dq_gqa").ffa_bwd_dq_gqa_smem_bytes(d, heads, 64, 64, int(isz == 2))
        if lib_smem != dq_pack_smem_bytes(d, heads, isz):
            raise AssertionError(
                f"{name}: kernel smem {lib_smem} != guard's {dq_pack_smem_bytes(d, heads, isz)}"
            )
        (q, k, v, do), _, plan, params = case_inputs(c, gen, with_do=True)
        out, lse = ffa_fwd_kernel(q, k, v, plan, params)
        delta = ffa_delta_plain(out, do)
        args = (q, k, v, do, lse, delta, plan, params)
        dq_k = ffa_bwd_dq_gqa_kernel(*args)
        dq_u = ffa_bwd_dq_kernel(*args)
        torch.cuda.synchronize()
        err = grad_check(f"{name} dq", dq_k, ffa_bwd_dq_plain(*args), dname)
        bitwise = bool(torch.equal(dq_k, dq_u))
        if not bitwise:
            raise AssertionError(f"{name}: packed dq is not bit-identical to the unpacked one")
        if "uncovered" in c:
            r0, r1 = c["uncovered"]
            if dq_k[r0:r1].any():
                raise AssertionError(f"{name}: packed dq of uncovered rows is not 0")
        del dq_u
        live, mask = live_pairs(c)
        del mask
        n_q, n_kv, rows = q.numel(), k.numel(), c["sq"] * hq
        flops = 6.0 * hq * d * live
        b_ms, b_by = bound(flops, (2 * n_q + 2 * n_kv) * isz + 2 * rows * 4 + n_q * 4, dname, peaks)
        res = dict(
            **decision, dtype=dname, q=list(q.shape), kv=list(k.shape), live_pairs=live,
            work_items=plan.num_work, **err, bit_identical_to_unpacked=bitwise,
            smem_bytes=lib_smem, ms=time_ms(lambda: ffa_bwd_dq_gqa_kernel(*args)),
            unpacked_ms=time_ms(lambda: ffa_bwd_dq_kernel(*args)),
            plain_ms=time_ms(lambda: ffa_bwd_dq_plain(*args), warmup=1, samples=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        emit({"phase": "ffa_bwd_dq_gqa", **res})
        results[name] = res
        torch.cuda.empty_cache()
    return results


ML_RTOL = 1e-5  # float32: the kernel's and the dense products sum in other orders


def max_logits_phase() -> dict[str, dict]:
    """B1's max-logits output against ``dense_max_logits`` at the four
    backward shapes, softcap off and on (relative 1e-5), with out and lse
    unchanged bit for bit by asking for it, and B1's time with and without
    it; then a mask with no live pair, whose every head must give -inf."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import ffa_fwd_kernel, plan_params
    from magiattention_tpu_torch.kernels.sdpa import dense_max_logits

    gen = torch.Generator(device="cuda").manual_seed(25)
    all_cases = mask_cases()
    results = {}
    for key in ("causal_8192_bf16", "varlen_8192_bf16", "serving_prefill_f32", "train_docs_8192_bf16"):
        c = all_cases[key]
        (q, k, v), (qr, kr, lo, hi), plan, params0 = case_inputs(c, gen)
        for softcap in (0.0, 30.0):
            params = dataclasses.replace(params0, softcap=softcap)
            out, lse, ml = ffa_fwd_kernel(q, k, v, plan, params, return_max_logits=True)
            out0, lse0 = ffa_fwd_kernel(q, k, v, plan, params)
            want = dense_max_logits(
                q, k, qr, kr, softmax_scale=params.softmax_scale, softcap=softcap,
                d_lo=lo, d_hi=hi,
            )
            torch.cuda.synchronize()
            if not (torch.equal(out, out0) and torch.equal(lse, lse0)):
                raise AssertionError(f"{key}: out/lse change when max-logits is asked for")
            if not torch.isfinite(want).all() or not torch.isfinite(ml).all():
                raise AssertionError(f"{key}: max-logits not finite where every head attends")
            rel = ((ml.double() - want.double()).abs() / want.double().abs()).max().item()
            if rel > ML_RTOL:
                raise AssertionError(f"{key} softcap {softcap}: max-logits rel err {rel:.3e} > {ML_RTOL}")
            name = f"{key}_cap{softcap:g}"
            res = dict(
                case=name, max_rel_err=rel, max_logit=ml.max().item(),
                ms=time_ms(lambda: ffa_fwd_kernel(q, k, v, plan, params, return_max_logits=True)),
                ms_without=time_ms(lambda: ffa_fwd_kernel(q, k, v, plan, params)),
                rtol=ML_RTOL,
            )
            emit({"phase": "max_logits", **res})
            results[name] = res
        torch.cuda.empty_cache()
    # no live pair: one slice whose band misses its rectangle
    q, k, v = (torch.randn((200, 4, 64), generator=gen, device="cuda") for _ in range(3))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    plan, params = plan_params([[0, 100]], [[150, 200]], None, [-300], [-250], 200, 200, 64, None, 0.0)
    out, lse, ml = ffa_fwd_kernel(q, k, v, plan, params, return_max_logits=True)
    torch.cuda.synchronize()
    if out.any() or not torch.isneginf(lse).all() or not torch.isneginf(ml).all():
        raise AssertionError("an empty mask does not give out 0, lse -inf and max-logits -inf")
    emit({"phase": "max_logits", "case": "empty_mask", "max_logits": ml.tolist()})
    return results


def paired_ms(fns: dict, rounds: int = 9, samples: int = 5) -> dict[str, list[float]]:
    """Each function's :func:`time_ms` in every round, the functions timed
    in turn within a round and their order rotated from round to round, so
    a drift of the card's clock or heat falls on all of them alike. Kernels
    that a rule compares are timed so, not in phases minutes apart."""
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in names[r % len(names):] + names[:r % len(names)]:
            times[n].append(time_ms(fns[n], warmup=1, samples=samples))
    return times


def bwd_mode_phase(bwd: dict, fused: dict, dq_gqa: dict) -> list[dict]:
    """The unpinned backward mode against the card: at the four backward
    shapes and the sink-window mask (fused checked against split there),
    the cost model's choice beside the fused and split (dq + dk/dv) times,
    taken here in interleaved rounds (:func:`paired_ms`; split is each
    round's dq + dk/dv, the medians over rounds compared). The ``ffa_bwd``
    and ``ffa_bwd_fused`` phases' times of the same kernels are printed
    beside them. Fails where the model picks the slower mode by more than
    5% (after printing the constants). Also the constants the model would
    take from this run (``tile_policy.calibrate_tc`` over the four bf16
    masks for each tensor-core kernel: dq, dk/dv, fused, and the packed dq
    over the train shape and the sink window) beside the ones in the code;
    the CUDA-core kernels run only the float32 serving prefill here (their
    constants came from a run where bf16 took them too, at the train
    shape)."""
    import torch

    from magiattention_tpu_torch.kernels import tile_policy
    from magiattention_tpu_torch.kernels.ffa import (
        bwd_shape, ffa_bwd_dkv_kernel, ffa_bwd_dq_gqa_kernel, ffa_bwd_dq_kernel,
        ffa_bwd_fused_kernel, ffa_bwd_mode, ffa_delta_plain, ffa_fwd_kernel,
    )

    gen = torch.Generator(device="cuda").manual_seed(27)
    all_cases = mask_cases()
    phase_ms = {
        key: dict(
            fused=fused[name]["ms"],
            split=bwd[name]["ffa_bwd_dq"]["ms"] + bwd[name]["ffa_bwd_dkv"]["ms"],
        )
        for key, name in (
            ("causal_8192_bf16", "a_causal_8192_bf16"),
            ("varlen_8192_bf16", "b_varlen_8192_bf16"),
            ("serving_prefill_f32", "c_serving_prefill_f32"),
            ("train_docs_8192_bf16", "d_train_docs_8192_bf16"),
        )
    }
    measured, shapes = {}, {}
    for key in (*phase_ms, "sink_window_8192_bf16"):
        c = all_cases[key]
        isz = 4 if c["dtype"] == torch.float32 else 2
        (q, k, v, do), _, plan, params = case_inputs(c, gen, with_do=True)
        out, lse = ffa_fwd_kernel(q, k, v, plan, params)
        args = (q, k, v, do, lse, ffa_delta_plain(out, do), plan, params)
        if key == "sink_window_8192_bf16":
            dq_f, dk_f, dv_f = ffa_bwd_fused_kernel(*args)
            split = (ffa_bwd_dq_kernel(*args), *ffa_bwd_dkv_kernel(*args))
            for gname, a, b in zip(("dq", "dk", "dv"), (dq_f, dk_f, dv_f), split):
                grad_check(f"sink_window fused vs split {gname}", a, b, "bfloat16")
            del dq_f, dk_f, dv_f, split
        t = paired_ms(dict(
            fused=lambda: ffa_bwd_fused_kernel(*args),
            dq=lambda: ffa_bwd_dq_kernel(*args),
            dkv=lambda: ffa_bwd_dkv_kernel(*args),
        ))
        measured[key] = dict(
            fused=statistics.median(t["fused"]), dq=statistics.median(t["dq"]),
            dkv=statistics.median(t["dkv"]),
            split=statistics.median([a + b for a, b in zip(t["dq"], t["dkv"])]),
        )
        if key == "sink_window_8192_bf16":
            measured[key]["dq_gqa"] = time_ms(lambda: ffa_bwd_dq_gqa_kernel(*args))
        shapes[key] = (
            ffa_bwd_mode(plan, params, 128, 128, isz, c["hq"], c["hk"]),
            bwd_shape(plan, c["hq"], c["hk"], 128, 128, isz), isz,
        )
        del q, k, v, do, out, lse, args
        torch.cuda.empty_cache()

    rows, tc_shapes = [], {}
    for key, ms in measured.items():
        mode, shape, isz = shapes[key]
        if isz == 2:  # the tensor-core bodies' shapes, for their fit
            tc_shapes[key] = shape
        split_ms = ms["split"]
        faster = "fused" if ms["fused"] <= split_ms else "split"
        gap = abs(ms["fused"] - split_ms) / min(ms["fused"], split_ms)
        row = dict(
            case=key, model_mode=mode, faster=faster, agree=mode == faster, gap=gap,
            fused_ms=ms["fused"], split_ms=split_ms, dq_ms=ms["dq"], dkv_ms=ms["dkv"],
            modeled_ms=tile_policy.kernel_ms(shape), body=tile_policy.dtype_body(shape),
            real_items=int(shape.items_k.sum()), longest_k_run=int(shape.items_k.max()),
            longest_q_run=int(shape.items_q.max()),
        )
        if "dq_gqa" in ms:
            row["dq_gqa_ms"] = ms["dq_gqa"]
        if key in phase_ms:
            row.update(phases_fused_ms=phase_ms[key]["fused"], phases_split_ms=phase_ms[key]["split"])
        emit({"phase": "bwd_mode", **row})
        rows.append(row)
    # the packed dq (its guard's heads per CTA) at the two bf16 masks that
    # time it: the train shape (its own phase) and the sink window
    measured["train_docs_8192_bf16"]["dq_gqa"] = dq_gqa["a_docs_bf16_d128_g4"]["ms"]
    tc = {}
    for kern in ("dq", "dkv", "fused", "dq_gqa"):
        keys = [key for key in tc_shapes if kern in measured[key]]
        tc[kern] = tile_policy.calibrate_tc(
            kern, [tc_shapes[key] for key in keys], [measured[key][kern] for key in keys],
            dq_heads_per_cta=dq_gqa["a_docs_bf16_d128_g4"]["heads_per_cta"],
        )
    f32 = tile_policy.calibrate(shapes["serving_prefill_f32"][1], measured["serving_prefill_f32"])
    emit({
        "phase": "bwd_mode_constants",
        "from_this_run": dict(tensor_cores=tc, cuda_cores_at_serving_prefill=f32),
        "in_code": dict(
            tensor_cores=tile_policy.TC_ITEM_US, cuda_cores=tile_policy.ITEM_US,
            atomic_adds_per_s=tile_policy.ATOMIC_ADDS_PER_S,
        ),
    })
    for row in rows:  # after the constants, so a failing run still shows them
        if not row["agree"] and row["gap"] > 0.05:
            raise AssertionError(
                f"bwd_mode {row['case']}: model picks {row['model_mode']}, "
                f"{row['faster']} is {row['gap']:.1%} faster"
            )
    return rows


# the tiled libraries and the compiled-set kernel of each (utils/mem_budget.py)
TILE_LIBS = {"ffa_fwd": "fwd", "ffa_bwd_dq": "dq", "ffa_bwd_dkv": "dkv", "ffa_bwd_fused": "fused"}
PACKED_LIBS = {"ffa_fwd_gqa": "fwd_gqa", "ffa_bwd_dq_gqa": "dq_gqa"}
# the ragged mask of the instance sweep: two causal documents, a band, rows
# [640, 700) no slice covers and k rows [600, 700) no slice reaches, at a
# length that is no multiple of 64 or 128
TILE_SWEEP_S = 700


def tiles_smem_check() -> dict:
    """K1 over the FFA libraries (``analysis/kernel_check.py``): every
    library's ``<name>_smem_bytes`` for every (dtype, d, bq, bk[, heads])
    against the host formula (``utils/mem_budget.py``): equal where the
    instance is compiled, 0 where it is not; and the card's per-CTA opt-in
    limit against the budget the formula is held to."""
    import torch

    from magiattention_tpu_torch.analysis import kernel_check
    from magiattention_tpu_torch.analysis.violation import VerifyReport
    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.utils import mem_budget as mb

    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    report = VerifyReport()
    summary = kernel_check.check_k1_libraries(
        report, libraries={**TILE_LIBS, **PACKED_LIBS},
        query=lambda lib: getattr(kffa._lib(lib), f"{lib}_smem_bytes"), limit=optin)
    report.raise_if_errors()
    row = dict(
        device_smem_per_block_optin=optin, budget=mb.SMEM_PER_CTA, checked=summary["checked"],
        compiled=summary["compiled"], largest=summary["largest"],
        instances=sum(summary["compiled"].values()),
    )
    emit({"phase": "tiles_smem", **row})
    if optin is not None and optin != mb.SMEM_PER_CTA:
        raise AssertionError(f"the card's opt-in limit {optin} != the budget {mb.SMEM_PER_CTA}")
    return row


def sweep_grad_check(name: str, got, want, dtype: str) -> dict:
    """:func:`grad_check` for the instance sweep's gradients: bf16 at its
    gates; float32 within 1e-5 of the larger of 1 and the plain version's
    largest magnitude (:func:`scaled_check`: dk/dv sum up to 600 products
    a key row here, values of a few units, where float32 sums in two
    orders differ by more than 1e-5 absolute), and rel-norm 1e-5."""
    if dtype == "bfloat16":
        return grad_check(name, got, want, dtype)
    return scaled_check(name, got, want, dtype)


def scaled_check(name: str, got, want, dtype: str) -> dict:
    """:func:`grad_check` with the absolute gate taken of the larger of 1
    and the reference's largest magnitude, rel-norm as is."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel result is not finite")
    a, b = got.double(), want.double()
    scale = max(1.0, b.abs().max().item())
    err = {
        "max_abs_err": (a - b).abs().max().item(),
        "rel_norm_err": ((a - b).norm() / b.norm().clamp_min(1e-30)).item(),
        "scale": scale,
    }
    if not (err["max_abs_err"] <= ATOL[dtype] * scale and err["rel_norm_err"] <= RNORM[dtype]):
        raise AssertionError(
            f"{name}: {err} beyond atol {ATOL[dtype]} x {scale}, rel-norm {RNORM[dtype]}"
        )
    return err


def tiles_sweep_mask():
    from magiattention_tpu_torch.kernels.mask_utils import BAND_INF

    qr = np.array([[0, 256], [256, 448], [448, 640]], np.int32)
    kr = np.array([[0, 256], [256, 448], [300, 600]], np.int32)
    lo = np.array([-BAND_INF, -BAND_INF, -260], np.int32)
    hi = np.array([0, 0, -60], np.int32)
    return qr, kr, lo, hi


def tiles_instances_phase() -> dict:
    """Every compiled (kernel, dtype, d, bq, bk) instance against its plain
    version on the ragged mask (:func:`tiles_sweep_mask`; uncovered rows
    (0, -inf) and zero dq, unreached k rows zero dk/dv), and each packed
    instance bit for bit against the unpacked kernel at its tiles. The
    forward at the dtype's gates, the gradients at
    :func:`sweep_grad_check`'s."""
    import torch

    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan
    from magiattention_tpu_torch.kernels.sdpa import dense_max_logits, sdpa_attn
    from magiattention_tpu_torch.utils import mem_budget as mb

    gen = torch.Generator(device="cuda").manual_seed(61)
    S = TILE_SWEEP_S
    qr, kr, lo, hi = tiles_sweep_mask()
    worst, n, ml_worst = {}, 0, {}

    def note(key, err):
        w = worst.setdefault(key, 0.0)
        worst[key] = max(w, err["max_abs_err"])

    for dt in (torch.bfloat16, torch.float32):
        dname, isz = str(dt).removeprefix("torch."), 2 if dt == torch.bfloat16 else 4
        for d in (64, 128, 256):
            for hq, hk in ((4, 2), (8, 2)):
                q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").to(dt) for sh in (
                    (S, hq, d), (S, hk, d), (S, hk, d), (S, hq, d)))
                scale = d ** -0.5
                out_p, lse_p = sdpa_attn(q, k, v, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi)
                ml_p = dense_max_logits(q, k, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi).double()
                delta = kffa.ffa_delta_plain(out_p, do)
                for bq, bk in mb.TILE_PAIRS:
                    plan = get_ffa_plan(qr, kr, lo, hi, S, S, bq, bk)
                    params = kffa.FFAParams(
                        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
                        block_q=bq, block_k=bk, softmax_scale=scale, softcap=0.0,
                    )
                    tag = f"{dname} d{d} g{hq // hk} {bq}x{bk}"
                    if mb.is_compiled("fwd", isz, d, bq, bk):
                        out_k, lse_k = kffa.ffa_fwd_kernel(q, k, v, plan, params)
                        err = errors(out_k, lse_k, out_p, lse_p)
                        check(f"tiles fwd {tag}", err, dname)
                        if out_k[640:].any() or not torch.isneginf(lse_k[640:]).all():
                            raise AssertionError(f"tiles fwd {tag}: uncovered rows are not (0, -inf)")
                        note(f"fwd {dname}", err)
                        # max-logits: reduced over the tile's warpgroups
                        out_m, lse_m, ml = kffa.ffa_fwd_kernel(q, k, v, plan, params, return_max_logits=True)
                        if not (torch.equal(out_m, out_k) and torch.equal(lse_m, lse_k)):
                            raise AssertionError(f"tiles fwd {tag}: out/lse change when max-logits is asked for")
                        rel = ((ml.double() - ml_p).abs() / ml_p.abs()).max().item()
                        if not torch.isfinite(ml).all() or not rel <= ML_RTOL:
                            raise AssertionError(f"tiles fwd {tag}: max-logits rel err {rel:.3e} > {ML_RTOL}")
                        ml_worst[dname] = max(ml_worst.get(dname, 0.0), rel)
                        n += 1
                        heads = kffa.fwd_pack_heads(hq // hk, d, d, isz, bq, bk)
                        if heads > 1:
                            out_g, lse_g = kffa.ffa_fwd_gqa_kernel(q, k, v, plan, params)
                            if not (torch.equal(out_g, out_k) and torch.equal(lse_g, lse_k)):
                                raise AssertionError(f"tiles fwd_gqa {tag} g{heads}: not bitwise the unpacked")
                            n += 1
                    args = (q, k, v, do, lse_p, delta, plan, params)
                    if mb.is_compiled("dq", isz, d, bq, bk):
                        dq = kffa.ffa_bwd_dq_kernel(*args)
                        dq_p = kffa.ffa_bwd_dq_plain(*args)
                        note(f"dq {dname}", sweep_grad_check(f"tiles dq {tag}", dq, dq_p, dname))
                        if dq[640:].any():
                            raise AssertionError(f"tiles dq {tag}: dq of uncovered rows is not 0")
                        n += 1
                        heads = kffa.dq_pack_heads(hq // hk, d, d, isz, bq, bk)
                        if heads > 1:
                            if not torch.equal(kffa.ffa_bwd_dq_gqa_kernel(*args), dq):
                                raise AssertionError(f"tiles dq_gqa {tag} g{heads}: not bitwise the unpacked")
                            n += 1
                        del dq_p
                    if mb.is_compiled("dkv", isz, d, bq, bk):
                        (dk, dv), (dk_p, dv_p) = kffa.ffa_bwd_dkv_kernel(*args), kffa.ffa_bwd_dkv_plain(*args)
                        note(f"dkv {dname}", sweep_grad_check(f"tiles dk {tag}", dk, dk_p, dname))
                        note(f"dkv {dname}", sweep_grad_check(f"tiles dv {tag}", dv, dv_p, dname))
                        if dk[600:].any() or dv[600:].any():
                            raise AssertionError(f"tiles dkv {tag}: unreached k rows are not 0")
                        n += 1
                    if mb.is_compiled("fused", isz, d, bq, bk):
                        dq_f, dk_f, dv_f = kffa.ffa_bwd_fused_kernel(*args)
                        dq_p, dk_p, dv_p = kffa.ffa_bwd_fused_plain(*args)
                        for gname, a, b in zip(("dq", "dk", "dv"), (dq_f, dk_f, dv_f), (dq_p, dk_p, dv_p)):
                            note(f"fused {dname}", sweep_grad_check(f"tiles fused {gname} {tag}", a, b, dname))
                        n += 1
                torch.cuda.synchronize()
    row = dict(instances_checked=n, worst_max_abs_err=worst, seq=S,
               atol=ATOL, rnorm=RNORM, max_logits_worst_rel_err=ml_worst, max_logits_rtol=ML_RTOL)
    emit({"phase": "tiles_instances", **row})
    return row


def _fit_overhead(rows: list[dict]) -> dict:
    """Least squares of ``ms / hq = a * padded + b * items`` over the
    forward's (B1) times at every tile pair and mask: ``a`` the ms of one
    padded score element of a head, ``b`` one work item's fixed cost;
    ``b / a`` in score-element units (``overhead_elems_fit``) and, held at
    >= 0 (a per-item cost is not negative), the tile policy's constant
    ``overhead_elems`` with ``a`` refitted alone where it binds; each row's
    relative residual."""
    A = np.array([[r["padded_elems"], r["items"]] for r in rows], dtype=np.float64)
    t = np.array([r["ms"] / r["hq"] for r in rows], dtype=np.float64)
    (a, b), *_ = np.linalg.lstsq(A, t, rcond=None)
    fit = dict(ms_per_elem_fit=float(a), ms_per_item_fit=float(b), overhead_elems_fit=float(b / a))
    if b < 0:
        a, b = float(np.dot(A[:, 0], t) / np.dot(A[:, 0], A[:, 0])), 0.0
    resid = (A @ np.array([a, b]) - t) / t
    return dict(fit, ms_per_elem=float(a), ms_per_item=float(b), overhead_elems=float(b / a),
                max_rel_residual=float(np.abs(resid).max()))


def tiles_phase(peaks: dict) -> dict:
    """The tile instances and the tile policy on the card (ROADMAP A3).

    1. ``tiles_smem``: every library's shared memory against the host
       formula, and the card's per-CTA limit (:func:`tiles_smem_check`);
    2. ``tiles_instances``: every compiled instance against its plain
       version (:func:`tiles_instances_phase`);
    3. ``tiles_time``: each kernel's instances at d 128, bf16, timed in
       interleaved rounds (:func:`paired_ms`) at the headline shape (bench.py:
       causal 8192, hq 16, hk 8) and the train shape, each held against its
       plain version on the same inputs, with its bound; the forward also
       at the varlen and sink-window masks, from which OVERHEAD_ELEMS is
       fitted (:func:`_fit_overhead`), and the lse merge timed for
       MERGE_OVERHEAD_PER_ROW; the float32 forward's instances at the
       serving prefill;
    4. ``tiles_path``: ``ffa_attn`` forward and backward through the entry
       point at the headline shape under every tile pin
       (MAGI_ATTENTION_FFA_BLOCK_Q/K), per-pass pins (..._DQ / _DKV), the
       pack flags at a 128-row k tile and MAGI_ATTENTION_FFA_AUTO_TILE=1,
       each against the default 64 x 64 plan (bf16 gates), with the
       launches of each instance in those runs (counts reset just before);
    5. ``tiles_policy``: the policy's per-pass pick and the default's fwd +
       bwd timed in interleaved rounds at the headline and train shapes;
       the mixed dispatch against the single plan on a fragmented varlen
       mask (the registry's pin), timed likewise.
    """
    import torch
    import torch.nn.functional as F

    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.kernels import tile_policy
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn
    from magiattention_tpu_torch.utils import mem_budget as mb

    out = {"smem": tiles_smem_check(), "instances": tiles_instances_phase()}
    gen = torch.Generator(device="cuda").manual_seed(67)
    cases = mask_cases()
    d = 128
    pairs = mb.compiled_tiles("fwd", 2, d)
    timing, fit_rows = {}, []
    flops_per = {"ffa_fwd": 4.0, "ffa_bwd_dq": 6.0, "ffa_bwd_dkv": 8.0, "ffa_bwd_fused": 10.0}
    for key in ("causal_8192_bf16", "train_docs_8192_bf16", "varlen_8192_bf16", "sink_window_8192_bf16"):
        c = cases[key]
        (q, k, v, do), (qr, kr, lo, hi), plan64, params64 = case_inputs(c, gen, with_do=True)
        mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
        live = int(mask.sum().item())
        hq, isz = c["hq"], 2
        plans = {p: get_ffa_plan(qr, kr, lo, hi, c["sq"], c["sk"], *p) for p in pairs}
        prm = {p: dataclasses.replace(params64, num_q_tiles=plans[p].num_q_tiles,
                                      num_k_tiles=plans[p].num_k_tiles, block_q=p[0], block_k=p[1])
               for p in pairs}
        fwd_t = paired_ms({f"{p[0]}x{p[1]}": (lambda p=p: kffa.ffa_fwd_kernel(q, k, v, plans[p], prm[p]))
                           for p in pairs}, rounds=5, samples=3)
        for p in pairs:
            real = kffa._run_items(plans[p].meta, plans[p].run_ptr).sum()
            fit_rows.append(dict(mask=key, tiles=f"{p[0]}x{p[1]}", hq=hq,
                                 ms=statistics.median(fwd_t[f"{p[0]}x{p[1]}"]),
                                 padded_elems=int(real) * p[0] * p[1], items=plans[p].num_work))
        if key not in ("causal_8192_bf16", "train_docs_8192_bf16"):
            del q, k, v, do, mask
            torch.cuda.empty_cache()
            continue
        scale = params64.softmax_scale
        out_p, lse_p = sdpa_attn(q, k, v, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi)
        delta = kffa.ffa_delta_plain(out_p, do)
        n_q, n_kv = q.numel(), k.numel()
        in_bytes = (2 * n_q + 2 * n_kv) * isz + 2 * c["sq"] * hq * 4
        nbytes = {
            "ffa_fwd": (2 * n_q + 2 * n_kv) * isz + c["sq"] * hq * 4,
            "ffa_bwd_dq": in_bytes + n_q * 4, "ffa_bwd_dkv": in_bytes + 2 * n_kv * 4,
            "ffa_bwd_fused": in_bytes + (n_q + 2 * n_kv) * 4,
        }
        plain = {
            "ffa_fwd": lambda: sdpa_attn(q, k, v, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi),
            "ffa_bwd_dq": lambda: kffa.ffa_bwd_dq_plain(q, k, v, do, lse_p, delta, plan64, params64),
            "ffa_bwd_dkv": lambda: kffa.ffa_bwd_dkv_plain(q, k, v, do, lse_p, delta, plan64, params64),
            "ffa_bwd_fused": lambda: kffa.ffa_bwd_fused_plain(q, k, v, do, lse_p, delta, plan64, params64),
        }
        qt, kt, vt = (t.transpose(0, 1)[None] for t in (q, k, v))
        sdpa_kw = dict(is_causal=True) if c.get("library") == "causal" else dict(attn_mask=mask)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw))
        # the fused backward's library call: SDPA's backward alone (its
        # forward's graph kept), as in phase ffa_bwd_fused
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True, **sdpa_kw)
        do_t = do.transpose(0, 1)[None]
        library_bwd_ms = time_ms(lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do_t, retain_graph=True),
                                 samples=5)
        del qg, kg, vg, o_lib, do_t
        lib_ms = {"ffa_fwd": library_ms, "ffa_bwd_fused": library_bwd_ms}
        res = {}
        for lib, kernel in TILE_LIBS.items():
            lib_pairs = mb.compiled_tiles(kernel, 2, d)
            fn = {
                "ffa_fwd": lambda p: kffa.ffa_fwd_kernel(q, k, v, plans[p], prm[p]),
                "ffa_bwd_dq": lambda p: kffa.ffa_bwd_dq_kernel(q, k, v, do, lse_p, delta, plans[p], prm[p]),
                "ffa_bwd_dkv": lambda p: kffa.ffa_bwd_dkv_kernel(q, k, v, do, lse_p, delta, plans[p], prm[p]),
                "ffa_bwd_fused": lambda p: kffa.ffa_bwd_fused_kernel(q, k, v, do, lse_p, delta, plans[p], prm[p]),
            }[lib]
            want = plain[lib]()
            want = want if isinstance(want, tuple) else (want,)
            errs = {}
            for p in lib_pairs:
                got = fn(p)
                got = got if isinstance(got, tuple) else (got,)
                if lib == "ffa_fwd":
                    e = errors(got[0], got[1], want[0], want[1])
                    check(f"tiles_time {key} {lib} {p}", e, "bfloat16")
                else:
                    es = [grad_check(f"tiles_time {key} {lib} {p}", a, b, "bfloat16")
                          for a, b in zip(got, want)]
                    e = {m: max(x[m] for x in es) for m in es[0]}
                errs[p] = e
                del got
            del want
            t = fwd_t if lib == "ffa_fwd" else paired_ms(
                {f"{p[0]}x{p[1]}": (lambda p=p: fn(p)) for p in lib_pairs}, rounds=5, samples=3)
            b_ms, b_by = bound(flops_per[lib] * hq * d * live, nbytes[lib], "bfloat16", peaks)
            plain_ms = time_ms(plain[lib], warmup=1, samples=3)
            res[lib] = {
                f"{p[0]}x{p[1]}": dict(
                    ms=statistics.median(t[f"{p[0]}x{p[1]}"]), rounds_ms=t[f"{p[0]}x{p[1]}"],
                    max_abs_err=errs[p]["max_abs_err"], rel_norm_err=errs[p]["rel_norm_err"],
                    items=plans[p].num_work if lib in ("ffa_fwd", "ffa_bwd_dq") else plans[p].num_work_t,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms.get(lib),
                    smem_bytes=mb.ffa_smem_bytes(kernel, d, *p, 2),
                )
                for p in lib_pairs
            }
        if key == "causal_8192_bf16":  # the packed instances (group 2: 2 heads a CTA)
            packed = {
                "ffa_fwd_gqa": (lambda p: kffa.ffa_fwd_gqa_kernel(q, k, v, plans[p], prm[p]),
                                "fwd", plain["ffa_fwd"]),
                "ffa_bwd_dq_gqa": (lambda p: kffa.ffa_bwd_dq_gqa_kernel(
                    q, k, v, do, lse_p, delta, plans[p], prm[p]), "dq", plain["ffa_bwd_dq"]),
            }
            for lib, (fn, base_lib, plain_fn) in packed.items():
                lib_pairs = mb.compiled_tiles(PACKED_LIBS[lib], 2, d, heads=2)
                want = plain_fn()
                errs = {}
                for p in lib_pairs:
                    got = fn(p)
                    if lib == "ffa_fwd_gqa":
                        e = errors(got[0], got[1], want[0], want[1])
                        check(f"tiles_time {key} {lib} {p}", e, "bfloat16")
                    else:
                        e = grad_check(f"tiles_time {key} {lib} {p}", got, want, "bfloat16")
                    errs[p] = e
                    del got
                del want
                t = paired_ms({f"{p[0]}x{p[1]}": (lambda p=p: fn(p)) for p in lib_pairs},
                              rounds=5, samples=3)
                base_row = res[f"ffa_{'fwd' if base_lib == 'fwd' else 'bwd_dq'}"]["64x64"]
                res[lib] = {
                    f"{p[0]}x{p[1]}": dict(
                        ms=statistics.median(t[f"{p[0]}x{p[1]}"]), rounds_ms=t[f"{p[0]}x{p[1]}"],
                        max_abs_err=errs[p]["max_abs_err"], plain_ms=base_row["plain_ms"],
                        bound_ms=base_row["bound_ms"], bound_by=base_row["bound_by"],
                        library_ms=base_row["library_ms"], heads_per_cta=2,
                        smem_bytes=mb.ffa_smem_bytes(PACKED_LIBS[lib], d, *p, 2, 2),
                    )
                    for p in lib_pairs
                }
        timing[key] = res
        emit({"phase": "tiles_time", "case": key, "q": list(q.shape), "kv": list(k.shape),
              "live_pairs": live, **res})
        del q, k, v, do, out_p, lse_p, delta, mask, qt, kt, vt
        torch.cuda.empty_cache()
    # the float32 (3xTF32) forward's fit rows: the serving prefill and the
    # varlen mask
    f32_rows = []
    for key in ("serving_prefill_f32", "varlen_8192_bf16"):
        c = dict(cases[key], dtype=torch.float32)
        (q, k, v), (qr, kr, lo, hi), _, params64 = case_inputs(c, gen)
        f32_pairs = mb.compiled_tiles("fwd", 4, d)
        plans = {p: get_ffa_plan(qr, kr, lo, hi, c["sq"], c["sk"], *p) for p in f32_pairs}
        prm = {p: dataclasses.replace(params64, num_q_tiles=plans[p].num_q_tiles,
                                      num_k_tiles=plans[p].num_k_tiles, block_q=p[0], block_k=p[1])
               for p in f32_pairs}
        t = paired_ms({f"{p[0]}x{p[1]}": (lambda p=p: kffa.ffa_fwd_kernel(q, k, v, plans[p], prm[p]))
                       for p in f32_pairs}, rounds=5, samples=3)
        for p in f32_pairs:
            real = kffa._run_items(plans[p].meta, plans[p].run_ptr).sum()
            f32_rows.append(dict(mask=key.replace("bf16", "f32"), tiles=f"{p[0]}x{p[1]}", hq=c["hq"],
                                 ms=statistics.median(t[f"{p[0]}x{p[1]}"]),
                                 padded_elems=int(real) * p[0] * p[1], items=plans[p].num_work))
        del q, k, v
    fit = {}
    S, hq = 8192, 16
    for isz, rows in ((2, fit_rows), (4, f32_rows)):
        f = _fit_overhead(rows)
        # the lse merge of a mixed dispatch at the headline shape, per row
        # and head in score-element units of the fit
        dt = torch.bfloat16 if isz == 2 else torch.float32
        o1, o2 = (torch.randn((S, hq, d), generator=gen, device="cuda").to(dt) for _ in range(2))
        l1, l2 = (torch.randn((S, hq), generator=gen, device="cuda") for _ in range(2))
        f["merge_ms"] = time_ms(lambda: kffa._merge_out_lse(o1, l1, o2, l2))
        f["merge_per_row_elems"] = f["merge_ms"] / (S * hq) / f["ms_per_elem"]
        f["rows"] = rows
        fit[isz] = f
        del o1, o2, l1, l2
    emit({"phase": "tiles_fit", "itemsize_2": fit[2], "itemsize_4": fit[4], "in_code": dict(
        OVERHEAD_ELEMS=tile_policy.OVERHEAD_ELEMS,
        MERGE_OVERHEAD_PER_ROW=tile_policy.MERGE_OVERHEAD_PER_ROW)})

    # the float32 (3xTF32) forward's instances at the serving prefill
    c = cases["serving_prefill_f32"]
    (q, k, v), (qr, kr, lo, hi), plan64, params64 = case_inputs(c, gen)
    want = sdpa_attn(q, k, v, qr, kr, softmax_scale=params64.softmax_scale, d_lo=lo, d_hi=hi)
    f32 = {}
    f32_pairs = mb.compiled_tiles("fwd", 4, d)
    f32_fn = {}
    for p in f32_pairs:
        pl = get_ffa_plan(qr, kr, lo, hi, c["sq"], c["sk"], *p)
        pr = dataclasses.replace(params64, num_q_tiles=pl.num_q_tiles, num_k_tiles=pl.num_k_tiles,
                                 block_q=p[0], block_k=p[1])
        f32_fn[p] = lambda pl=pl, pr=pr: kffa.ffa_fwd_kernel(q, k, v, pl, pr)
        e = errors(*f32_fn[p](), *want)
        check(f"tiles f32 fwd {p}", e, "float32")
        f32[p] = e
    t = paired_ms({f"{p[0]}x{p[1]}": f32_fn[p] for p in f32_pairs}, rounds=5, samples=3)
    mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
    live = int(mask.sum().item())
    b_ms, b_by = fwd_bound(4.0 * c["hq"] * d * live,
                           (2 * q.numel() + 2 * k.numel()) * 4 + c["sq"] * c["hq"] * 4, "float32", peaks)
    plain_ms = time_ms(lambda: sdpa_attn(q, k, v, qr, kr, softmax_scale=params64.softmax_scale,
                                         d_lo=lo, d_hi=hi), warmup=1, samples=3)
    # SDPA with the band mask, as in phase ffa_fwd (every row is covered)
    qt, kt, vt = (t.transpose(0, 1)[None] for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
    timing["serving_prefill_f32"] = {"ffa_fwd": {
        f"{p[0]}x{p[1]}": dict(ms=statistics.median(t[f"{p[0]}x{p[1]}"]), rounds_ms=t[f"{p[0]}x{p[1]}"],
                               max_abs_err=f32[p]["max_abs_err"], plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=library_ms)
        for p in f32_pairs
    }}
    emit({"phase": "tiles_time", "case": "serving_prefill_f32", **timing["serving_prefill_f32"]})
    del q, k, v, want, mask, qt, kt, vt
    torch.cuda.empty_cache()

    out["path"] = tiles_path_phase()
    out["policy"] = tiles_policy_phase()
    out["timing"], out["fit"] = timing, fit
    return out


def _fwd_bwd(q, k, v, do, qr, kr, lo, hi):
    """One ``ffa_attn`` forward and backward through the entry point: (out,
    lse, dq, dk, dv)."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import ffa_attn

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    o, lse = ffa_attn(qg, kg, vg, qr, kr, d_lo=lo, d_hi=hi)
    return (o, lse, *torch.autograd.grad(o, (qg, kg, vg), do))


def _same_attn(what: str, got, want) -> dict:
    """out/lse in the forward's bf16 gates, gradients in the backward's."""
    err = errors(got[0], got[1], want[0], want[1])
    check(what, err, "bfloat16")
    for gname, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        e = grad_check(f"{what} {gname}", a, b, "bfloat16")
        err[f"{gname}_max_abs_err"] = e["max_abs_err"]
    return err


# the tile pins of the tiles path: env -> what it pins
TILE_PINS = (
    {"MAGI_ATTENTION_BACKEND_FFA_BWD": "split"},
    {"MAGI_ATTENTION_BACKEND_FFA_BWD": "fused"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "64"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q": "64", "MAGI_ATTENTION_FFA_BLOCK_K": "128"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "128"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q_DQ": "128", "MAGI_ATTENTION_FFA_BLOCK_K_DQ": "128",
     "MAGI_ATTENTION_FFA_BLOCK_Q_DKV": "128", "MAGI_ATTENTION_FFA_BLOCK_K_DKV": "128",
     "MAGI_ATTENTION_BACKEND_FFA_BWD": "split"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q_DKV": "128", "MAGI_ATTENTION_FFA_BLOCK_K_DKV": "64",
     "MAGI_ATTENTION_BACKEND_FFA_BWD": "fused"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q_DKV": "64", "MAGI_ATTENTION_FFA_BLOCK_K_DKV": "128",
     "MAGI_ATTENTION_BACKEND_FFA_BWD": "fused"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q_DKV": "128", "MAGI_ATTENTION_FFA_BLOCK_K_DKV": "128",
     "MAGI_ATTENTION_BACKEND_FFA_BWD": "fused"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q_DQ": "128", "MAGI_ATTENTION_FFA_BLOCK_K_DQ": "64",
     "MAGI_ATTENTION_FFA_BLOCK_Q_DKV": "64", "MAGI_ATTENTION_FFA_BLOCK_K_DKV": "128",
     "MAGI_ATTENTION_BACKEND_FFA_BWD": "split"},
    {"MAGI_ATTENTION_FFA_BLOCK_Q_DQ": "64", "MAGI_ATTENTION_FFA_BLOCK_K_DQ": "128",
     "MAGI_ATTENTION_FFA_BLOCK_Q_DKV": "128", "MAGI_ATTENTION_FFA_BLOCK_K_DKV": "64",
     "MAGI_ATTENTION_BACKEND_FFA_BWD": "split"},
    {"MAGI_ATTENTION_FFA_BLOCK_K": "128", "MAGI_ATTENTION_FFA_GQA_PACK": "1",
     "MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1", "MAGI_ATTENTION_BACKEND_FFA_BWD": "split"},
    {"MAGI_ATTENTION_FFA_AUTO_TILE": "1"},
)


def tiles_path_phase() -> dict:
    """``ffa_attn`` forward and backward through the entry point at the
    headline shape under every pin of :data:`TILE_PINS`, against the
    default 64 x 64 plan: the tiles path. The launch counts are reset just
    before and read just after; every compiled bf16 d-128 instance of the
    forward, dq, dk/dv and fused kernels (and the packed 64 x 128 ones) must
    have run at least once, and no plain version."""
    import torch

    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts, tile_launch_counts
    from magiattention_tpu_torch.kernels.ffa import ffa_attn
    from magiattention_tpu_torch.utils import mem_budget as mb

    gen = torch.Generator(device="cuda").manual_seed(71)
    c = mask_cases()["causal_8192_bf16"]
    (q, k, v, do), (qr, kr, lo, hi), _, _ = case_inputs(c, gen, with_do=True)
    base = _fwd_bwd(q, k, v, do, qr, kr, lo, hi)
    torch.cuda.synchronize()
    # the float32 forward (the serving prefill's) at every fwd pin
    cf = mask_cases()["serving_prefill_f32"]
    (qf, kf, vf), (qrf, krf, lof, hif), _, _ = case_inputs(cf, gen)
    with torch.no_grad():
        base_f = ffa_attn(qf, kf, vf, qrf, krf, d_lo=lof, d_hi=hif)
    torch.cuda.synchronize()
    reset_launch_counts()
    rows = []
    for pins in TILE_PINS:
        with scoped_env(pins):
            got = _fwd_bwd(q, k, v, do, qr, kr, lo, hi)
        rows.append(dict(pins=pins, **_same_attn(f"tiles_path {pins}", got, base)))
        del got
    for bq, bk in mb.compiled_tiles("fwd", 4, 128):
        pins = {"MAGI_ATTENTION_FFA_BLOCK_Q": str(bq), "MAGI_ATTENTION_FFA_BLOCK_K": str(bk)}
        with scoped_env(pins), torch.no_grad():
            got = ffa_attn(qf, kf, vf, qrf, krf, d_lo=lof, d_hi=hif)
        err = errors(got[0], got[1], base_f[0], base_f[1])
        check(f"tiles_path float32 {pins}", err, "float32")
        rows.append(dict(pins=pins, dtype="float32", **err))
    torch.cuda.synchronize()
    counts, tiles = launch_counts(), tile_launch_counts()
    missing = [
        f"{lib} {p[0]}x{p[1]}" for lib, kernel in TILE_LIBS.items()
        for p in mb.compiled_tiles(kernel, 2, 128)
        if tiles[lib].get(f"bfloat16 {p[0]}x{p[1]}", 0) == 0
    ] + [
        f"ffa_fwd float32 {p[0]}x{p[1]}" for p in mb.compiled_tiles("fwd", 4, 128)
        if tiles["ffa_fwd"].get(f"float32 {p[0]}x{p[1]}", 0) == 0
    ] + [f"{lib} 64x128" for lib in PACKED_LIBS if tiles[lib].get("bfloat16 64x128", 0) == 0]
    plains = {n: counts[n] for n in ("sdpa_attn", "ffa_bwd_dq_plain", "ffa_bwd_dkv_plain",
                                     "ffa_bwd_fused_plain", "ffa_delta_plain") if counts[n]}
    emit({"phase": "tiles_path", "runs": rows, "tile_launches": tiles, "missing": missing,
          "plain_calls": plains})
    if missing or plains:
        raise AssertionError(f"tiles path: instances never launched {missing}, plain calls {plains}")
    # a pair the float32 backward is not compiled for raises, nothing falls back
    qg = qf.detach().requires_grad_(True)
    with scoped_env({"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "128"}):
        o, _ = ffa_attn(qg, kf, vf, qrf, krf, d_lo=lof, d_hi=hif)
        try:
            o.sum().backward()
        except ValueError as e:
            raised = str(e)
        else:
            raise AssertionError("a float32 backward at 128 x 128 ran: it is not compiled")
    emit({"phase": "tiles_uncompiled", "raised": raised})
    del q, k, v, do, base, qf, kf, vf, qg, o
    torch.cuda.empty_cache()
    return {"tile_launches": tiles}


def fragmented_mask(S: int = 8192):
    """A varlen mask with dense and fragmented slices: two causal documents
    of 2048, then 2048 rows in 128 documents of 16 (each a causal triangle
    far smaller than a tile), and a 16-key sliding band over the last 2048
    rows."""
    from magiattention_tpu_torch.kernels.mask_utils import BAND_INF

    qr, kr, lo, hi = [[0, 2048], [2048, 4096]], [[0, 2048], [2048, 4096]], [-BAND_INF] * 2, [0, 0]
    for s in range(4096, 6144, 16):
        qr.append([s, s + 16])
        kr.append([s, s + 16])
        lo.append(-BAND_INF)
        hi.append(0)
    qr.append([6144, S])
    kr.append([6144, S])
    lo.append(-15)
    hi.append(0)
    return (np.array(qr, np.int32), np.array(kr, np.int32), np.array(lo, np.int32),
            np.array(hi, np.int32))


def tiles_policy_phase() -> dict:
    """The policy on the card: at the headline and train shapes, the
    per-pass pick under MAGI_ATTENTION_FFA_AUTO_TILE=1 and the default
    (64 x 64) fwd + bwd of ``ffa_attn``, timed in interleaved rounds; on
    :func:`fragmented_mask` (headline heads) the mixed dispatch under the
    registry's mixed pin against the single plan (pinned single), timed
    likewise, its gradients against the single plan's. Where the pin finds
    no finer tiling than the default (no mixed split on this card's
    candidates), the split is run at the coarse pair (128, 128) with the
    fragmented slices at 64 x 64 through the same merge
    (``kernels/ffa.py:_FFAMixed``), and reported so."""
    import torch

    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.kernels import tile_policy
    from magiattention_tpu_torch.kernels.ffa_plan import get_ffa_plan

    gen = torch.Generator(device="cuda").manual_seed(73)
    cases = mask_cases()
    auto = {"MAGI_ATTENTION_FFA_AUTO_TILE": "1"}
    res = {}
    for key in ("causal_8192_bf16", "train_docs_8192_bf16"):
        c = cases[key]
        (q, k, v, do), (qr, kr, lo, hi), _, _ = case_inputs(c, gen, with_do=True)
        pick = tile_policy.choose_blocks_per_pass(qr, kr, lo, hi, c["sq"], c["sk"], 128, 128, 2)
        t = paired_ms({
            "default_64x64": lambda: _fwd_bwd(q, k, v, do, qr, kr, lo, hi),
            "auto": lambda: _with_env(auto, lambda: _fwd_bwd(q, k, v, do, qr, kr, lo, hi)),
        }, rounds=7, samples=3)
        row = dict(case=key, pick=dict(fwd=pick[0], dq=pick[1], dkv=pick[2]),
                   default_ms=statistics.median(t["default_64x64"]), auto_ms=statistics.median(t["auto"]),
                   rounds=t)
        emit({"phase": "tiles_policy", **row})
        res[key] = row
        del q, k, v, do
        torch.cuda.empty_cache()

    # the float32 serving prefill, forward alone (what serving runs)
    c = cases["serving_prefill_f32"]
    (q, k, v), (qr, kr, lo, hi), _, _ = case_inputs(c, gen)
    pick = tile_policy.choose_blocks_per_pass(qr, kr, lo, hi, c["sq"], c["sk"], 128, 128, 4)

    def fwd():
        with torch.no_grad():
            return kffa.ffa_attn(q, k, v, qr, kr, d_lo=lo, d_hi=hi)

    t = paired_ms({"default_64x64": fwd, "auto": lambda: _with_env(auto, fwd)}, rounds=7, samples=3)
    row = dict(case="serving_prefill_f32_fwd", pick=dict(fwd=pick[0], dq=pick[1], dkv=pick[2]),
               default_ms=statistics.median(t["default_64x64"]), auto_ms=statistics.median(t["auto"]),
               rounds=t)
    emit({"phase": "tiles_policy", **row})
    res["serving_prefill_f32_fwd"] = row
    del q, k, v

    S, hq, hk, d = 8192, 16, 8, 128
    qr, kr, lo, hi = fragmented_mask(S)
    q, k, v, do = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in (
        (S, hq, d), (S, hk, d), (S, hk, d), (S, hq, d)))
    single = {"MAGI_ATTENTION_BACKEND_MIXED_BLOCKS": "single"}
    mixed = {"MAGI_ATTENTION_BACKEND_MIXED_BLOCKS": "mixed"}
    with scoped_env(mixed):
        mix = tile_policy.choose_mixed_dispatch(qr, kr, lo, hi, S, S, d, d, 2)
    with scoped_env({"MAGI_ATTENTION_BACKEND_MIXED_BLOCKS": None}):
        unpinned = tile_policy.choose_mixed_dispatch(qr, kr, lo, hi, S, S, d, d, 2)
    base = _with_env(single, lambda: _fwd_bwd(q, k, v, do, qr, kr, lo, hi))
    scale = d ** -0.5
    if mix is not None:
        how = "policy (mixed pin)"
        run_mixed = lambda: _with_env(mixed, lambda: _fwd_bwd(q, k, v, do, qr, kr, lo, hi))  # noqa: E731
        coarse, fine = mix.coarse_blocks, mix.fine_blocks
        n_dense, n_frag = len(mix.dense_idx), len(mix.frag_idx)
    else:
        how = "forced split: coarse (128, 128), fragmented slices at (64, 64)"
        coarse, fine = (128, 128), (64, 64)
        ratios = tile_policy.slice_cover_ratios(qr, kr, lo, hi, *coarse)
        fi, di = np.nonzero(ratios >= tile_policy.FRAG_THRESHOLD)[0], np.nonzero(ratios < tile_policy.FRAG_THRESHOLD)[0]
        n_dense, n_frag = len(di), len(fi)
        pa = get_ffa_plan(qr[di], kr[di], lo[di], hi[di], S, S, *coarse)
        pb = get_ffa_plan(qr[fi], kr[fi], lo[fi], hi[fi], S, S, *fine)
        prm_a, prm_b = kffa._mixed_params(pa, scale, 0.0), kffa._mixed_params(pb, scale, 0.0)

        def run_mixed():
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            o, lse = kffa._FFAMixed.apply(qg, kg, vg, pa, pb, prm_a, prm_b)
            return (o, lse, *torch.autograd.grad(o, (qg, kg, vg), do))
    err = _same_attn("tiles mixed vs single", run_mixed(), base)
    t = paired_ms({
        "single": lambda: _with_env(single, lambda: _fwd_bwd(q, k, v, do, qr, kr, lo, hi)),
        "mixed": run_mixed,
    }, rounds=7, samples=3)
    row = dict(case="fragmented_8192_bf16", how=how, coarse=coarse, fine=fine, dense_slices=n_dense,
               fragmented_slices=n_frag, unpinned_decision="mixed" if unpinned is not None else "single",
               single_ms=statistics.median(t["single"]), mixed_ms=statistics.median(t["mixed"]),
               rounds=t, **err)
    emit({"phase": "tiles_mixed", **row})
    res["mixed"] = row
    del q, k, v, do, base
    torch.cuda.empty_cache()
    res["gate_host"] = tiles_gate_host()
    return res


def tiles_gate_host(n_steps: int = 16, S: int = 8192) -> dict:
    """The host time of ``ffa_attn``'s tile flow (``resolve_dispatch``:
    the mixed gate, then the default tiles) on packings whose document
    boundaries change every step, as a trainer's do: each step a new
    causal document set of 8192 tokens (documents of 256-2048 tokens), so
    every call misses the per-geometry memo. bf16 (the gate declines
    before scoring) and float32 (the gate scores), ms per call."""
    from magiattention_tpu_torch.kernels import ffa as kffa
    from magiattention_tpu_torch.kernels.mask_utils import types_to_bands

    rng = np.random.default_rng(79)
    geoms = []
    for _ in range(n_steps):
        cuts = [0]
        while cuts[-1] < S:
            cuts.append(min(S, cuts[-1] + int(rng.integers(256, 2049))))
        qr = np.array([[a, b] for a, b in zip(cuts[:-1], cuts[1:])], np.int32)
        geoms.append((qr, qr.copy(), *types_to_bands(qr, qr, np.ones(len(qr), np.int32))))
    row = {}
    for dname, isz in (("bfloat16", 2), ("float32", 4)):
        ms = []
        for qr, kr, lo, hi in geoms:
            t0 = time.perf_counter()
            kffa.resolve_dispatch(qr, kr, lo, hi, S, S, 128, 128, isz)
            ms.append((time.perf_counter() - t0) * 1e3)
        row[dname] = dict(median_ms=statistics.median(ms), max_ms=max(ms), ms=ms)
    row.update(steps=n_steps, docs_per_step=[len(g[0]) for g in geoms])
    emit({"phase": "tiles_gate_host", **row})
    return row


def _with_env(env: dict, fn):
    from magiattention_tpu_torch.env.general import scoped_env

    with scoped_env(env):
        return fn()


DECODE_LENGTHS = [0, 1, 15, 16, 17, 1000, 4095, 4096]


def decode_phase(peaks: dict) -> list[dict]:
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_kernel, paged_decode_plain,
    )
    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, assign_pages

    S, hq, hk, d, ps, P, N = 8, 32, 8, 128, 16, 256, 1024
    lengths = DECODE_LENGTHS
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
        nbytes = decode_bytes(q, lse_k, lengths, hk, ps)
        b_ms, b_by = bound(4.0 * hq * d * sum(lengths), nbytes, dname, peaks)
        res = dict(
            case=f"decode_8slots_{dname}", dtype=dname, lengths=lengths,
            q=list(q.shape), pages=list(cache.k_pages.shape),
            **split_of(cache), **err,
            ms=time_ms(kernel), device_ms=graph_ms(kernel),
            plain_ms=time_ms(plain, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            atol=ATOL[dname], rnorm=RNORM[dname],
        )
        res["gb_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
        res["device_gb_s"] = nbytes / (res["device_ms"] * 1e-3) / 1e9
        results.append(res)
        emit({"phase": "paged_decode", **res})
    return results


def split_of(cache) -> dict:
    """The split plan B10 and B11 launch with on this card's cache."""
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import split_plan_of

    splits, split_len = split_plan_of(
        cache, torch.cuda.get_device_properties(0).multi_processor_count
    )
    return {"splits": splits, "split_len": split_len}


def decode_pages(dt, hk: int, seed: int, lengths=None, d: int = 128, ps: int = 16,
                 P: int = 256):
    """``decode_phase``'s cache at ``hk`` kv heads: 8 slots with
    ``lengths`` (default ``DECODE_LENGTHS``) over 1024 random pages of
    ``ps`` (default 16; tables of ``P``), every page holding data, dead
    ones too."""
    import torch

    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, assign_pages

    lengths = DECODE_LENGTHS if lengths is None else lengths
    S, N = 8, 1024
    perm = np.random.default_rng(seed).permutation(N)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = PagedKVCache.create(N, ps, hk, d, S, P, dtype=dt, device="cuda")
    cache.k_pages.copy_(torch.randn(cache.k_pages.shape, generator=gen, device="cuda"))
    cache.v_pages.copy_(torch.randn(cache.v_pages.shape, generator=gen, device="cuda"))
    used = 0
    for s, length in enumerate(lengths):
        n = -(-length // ps)
        assign_pages(cache, s, perm[used : used + n])
        used += n
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def int8_pages(hk: int, seed: int, lengths, d: int = 128, ps: int = 16, P: int = 256):
    """:func:`decode_pages`'s layout over an int8 cache: random codes in
    [-127, 127] on every page and a random (page, kv head) scale in [0.005,
    0.02) for K and for V."""
    import torch

    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, assign_pages

    S, N = 8, 1024
    perm = np.random.default_rng(seed).permutation(N)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache = PagedKVCache.create(N, ps, hk, d, S, P, dtype=torch.int8, device="cuda")
    for pages, scales in ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)):
        pages.copy_(torch.randint(-127, 128, pages.shape, generator=gen, device="cuda"))
        scales.copy_(0.005 + 0.015 * torch.rand(scales.shape, generator=gen, device="cuda"))
    used = 0
    for s, length in enumerate(lengths):
        n = -(-length // ps)
        assign_pages(cache, s, perm[used : used + n])
        used += n
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def spec_limits(lengths: list[int], spec_k: int) -> list[list[int]]:
    """Live columns of each (slot, draft token) row: ``length - (spec_k -
    1 - t)``, at least 0."""
    return [[max(0, n - (spec_k - 1 - t)) for t in range(spec_k)] for n in lengths]


def check_empty_rows(what: str, out, lse, limits: list[list[int]]) -> None:
    """Every row with no live column is (0, -inf); ``out (S, spec_k, hq,
    d)``, ``lse (S, spec_k, hq)``."""
    import torch

    for s_, lim in enumerate(limits):
        for t, n in enumerate(lim):
            if n == 0 and (out[s_, t].any() or not torch.isneginf(lse[s_, t]).all()):
                raise AssertionError(f"{what}: empty row is not (0, -inf)")


def decode_bytes(q, lse, lengths: list[int], hk: int, ps: int) -> int:
    """Bytes a paged decode must move: q and out, lse, each live K/V row
    once per kv head, the live table entries and the lengths."""
    isz, d = q.element_size(), q.shape[-1]
    return (
        2 * q.numel() * isz + lse.numel() * 4
        + sum(lengths) * hk * d * 2 * isz
        + sum(-(-n // ps) for n in lengths) * 4 + len(lengths) * 4
    )


def int8_bytes(q, lse, lengths: list[int], hk: int, ps: int) -> int:
    """:func:`decode_bytes` over int8 pages: one byte a code, and each live
    page's K and V scale per kv head."""
    isz, d = q.element_size(), q.shape[-1]
    pages = sum(-(-n // ps) for n in lengths)
    return (
        2 * q.numel() * isz + lse.numel() * 4
        + sum(lengths) * hk * d * 2 + pages * hk * 2 * 4 + pages * 4 + len(lengths) * 4
    )


def decode_spec_phase(peaks: dict) -> dict[str, dict]:
    """B11 at the decode phase's geometry: spec_k 2 and 4 at hk 8 (8 and 16
    rows per CTA), spec_k 4 at hk 4 (32 rows), float32 and bf16, against
    its plain version; rows with nothing live are (0, -inf); at spec_k 1 it
    gives B10's bits."""
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_kernel, paged_decode_spec_kernel, paged_decode_spec_plain,
    )

    S, hq, d, ps = 8, 32, 128, 16
    scale = d ** -0.5
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        for hk, spec_k in ((8, 2), (8, 4), (4, 4)):
            cache = decode_pages(dt, hk, seed=3)
            gen = torch.Generator(device="cuda").manual_seed(4)
            q = torch.randn((S, spec_k, hq, d), generator=gen, device="cuda").to(dt)
            if spec_k == 4 and hk == 8:  # B11 at spec_k 1 is B10, bit for bit
                one = paged_decode_spec_kernel(q[:, :1], cache, scale)
                ref = paged_decode_kernel(q[:, 0], cache, scale)
                if not (torch.equal(one[0][:, 0], ref[0]) and torch.equal(one[1][:, 0], ref[1])):
                    raise AssertionError(f"paged_decode_spec_{dname}: spec_k 1 is not B10's bits")

            def kernel():
                return paged_decode_spec_kernel(q, cache, scale)

            def plain():
                return paged_decode_spec_plain(q, cache, scale)

            out_k, lse_k = kernel()
            out_p, lse_p = plain()
            torch.cuda.synchronize()
            name = f"spec{spec_k}_hk{hk}_{dname}"
            err = errors(out_k, lse_k, out_p, lse_p)
            check(f"paged_decode_spec_{name}", err, dname)
            limits = spec_limits(DECODE_LENGTHS, spec_k)
            check_empty_rows(f"paged_decode_spec_{name}", out_k, lse_k, limits)
            nbytes = decode_bytes(q, lse_k, DECODE_LENGTHS, hk, ps)
            pairs = sum(sum(lim) for lim in limits) * hq  # live (row, column)
            b_ms, b_by = bound(4.0 * d * pairs, nbytes, dname, peaks)
            res = dict(
                case=name, dtype=dname, spec_k=spec_k, hk=hk,
                rows_per_cta=spec_k * hq // hk, lengths=DECODE_LENGTHS,
                q=list(q.shape), pages=list(cache.k_pages.shape),
                **split_of(cache), **err,
                ms=time_ms(kernel), device_ms=graph_ms(kernel),
                plain_ms=time_ms(plain, warmup=1),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                atol=ATOL[dname], rnorm=RNORM[dname],
            )
            res["gb_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
            res["device_gb_s"] = nbytes / (res["device_ms"] * 1e-3) / 1e9
            results[name] = res
            emit({"phase": "paged_decode_spec", **res})
            del cache
    return results


def decode_int8_phase(peaks: dict) -> dict[str, dict]:
    """B12 at the decode phase's geometry, the int8 pages written by the
    port's own (wave-batched) append on the card, against its plain version
    for q float32 and bf16; the empty slot is (0, -inf). Then a 512-row
    append that starts mid-page, waves against the row-by-row loop, bit for
    bit."""
    import torch

    from magiattention_tpu_torch.kernels import paged_kv
    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_int8_kernel, paged_decode_int8_plain,
    )

    S, hq, hk, d, ps, P, N = 8, 32, 8, 128, 16, 256, 1024
    scale = d ** -0.5
    perm = np.random.default_rng(5).permutation(N)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cache = paged_kv.PagedKVCache.create(N, ps, hk, d, S, P, dtype=torch.int8, device="cuda")
    used = 0
    t0 = time.perf_counter()
    for s, length in enumerate(DECODE_LENGTHS):
        n = -(-length // ps)
        paged_kv.assign_pages(cache, s, perm[used : used + n])
        used += n
        for start in range(0, length, 512):  # prefill-sized chunks
            rows = min(512, length - start)
            k = torch.randn((rows, hk, d), generator=gen, device="cuda")
            v = torch.randn((rows, hk, d), generator=gen, device="cuda")
            paged_kv.append_kv(cache, s, k, v)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    if cache.lengths.tolist() != DECODE_LENGTHS:
        raise AssertionError("paged_decode_int8: appends did not reach the lengths")
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        q = torch.randn((S, hq, d), generator=gen, device="cuda").to(dt)

        def kernel():
            return paged_decode_int8_kernel(q, cache, scale)

        def plain():
            return paged_decode_int8_plain(q, cache, scale)

        out_k, lse_k = kernel()
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        err = errors(out_k, lse_k, out_p, lse_p)
        check(f"paged_decode_int8_q{dname}", err, dname)
        if out_k[0].any() or not torch.isneginf(lse_k[0]).all():
            raise AssertionError("paged_decode_int8: empty slot is not (0, -inf)")
        nbytes = int8_bytes(q, lse_k, DECODE_LENGTHS, hk, ps)
        b_ms, b_by = bound(4.0 * hq * d * sum(DECODE_LENGTHS), nbytes, "float32", peaks)
        res = dict(
            case=f"int8_pages_q{dname}", q_dtype=dname, lengths=DECODE_LENGTHS,
            q=list(q.shape), pages=list(cache.k_pages.shape),
            **split_of(cache), **err,
            ms=time_ms(kernel), device_ms=graph_ms(kernel),
            plain_ms=time_ms(plain, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            atol=ATOL[dname], rnorm=RNORM[dname], append_s=append_s,
        )
        res["gb_s"] = nbytes / (res["ms"] * 1e-3) / 1e9
        res["device_gb_s"] = nbytes / (res["device_ms"] * 1e-3) / 1e9
        results[dname] = res
        emit({"phase": "paged_decode_int8", **res})

    # waves against the loop: 512 rows from position 37 (mid-page) over
    # the pages of the slot of length 1000, whose scales are all in use
    pages, scales = cache.k_pages.clone(), cache.k_scales.clone()
    table = cache.page_table[5].long()
    pos = 37 + torch.arange(512, device="cuda")
    page_idx, row = table[pos // ps], pos % ps
    x = 1.5 * torch.randn((512, hk, d), generator=gen, device="cuda")
    loop_pages, loop_scales = pages.clone(), scales.clone()
    t0 = time.perf_counter()
    paged_kv._quantize_append(loop_pages, loop_scales, page_idx, row, x)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paged_kv._quantize_append_waves(pages, scales, page_idx, row, x, 37)
    torch.cuda.synchronize()
    waves_s = time.perf_counter() - t0
    if not (torch.equal(pages, loop_pages) and torch.equal(scales, loop_scales)):
        raise AssertionError("int8 append: waves differ from the row-by-row loop")
    if torch.equal(scales, cache.k_scales):
        raise AssertionError("int8 append: no scale was raised (case too weak)")
    emit({
        "phase": "int8_append", "rows": 512, "start": 37,
        "waves": len(paged_kv.append_waves(37, 512, ps)), "bit_identical": True,
        "loop_s": loop_s, "waves_s": waves_s,
    })
    return results


def decode_split_phase() -> dict:
    """B10, B11 and B12 where the split walk has its edges (checked, not
    timed): slot lengths at the split length, one below and one and two
    past it, twice it and one past, and the full table (``P * ps``), so
    spec rows end in an earlier split than their slot's last token. Two
    tables: the decode cell's (d 128, pages of 16, hq 32: hk 8 and 4,
    spec_k 1 (B10), 2 and 4) and d 64 over pages of 24 (page and row by
    division; hq 16: hk 2 and 4, 8 to 32 rows a CTA); float32 and bf16
    against the plain versions at the decode tolerances, empty rows (0,
    -inf), two launches equal to the bit, and B11 at spec_k 1 equal to B10
    to the bit. B12 over int8 pages of both tables (:func:`int8_pages`) at
    each table's spec_k 1 geometries, q float32 and bf16."""
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import (
        decode_split_plan, paged_decode_int8_kernel, paged_decode_int8_plain,
        paged_decode_kernel, paged_decode_plain, paged_decode_spec_kernel,
        paged_decode_spec_plain,
    )

    S = 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, earlier, tables = {}, {}, {}
    runs = []  # (d, ps, P, hq, hk, spec_k, lengths, plan)
    for d, ps, P, hq, cases in (
        (128, 16, 256, 32, ((8, 1), (4, 1), (8, 2), (8, 4), (4, 4))),
        (64, 24, 171, 16, ((2, 1), (4, 4), (2, 2), (2, 4))),
    ):
        splits, L = decode_split_plan(P, ps, cases[0][0], sms)
        lengths = [0, L - 1, L, L + 1, L + 2, 2 * L, 2 * L + 1, P * ps]
        tables[f"d{d}_ps{ps}"] = dict(lengths=lengths, splits=splits, split_len=L)
        runs += [(d, ps, P, hq, hk, spec_k, lengths, (splits, L)) for hk, spec_k in cases]
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        for d, ps, P, hq, hk, spec_k, lengths, (splits, L) in runs:
            scale = d ** -0.5
            cache = decode_pages(dt, hk, seed=7, lengths=lengths, d=d, ps=ps, P=P)
            if split_of(cache) != {"splits": splits, "split_len": L}:
                raise AssertionError(f"decode_split: hk {hk} plans {split_of(cache)}")
            gen = torch.Generator(device="cuda").manual_seed(8)
            q = torch.randn((S, spec_k, hq, d), generator=gen, device="cuda").to(dt)
            name = f"d{d}_ps{ps}_spec{spec_k}_hk{hk}_{dname}"
            if spec_k == 1:
                got = paged_decode_kernel(q[:, 0], cache, scale)
                again = paged_decode_kernel(q[:, 0], cache, scale)
                want = paged_decode_plain(q[:, 0], cache, scale)
                got, again, want = [(o[:, None], l[:, None]) for o, l in (got, again, want)]
            else:
                got = paged_decode_spec_kernel(q, cache, scale)
                again = paged_decode_spec_kernel(q, cache, scale)
                want = paged_decode_spec_plain(q, cache, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"decode_split {name}: two launches differ")
            err = errors(*got, *want)
            check(f"decode_split {name}", err, dname)
            limits = spec_limits(lengths, spec_k)
            check_empty_rows(f"decode_split {name}", *got, limits)
            if spec_k == 4:  # B11 at spec_k 1 is B10, bit for bit
                one = paged_decode_spec_kernel(q[:, :1], cache, scale)
                ref = paged_decode_kernel(q[:, 0], cache, scale)
                if not (torch.equal(one[0][:, 0], ref[0]) and torch.equal(one[1][:, 0], ref[1])):
                    raise AssertionError(f"decode_split {name}: spec_k 1 is not B10's bits")
            earlier[name] = sum(  # live rows whose last column is in an earlier split
                1 for n, lim in zip(lengths, limits) for m in lim
                if 0 < m and (m - 1) // L < (n - 1) // L
            )
            worst[name] = err["max_abs_err"]
            del cache
        for d, ps, P, hq, hk, spec_k, lengths, (splits, L) in runs:
            if spec_k != 1:
                continue
            scale = d ** -0.5
            cache = int8_pages(hk, seed=11, lengths=lengths, d=d, ps=ps, P=P)
            if split_of(cache) != {"splits": splits, "split_len": L}:
                raise AssertionError(f"decode_split int8: hk {hk} plans {split_of(cache)}")
            gen = torch.Generator(device="cuda").manual_seed(12)
            q = torch.randn((S, hq, d), generator=gen, device="cuda").to(dt)
            name = f"int8_d{d}_ps{ps}_hk{hk}_q{dname}"
            got = paged_decode_int8_kernel(q, cache, scale)
            again = paged_decode_int8_kernel(q, cache, scale)
            want = paged_decode_int8_plain(q, cache, scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"decode_split {name}: two launches differ")
            err = errors(*got, *want)
            check(f"decode_split {name}", err, dname)
            check_empty_rows(f"decode_split {name}", got[0][:, None], got[1][:, None],
                             spec_limits(lengths, 1))
            worst[name] = err["max_abs_err"]
            del cache
    if not all(earlier[k] for k in earlier if "spec4" in k):
        raise AssertionError(f"decode_split: a spec_k 4 case has no row in an earlier split: {earlier}")
    res = dict(
        tables=tables, max_abs_err=worst, rows_in_earlier_split=earlier,
        bitwise_repeat=True,
    )
    emit({"phase": "decode_split_edges", **res})
    return res


def decode_long_phase(peaks: dict, dec: list[dict], spec: dict[str, dict],
                      int8: dict[str, dict]) -> dict[str, dict]:
    """One live slot of 4096 tokens and seven empty ones, the case only the
    split moves (a walk of one CTA per (kv head, slot) gave it hk CTAs):
    B10 in float32 and bf16, B11 at spec_k 4, hk 8 in float32 and B12 (q
    float32 over int8 pages), checked against the plain versions and timed
    beside the 8-slot case."""
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_int8_kernel, paged_decode_int8_plain, paged_decode_kernel,
        paged_decode_plain, paged_decode_spec_kernel, paged_decode_spec_plain,
    )

    S, hq, hk, d, ps = 8, 32, 8, 128, 16
    scale = d ** -0.5
    lengths = [4096] + [0] * 7
    results = {}
    for spec_k, dt, eight in (
        (1, torch.float32, dec[0]), (1, torch.bfloat16, dec[1]),
        (4, torch.float32, spec["spec4_hk8_float32"]), (1, "int8", int8["float32"]),
    ):
        quant = dt == "int8"
        if quant:
            dt, cache = torch.float32, int8_pages(hk, seed=9, lengths=lengths)
        else:
            cache = decode_pages(dt, hk, seed=9, lengths=lengths)
        dname = str(dt).removeprefix("torch.")
        gen = torch.Generator(device="cuda").manual_seed(10)
        if quant:
            q = torch.randn((S, hq, d), generator=gen, device="cuda")
            kfn, pfn, what = paged_decode_int8_kernel, paged_decode_int8_plain, "paged_decode_int8"
        elif spec_k == 1:
            q = torch.randn((S, hq, d), generator=gen, device="cuda").to(dt)
            kfn, pfn, what = paged_decode_kernel, paged_decode_plain, "paged_decode"
        else:
            q = torch.randn((S, spec_k, hq, d), generator=gen, device="cuda").to(dt)
            kfn, pfn, what = paged_decode_spec_kernel, paged_decode_spec_plain, "paged_decode_spec"
        out_k, lse_k = kfn(q, cache, scale)
        err = errors(out_k, lse_k, *pfn(q, cache, scale))
        name = f"{what}_long_slot_spec{spec_k}_{dname}"
        check(name, err, dname)
        nbytes = (int8_bytes if quant else decode_bytes)(q, lse_k, lengths, hk, ps)
        pairs = sum(sum(lim) for lim in spec_limits(lengths, spec_k)) * hq
        b_ms, b_by = bound(4.0 * d * pairs, nbytes, dname, peaks)
        ms = time_ms(lambda: kfn(q, cache, scale))
        device_ms = graph_ms(lambda: kfn(q, cache, scale))
        res = dict(
            case=name, dtype=dname, spec_k=spec_k, lengths=lengths,
            **split_of(cache), **err, ms=ms, device_ms=device_ms,
            bound_ms=b_ms, bound_by=b_by, gb_s=nbytes / (ms * 1e-3) / 1e9,
            device_gb_s=nbytes / (device_ms * 1e-3) / 1e9,
            **{f"eight_slot_{k}": eight[k] for k in (
                "case", "ms", "device_ms", "bound_ms", "gb_s", "device_gb_s")},
        )
        results[name] = res
        emit({"phase": "decode_long_slot", **res})
        del cache
    return results


def decode_sass_phase() -> dict[str, dict]:
    """Proof of the decode design in the SASS: every instance of the split
    walk (``decode_kernel<...>``) in paged_decode, paged_decode_spec and
    paged_decode_int8 shows LDGSTS (cp.async) and no spill in its ``ptxas``
    report; merge_kernel is reported as it is."""
    results = {}
    for lib in ("paged_decode", "paged_decode_spec", "paged_decode_int8"):
        sass, ptxas = sass_counts(lib), ptxas_report(lib)
        rows = {fn: dict(**n, **ptxas.get(fn, {})) for fn, n in sass.items()}
        emit({"phase": "decode_sass", "library": lib, "kernels": rows})
        walks = {fn: r for fn, r in rows.items() if fn.startswith("decode_kernel<")}
        if not walks:
            raise AssertionError(f"{lib}: no instance of the split walk: {rows}")
        for fn, r in walks.items():
            if r["LDGSTS"] == 0 or r.get("spill_stores", 1) or r.get("spill_loads", 1):
                raise AssertionError(f"{lib}: {fn} has no LDGSTS or spills: {r}")
        results[lib] = rows
    return results


def edge_phase() -> None:
    """Kernel paths the main shapes do not reach, checked (not timed):
    head_dim 64, a ragged last q and k tile, softcap, g = 1 and g = 8, a k
    tile no slice reaches and uncovered rows (forward and gradients, the
    GQA-packed kernels bit-identical to the unpacked ones there), a page
    size below and above the 64-token chunk."""
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
        with scoped_env(PACK):  # the packed forward (g > 1): bit-identical
            packed = ffa_attn(q, k, v, qr, kr, attn_type_map=types, softcap=softcap)
        if not all(torch.equal(a, b) for a, b in zip(packed, got)):
            raise AssertionError(f"ffa_d{d}_g{hq // hk}: packed forward not bit-identical")
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
        (64, 8, 1, torch.bfloat16, 30.0),
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
        # the GQA-packed forward and dq (split pin): bit-identical gradients
        with scoped_env({**PACK, **SPLIT}):
            packed = grads_of(ffa_attn)
        with scoped_env(SPLIT):
            unpacked = grads_of(ffa_attn)
        if not all(torch.equal(a, b) for a, b in zip(packed, unpacked)):
            raise AssertionError(f"grad_packed_d{d}_g{hq // hk}: not bit-identical to unpacked")
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
    # ROADMAP C7: paged_attn with a softcap and with the causal band off (the
    # JAX package's arguments), float32, against the plain version over the
    # gathered rows
    from magiattention_tpu_torch.kernels.mask_utils import BAND_INF
    from magiattention_tpu_torch.kernels.paged_kv import gather_kv, paged_attn

    d, hq, hk, ps, N, P, t, q_start = 128, 8, 2, 16, 64, 16, 40, 160
    cache = PagedKVCache.create(N, ps, hk, d, 2, P, dtype=torch.float32, device="cuda")
    cache.k_pages.copy_(torch.randn(cache.k_pages.shape, generator=gen, device="cuda"))
    cache.v_pages.copy_(torch.randn(cache.v_pages.shape, generator=gen, device="cuda"))
    assign_pages(cache, 0, np.random.default_rng(7).permutation(N)[: -(-(q_start + t) // ps)])
    q = torch.randn((t, hq, d), generator=gen, device="cuda")
    k_rows, v_rows = gather_kv(cache, 0, P)
    for causal in (True, False):
        got = paged_attn(q, cache, 0, q_start, P, softcap=30.0, causal=causal)
        want = sdpa_attn(
            q, k_rows, v_rows, np.array([[0, t]]), np.array([[0, q_start + t]]), softcap=30.0,
            d_lo=np.array([-BAND_INF]), d_hi=np.array([q_start if causal else BAND_INF]),
        )
        name = f"paged_attn_cap30_causal{int(causal)}_float32"
        err = errors(*got, *want)
        check(name, err, "float32")
        worst[name] = err["max_abs_err"]
    packed = head_dim_cases(gen, worst)
    emit({"phase": "edge_cases", "max_abs_err": worst, "head_dim_packed_fwd_launches": packed})


# (d, dv) of ROADMAP C4's and C4b's cases: padded to the kernels' 64, 128
# or 256 columns (d 256: Gemma-2/3; d 192 with dv 128: DeepSeek-V3's MLA)
C4_DIMS = ((32, 32), (96, 96), (64, 128), (256, 256), (192, 128), (256, 128))


def head_dim_cases(gen, worst: dict) -> dict[str, int]:
    """ROADMAP C4 and C4b: head dims other than 64 and 128 run padded with
    zero columns to 64, 128 or 256 (``kernels/head_dims.py``; the 256
    instances split the columns they write in two halves), within the
    float32 / bf16 tolerances of the plain versions on the unpadded
    tensors: d 32, d 96, d 64 with dv 128, d 256, d 192 with dv 128 and
    d 256 with dv 128, float32 and bf16, through FFA forward (and the
    packed forward where its guard admits the width: bit-identical to the
    unpacked one) and backward (fused and split pinned), B10, B11 (spec_k
    2) and B12 over a cache of that width, and B13/B14 through
    ``block_sparse_attn``. A d of 320 raises ``ValueError`` naming the 256
    limit (ROADMAP C4c) in each family."""
    import torch

    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels.block_sparse import (
        BSPParams, block_sparse_attn, block_sparse_bwd_plain, block_sparse_fwd_plain,
        chunk_table,
    )
    from magiattention_tpu_torch.kernels.ffa import ffa_attn, ffa_fwd_gqa_kernel
    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_int8_kernel, paged_decode_int8_plain, paged_decode_kernel,
        paged_decode_plain, paged_decode_spec_kernel, paged_decode_spec_plain,
    )
    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, assign_pages
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    qr = np.array([[0, 40], [40, 150], [150, 200]])
    kr = np.array([[0, 50], [30, 170], [100, 203]])
    types = np.array([1, 0, 3])
    hq, hk = 8, 2
    packed_launches = {}  # the packed forward's launches per case
    for (d, dv), dt in itertools.product(C4_DIMS, (torch.float32, torch.bfloat16)):
        dname = str(dt).removeprefix("torch.")
        tag = f"c4_d{d}_dv{dv}_{dname}"
        # FFA: forward, then gradients under both backward pins
        inputs = [
            torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((230, hq, d), (203, hk, d), (203, hk, dv))
        ]
        do = (torch.randn((230, hq, dv), generator=gen, device="cuda") / 4).to(dt)
        got = ffa_attn(*inputs, qr, kr, attn_type_map=types)
        if got[0].shape[-1] != dv:
            raise AssertionError(f"{tag}: out is {tuple(got[0].shape)}")
        err = errors(*got, *sdpa_attn(*inputs, qr, kr, attn_type_map=types))
        check(f"{tag} ffa fwd", err, dname)
        worst[f"{tag}_ffa_fwd"] = err["max_abs_err"]
        launched = ffa_fwd_gqa_kernel.launches
        with scoped_env(PACK):  # the packed forward where the guard admits it
            packed = ffa_attn(*inputs, qr, kr, attn_type_map=types)
        if not all(torch.equal(a, b) for a, b in zip(packed, got)):
            raise AssertionError(f"{tag}: packed forward not bit-identical")
        packed_launches[tag] = ffa_fwd_gqa_kernel.launches - launched

        def grads_of(attn):
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out, _ = attn(*leaves, qr, kr, attn_type_map=types)
            return torch.autograd.grad(out, leaves, do)

        want = grads_of(sdpa_attn)
        for pin in ("split", "fused"):
            with scoped_env({"MAGI_ATTENTION_BACKEND_FFA_BWD": pin}):
                got = grads_of(ffa_attn)
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                if a.shape != b.shape:
                    raise AssertionError(f"{tag} {pin} {gname}: {tuple(a.shape)}")
                e = grad_check(f"{tag} ffa {pin} {gname}", a.float(), b.float(), dname)
                worst[f"{tag}_ffa_{pin}_{gname}"] = e["max_abs_err"]

        # B10, B11, B12 over caches of these logical widths
        lengths, N, ps, P = [300, 0, 1, 129], 64, 16, 40
        perm, used = np.random.default_rng(d + dv).permutation(N), 0
        caches = {}
        for page_dt in (dt, torch.int8):
            cache = PagedKVCache.create(N, ps, hk, d, 4, P, dtype=page_dt, device="cuda",
                                        head_dim_v=dv)
            if page_dt == torch.int8:
                cache.k_pages[..., :d].copy_(torch.randint(
                    -127, 128, cache.k_pages[..., :d].shape, generator=gen, device="cuda"))
                cache.v_pages[..., :dv].copy_(torch.randint(
                    -127, 128, cache.v_pages[..., :dv].shape, generator=gen, device="cuda"))
                for sc in (cache.k_scales, cache.v_scales):
                    sc.copy_(0.005 + 0.015 * torch.rand(sc.shape, generator=gen, device="cuda"))
            else:
                cache.k_pages[..., :d].copy_(torch.randn(
                    cache.k_pages[..., :d].shape, generator=gen, device="cuda"))
                cache.v_pages[..., :dv].copy_(torch.randn(
                    cache.v_pages[..., :dv].shape, generator=gen, device="cuda"))
            for s_, length in enumerate(lengths):
                n = -(-length // ps)
                assign_pages(cache, s_, perm[used: used + n])
                used += n
            used = 0
            cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
            caches[page_dt] = cache
        q1 = torch.randn((4, hq, d), generator=gen, device="cuda").to(dt)
        q2 = torch.randn((4, 2, hq, d), generator=gen, device="cuda").to(dt)
        scale = d ** -0.5
        for what, kern, plain, q_, cache in (
            ("paged_decode", paged_decode_kernel, paged_decode_plain, q1, caches[dt]),
            ("paged_decode_spec", paged_decode_spec_kernel, paged_decode_spec_plain, q2,
             caches[dt]),
            ("paged_decode_int8", paged_decode_int8_kernel, paged_decode_int8_plain, q1,
             caches[torch.int8]),
        ):
            got = kern(q_, cache, scale)
            if got[0].shape[-1] != dv:
                raise AssertionError(f"{tag} {what}: out is {tuple(got[0].shape)}")
            err = errors(*got, *plain(q_, cache, scale))
            check(f"{tag} {what}", err, dname)
            worst[f"{tag}_{what}"] = err["max_abs_err"]

        # B13/B14 through block_sparse_attn (its autograd pads once)
        seq = 512
        idx, starts = bsp_table(gen, seq, hk, 4, 16)
        bsp_in = [
            torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((seq, hq, d), (seq, hk, d), (seq, hk, dv))
        ]
        bsp_do = (torch.randn((seq, hq, dv), generator=gen, device="cuda") / 4).to(dt)
        leaves = [t.detach().requires_grad_(True) for t in bsp_in]
        out, lse = block_sparse_attn(*leaves, idx, starts, block_len=BSP_L_SLC,
                                     d_stride=16, block_size_q=BSP_BQ)
        got = torch.autograd.grad(out, leaves, bsp_do)
        ctbl = chunk_table(idx, starts, 16, BSP_L_SLC)
        params = BSPParams(softmax_scale=d ** -0.5, d_stride=16, block_size_q=BSP_BQ)
        out_p, lse_p = block_sparse_fwd_plain(*bsp_in, ctbl, params)
        err = errors(out.detach(), lse, out_p, lse_p)
        check(f"{tag} block_sparse fwd", err, dname)
        worst[f"{tag}_block_sparse_fwd"] = err["max_abs_err"]
        delta = (out_p.float() * bsp_do.float()).sum(-1)
        want = block_sparse_bwd_plain(*bsp_in, bsp_do, lse_p, delta, ctbl, params)
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            if a.shape != b.shape:
                raise AssertionError(f"{tag} block_sparse {gname}: {tuple(a.shape)}")
            e = grad_check(f"{tag} block_sparse {gname}", a.float(), b, dname)
            worst[f"{tag}_block_sparse_{gname}"] = e["max_abs_err"]

    # above 256: every family raises, naming the limit and ROADMAP C4c
    q = torch.zeros((64, hq, 320), device="cuda")
    kv = torch.zeros((64, hk, 320), device="cuda")
    idx = torch.zeros((hk, 64 // BSP_BQ, 1), dtype=torch.int64, device="cuda")
    for what, call in (
        ("ffa_attn", lambda: ffa_attn(q, kv, kv, [[0, 64]], [[0, 64]])),
        ("PagedKVCache", lambda: PagedKVCache.create(8, 16, hk, 320, 2, 4, device="cuda")),
        ("block_sparse_attn", lambda: block_sparse_attn(
            q, kv, kv, idx, np.array([0]), block_len=BSP_L_SLC, block_size_q=BSP_BQ)),
    ):
        try:
            call()
        except ValueError as e:
            if "256" not in str(e) or "C4c" not in str(e):
                raise AssertionError(f"{what} at d 320: {e}") from e
        else:
            raise AssertionError(f"{what} at d 320 did not raise")
    torch.cuda.empty_cache()
    return packed_launches


# (prompt_len, new_tokens): short requests first (held against the CPU
# engine), then lengths spread over 1..3968 incl. the page and chunk
# boundaries 16, 512, 513
SERVE_REQUESTS = [
    (1, 8), (16, 32), (512, 16), (513, 24), (3968, 8), (100, 12),
    (1000, 20), (2047, 28), (2048, 10), (3000, 14), (250, 18), (777, 22),
    (1500, 26), (3500, 30), (64, 9), (2600, 11),
]


def rows_err(what: str, reqs, want: dict, atol: float = SERVE_ATOL,
             rnorm: float = SERVE_RNORM) -> tuple[float, float]:
    """Worst max-abs and rel-norm error of every request's generated rows
    against ``want[req_id]``; raises beyond (atol, rnorm) or on a row that
    is not finite or a request that is short of rows."""
    worst_abs = worst_rn = 0.0
    for r in reqs:
        if len(r.generated) != len(want[r.req_id]):
            raise AssertionError(f"{what}: request {r.req_id} row count differs")
        a = np.stack(r.generated).astype(np.float64)
        b = np.stack(want[r.req_id]).astype(np.float64)
        if not np.isfinite(a).all():
            raise AssertionError(f"{what}: non-finite generated rows")
        worst_abs = max(worst_abs, float(np.abs(a - b).max()))
        worst_rn = max(worst_rn, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    if worst_abs > atol or worst_rn > rnorm:
        raise AssertionError(
            f"{what}: max abs {worst_abs:.3e}, rel-norm {worst_rn:.3e} "
            f"beyond {atol}, {rnorm}"
        )
    return worst_abs, worst_rn


def serve_model(device):
    """The serve phases' model (``ToyModel`` at Llama-3.1-8B attention
    widths, seed 0) on ``device`` and their engine config."""
    from magiattention_tpu_torch.serving import ServeConfig, ToyModel

    model = ToyModel.create(
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, seed=0, device=device,
    )
    config = ServeConfig(
        page_size=16, num_pages=2048, max_slots=8, max_pages_per_seq=256,
        prefill_chunk=512,
    )
    return model, config


def serve_requests(model) -> list:
    """``SERVE_REQUESTS`` as requests of ``model``'s prompts."""
    from magiattention_tpu_torch.serving import ServeRequest

    return [
        ServeRequest(i, model.prompt(length, seed=1000 + i), new)
        for i, (length, new) in enumerate(SERVE_REQUESTS)
    ]


def serve_phase() -> tuple[dict, dict]:
    import torch

    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts
    from magiattention_tpu_torch.serving import (
        ServeConfig, ServeEngine, ToyModel, run_reference,
    )

    t0 = time.perf_counter()
    model, config = serve_model("cuda")
    requests = serve_requests
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

    reference = run_reference(model, reqs, config)
    worst_abs, worst_rn = rows_err("serve: engine vs replay oracle", reqs, reference)

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
    cpu_abs, cpu_rn = rows_err(
        "serve: card vs CPU engine", reqs[:2],
        {r.req_id: r.generated for r in cpu_reqs},
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
    ctx = dict(
        model=model, config=config, requests=requests, reference=reference,
        rows={r.req_id: r.generated for r in reqs}, cpu_model=cpu_model,
        cpu_config=cpu_config, cpu_rows={r.req_id: r.generated for r in cpu_reqs},
    )
    return res, ctx


def profile_run(fn) -> dict:
    """``fn()`` under ``torch.profiler``: device time by kernel, device
    busy time against the wall (the profiler's own cost inflates the wall,
    so the idle share is an upper bound), and the paged-decode kernels'
    device time and launches (``magi::decode::``: the walk and the merge).

    The trace is held against the port's launch counters: late in a full
    run the profiler drops a short call's first kernel records (forwards
    the counters saw, missing from the trace; PERF.md §6), so ``complete``
    says whether the trace holds every forward launch of the call
    (``forward_launches_counted``); a busy time is read only from a
    complete trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from magiattention_tpu_torch.kernels import launch_counts

    before = launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = launch_counts()
    counted = sum(after[k] - before[k] for k in ("ffa_fwd", "ffa_fwd_gqa"))
    res = _profile_summary(prof.key_averages(), wall)
    return dict(res, forward_launches_counted=counted, complete=res["forward_launches"] == counted)


def _profile_summary(events, wall: float) -> dict:
    kernels = []
    for e in events:
        # "nccl:<op>" is the host annotation of an NCCL kernel that the
        # trace lists again under the kernel's own name
        if "CUDA" not in str(getattr(e, "device_type", "")) or e.key.startswith("nccl:"):
            continue
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((e.key, us, e.count))
    kernels.sort(key=lambda r: -r[1])
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    decode = [(us, c) for k, us, c in kernels if "magi::decode::" in k]
    forward = [(us, c) for k, us, c in kernels if "ffa_fwd_t" in k]  # B1/B2's bodies
    return dict(
        wall_s=wall, device_busy_s=busy_s,
        idle_share=1.0 - busy_s / wall if wall > 0 else None,
        device_ms_by_family=device_ms_by_family(events, busy_s * 1e3),
        decode_device_ms=sum(us for us, _ in decode) / 1e3,
        decode_launches=sum(c for _, c in decode),
        forward_device_ms=sum(us for us, _ in forward) / 1e3,
        forward_launches=sum(c for _, c in forward),
        # NCCL's kernels (on their own stream, beside the compute; a rank
        # waiting for its peers counts here too)
        collective_device_ms=sum(us for k, us, _ in kernels if k.startswith("nccl")) / 1e3,
        top_kernels=[
            {"name": k[:90], "device_ms": us / 1e3, "count": c}
            for k, us, c in kernels[:12]
        ],
    )


# the host ops whose own kernels make up a family of ``device_ms_by_family``
BMM_OPS = ("aten::bmm",)
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::linear")
INDEX_OPS = (
    "aten::sort", "aten::topk", "aten::cumsum", "aten::one_hot", "aten::scatter",
    "aten::scatter_", "aten::gather", "aten::index", "aten::index_select", "aten::index_add_",
    "aten::index_put_", "aten::_index_put_impl_", "aten::scatter_add_", "aten::embedding",
)


def device_ms_by_family(events, busy_ms: float) -> dict:
    """Device ms of a profile by kernel family: the port's FFA kernels (by
    kernel name), the kernels that ``aten::bmm`` launched itself (the MoE's
    expert products, forward and backward), the other matrix products
    (``aten::mm``/``addmm``), the routing and index ops (sort, cumsum,
    one_hot, scatter, gather, index and their backward) and the rest
    (elementwise, norms, softmax, the loss, collectives). A host op's own
    (self) device time holds the kernels it launched and not its children's."""
    fam = dict(ffa=0.0, expert_gemm=0.0, other_gemm=0.0, routing_index=0.0)
    for e in events:
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if not us:
            continue
        if "CUDA" in str(getattr(e, "device_type", "")):
            if "ffa_" in e.key or "scale_kernel" in e.key:  # scale_kernel: B8/B9's dq epilogue
                fam["ffa"] += us / 1e3
        elif e.key in BMM_OPS:
            fam["expert_gemm"] += us / 1e3
        elif e.key in GEMM_OPS:
            fam["other_gemm"] += us / 1e3
        elif e.key in INDEX_OPS:
            fam["routing_index"] += us / 1e3
    fam["rest"] = busy_ms - sum(fam.values())
    return fam


def serve_profile(model, config, make_requests) -> dict:
    """A serve run of ``config`` once more under ``torch.profiler``: the
    device time by kernel, the decode kernels' and the FFA forward's
    (``forward_device_ms``)."""
    from magiattention_tpu_torch.serving import ServeEngine

    reqs = make_requests(model)
    engine = ServeEngine(model, config)
    res = profile_run(lambda: engine.run(reqs))
    return dict(res, ticks=engine.step_count)


def serve_run(engine, reqs) -> tuple[list[dict], float, dict]:
    """Drain ``reqs`` through ``engine`` with the launch counters zeroed
    just before: every tick's stats, the wall seconds and the counts."""
    import torch

    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts

    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = []
    while engine.scheduler.has_work():
        stats.append(engine.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if len(engine.finished) != len(reqs) or any(
        len(r.generated) != r.max_new_tokens for r in reqs
    ):
        raise AssertionError(f"{len(engine.finished)}/{len(reqs)} requests completed")
    return stats, wall, counts


def check_launches(what: str, counts: dict, kernels: tuple[str, ...]) -> None:
    from magiattention_tpu_torch.kernels import PLAIN_NAMES

    if any(counts[k] == 0 for k in kernels):
        raise AssertionError(f"{what}: a kernel of the path was never launched: {counts}")
    if any(counts[k] for k in PLAIN_NAMES):
        raise AssertionError(f"{what}: a plain version ran on the card: {counts}")


def serve_spec_phase(ctx: dict) -> dict:
    """The serve phase's model, config and requests with spec_tokens = 4
    and the greedy self-draft: every committed row within SERVE_ATOL /
    SERVE_RNORM of the replay oracle, real rollbacks, B11 launched and no
    plain version; then the accept rate of the oracle draft (reported)."""
    from magiattention_tpu_torch.serving import ServeEngine, oracle_draft_fn

    model, reqs = ctx["model"], ctx["requests"](ctx["model"])
    config = dataclasses.replace(ctx["config"], spec_tokens=4)
    stats, wall, counts = serve_run(ServeEngine(model, config), reqs)
    check_launches("serve_spec", counts, ("ffa_fwd", "paged_decode_spec"))
    worst_abs, worst_rn = rows_err("serve_spec: engine vs replay oracle", reqs, ctx["reference"])
    attempted = sum(s["draft_attempted"] for s in stats)
    accepted = sum(s["draft_accepted"] for s in stats)
    if not accepted < attempted:
        raise AssertionError("serve_spec: every draft accepted, rollback not exercised")
    oracle_reqs = ctx["requests"](model)
    o_stats, o_wall, _ = serve_run(
        ServeEngine(model, config, draft_fn=oracle_draft_fn(ctx["reference"])), oracle_reqs,
    )
    rows_err("serve_spec: oracle-draft engine vs replay oracle", oracle_reqs, ctx["reference"])
    o_att = sum(s["draft_attempted"] for s in o_stats)
    o_acc = sum(s["draft_accepted"] for s in o_stats)
    prompt_tokens = sum(r.prompt_len for r in reqs)
    gen_tokens = sum(len(r.generated) for r in reqs)
    res = dict(
        spec_tokens=4, requests=len(reqs), ticks=len(stats), wall_s=wall,
        generated_tokens=gen_tokens, generated_tokens_per_s=gen_tokens / wall,
        total_tokens_per_s=(prompt_tokens + gen_tokens) / wall,
        draft_attempted=attempted, draft_accepted=accepted,
        accept_rate=accepted / attempted,
        kernel_launches={k: counts[k] for k in ("ffa_fwd", "paged_decode_spec")},
        oracle_max_abs_err=worst_abs, oracle_rel_norm_err=worst_rn,
        oracle_draft=dict(
            ticks=len(o_stats), wall_s=o_wall, draft_attempted=o_att,
            draft_accepted=o_acc, accept_rate=o_acc / o_att,
        ),
        atol=SERVE_ATOL, rnorm=SERVE_RNORM,
    )
    emit({"phase": "serve_spec", **res})
    emit({"phase": "serve_spec_profile", **serve_profile(model, config, ctx["requests"])})
    return res


# int8 rows against float32 rows: the quantization error, bounded from a
# CPU run of the port at these widths (the first two requests: max abs
# 0.0201, rel-norm 0.0103), with room for longer prompts
INT8_VS_F32_ATOL, INT8_VS_F32_RNORM = 0.1, 0.05


def serve_int8_phase(ctx: dict) -> dict:
    """The serve phase's model, config and requests on an int8 cache: every
    row within SERVE_ATOL / SERVE_RNORM of the int8 replay oracle fed the
    engine's rows, and within the int8 bound of the free-running replay and
    of the float32 serve rows (nonzero); B12 launched and no plain version;
    the first two requests int8 against float32 on the CPU (the source of
    the bound); the page accounting of float32 against int8."""
    import torch

    from magiattention_tpu_torch.serving import (
        ServeEngine, generate_reference, kv_page_bytes, run_reference, slot_residency,
    )

    model, reqs = ctx["model"], ctx["requests"](ctx["model"])
    config = dataclasses.replace(ctx["config"], kv_dtype="int8")
    stats, wall, counts = serve_run(ServeEngine(model, config), reqs)
    check_launches("serve_int8", counts, ("ffa_fwd", "paged_decode_int8"))
    # the replay fed the engine's own rows: the same codes, so only B12
    # against B1 differs (float32 tolerance); free-running, a last-bit
    # difference can move a later code by one (the int8 bound)
    forced = {
        r.req_id: generate_reference(model, r, config, forced=r.generated) for r in reqs
    }
    worst_abs, worst_rn = rows_err("serve_int8: engine vs int8 replay oracle", reqs, forced)
    int8_reference = run_reference(model, reqs, config)
    free_abs, free_rn = rows_err(
        "serve_int8: engine vs free-running int8 replay", reqs, int8_reference,
        atol=INT8_VS_F32_ATOL, rnorm=INT8_VS_F32_RNORM,
    )
    f32_abs, f32_rn = rows_err(
        "serve_int8: int8 vs float32 serve rows", reqs, ctx["rows"],
        atol=INT8_VS_F32_ATOL, rnorm=INT8_VS_F32_RNORM,
    )
    if f32_abs == 0.0:
        raise AssertionError("serve_int8: rows equal the float32 rows: not quantizing?")
    cpu_model = ctx["cpu_model"]
    cpu_reqs = ctx["requests"](cpu_model)[:2]
    ServeEngine(cpu_model, dataclasses.replace(ctx["cpu_config"], kv_dtype="int8")).run(cpu_reqs)
    cpu_f32 = rows_err(
        "serve_int8: CPU int8 vs CPU float32 rows", cpu_reqs, ctx["cpu_rows"],
        atol=INT8_VS_F32_ATOL, rnorm=INT8_VS_F32_RNORM,
    )
    geometry = dict(page_size=config.page_size, n_kv_heads=model.n_kv_heads,
                    head_dim=model.head_dim)
    budget = torch.cuda.get_device_properties(0).total_memory
    accounting = {
        dt: dict(
            page_bytes=kv_page_bytes(kv_dtype=dt, **geometry),
            slots_in_device_memory=slot_residency(
                budget, kv_page_bytes(kv_dtype=dt, **geometry), config.max_pages_per_seq,
            ),
        )
        for dt in ("float32", "int8")
    }
    prompt_tokens = sum(r.prompt_len for r in reqs)
    gen_tokens = sum(len(r.generated) for r in reqs)
    res = dict(
        kv_dtype="int8", requests=len(reqs), ticks=len(stats), wall_s=wall,
        generated_tokens=gen_tokens, generated_tokens_per_s=gen_tokens / wall,
        total_tokens_per_s=(prompt_tokens + gen_tokens) / wall,
        kernel_launches={k: counts[k] for k in ("ffa_fwd", "paged_decode_int8")},
        oracle_max_abs_err=worst_abs, oracle_rel_norm_err=worst_rn,
        free_oracle_max_abs_err=free_abs, free_oracle_rel_norm_err=free_rn,
        vs_f32_max_abs_err=f32_abs, vs_f32_rel_norm_err=f32_rn,
        cpu_int8_vs_f32=dict(max_abs_err=cpu_f32[0], rel_norm_err=cpu_f32[1]),
        vs_f32_atol=INT8_VS_F32_ATOL, vs_f32_rnorm=INT8_VS_F32_RNORM,
        atol=SERVE_ATOL, rnorm=SERVE_RNORM,
        device_memory_bytes=budget, pages_per_slot=config.max_pages_per_seq,
        accounting=accounting,
    )
    res["spec"] = serve_int8_spec(ctx, config, int8_reference)
    emit({"phase": "serve_int8", **res})
    emit({"phase": "serve_int8_profile", **serve_profile(model, config, ctx["requests"])})
    return res


def serve_int8_spec(ctx: dict, config, int8_reference: dict) -> dict:
    """``serve_int8`` at spec_tokens = 4: verify on int8 pages through the
    dequantized gather + FFA (B1; the spec kernel is infeasible there, as
    in the JAX package); B1 launched, no plain version; real rollbacks;
    every committed row within the int8 bound of the int8 replay fed the
    engine's rows and of the free-running one (a rejected row's raised
    scale stays in the page it shares with committed rows, as in the JAX
    package, so the codes differ by re-quantization)."""
    from magiattention_tpu_torch.serving import ServeEngine, generate_reference

    model, reqs = ctx["model"], ctx["requests"](ctx["model"])
    spec_config = dataclasses.replace(config, spec_tokens=4)
    stats, wall, counts = serve_run(ServeEngine(model, spec_config), reqs)
    check_launches("serve_int8 spec", counts, ("ffa_fwd",))
    if counts["paged_decode_spec"] or counts["paged_decode_int8"]:
        raise AssertionError(f"serve_int8 spec: a decode kernel ran on int8 verify: {counts}")
    attempted = sum(s["draft_attempted"] for s in stats)
    accepted = sum(s["draft_accepted"] for s in stats)
    if not accepted < attempted:
        raise AssertionError("serve_int8 spec: every draft accepted, rollback not exercised")
    forced = {
        r.req_id: generate_reference(model, r, config, forced=r.generated) for r in reqs
    }
    forced_err = rows_err("serve_int8 spec: engine vs int8 replay fed its rows", reqs, forced,
                          atol=INT8_VS_F32_ATOL, rnorm=INT8_VS_F32_RNORM)
    free_err = rows_err("serve_int8 spec: engine vs free-running int8 replay", reqs,
                        int8_reference, atol=INT8_VS_F32_ATOL, rnorm=INT8_VS_F32_RNORM)
    gen_tokens = sum(len(r.generated) for r in reqs)
    return dict(
        spec_tokens=4, ticks=len(stats), wall_s=wall, generated_tokens=gen_tokens,
        generated_tokens_per_s=gen_tokens / wall, draft_attempted=attempted,
        draft_accepted=accepted, accept_rate=accepted / attempted,
        kernel_launches={"ffa_fwd": counts["ffa_fwd"]},
        forced_max_abs_err=forced_err[0], forced_rel_norm_err=forced_err[1],
        free_max_abs_err=free_err[0], free_rel_norm_err=free_err[1],
        atol=INT8_VS_F32_ATOL, rnorm=INT8_VS_F32_RNORM,
    )


SHARD_COUNTS = (2, 4, 8)  # kv-head shards of decode_sharded (hk 8)


def decode_sharded_phase(ctx: dict, peaks: dict) -> dict:
    """The head-sharded decode step (``paged_decode_attn_sharded``: B10
    once per kv-head shard) at the decode phase's shape (8 slots of
    0..4096 tokens, hq 32, hk 8, d 128), float32 and bf16, with 2, 4 and 8
    shards all on this card (``devices=[cuda:0] * n``): out and lse equal
    to the unsharded ``paged_decode_attn``'s to the bit, ms per call (host
    and each shard's page copy included) beside the unsharded call's;
    launches counted on the first call of each. Then ``ServeEngine`` with
    ``decode_shards=2`` on this one card: by the JAX package's feasibility
    rule (at least 2 devices) it decodes on the next feasible rung, B10
    unsharded, its rows within the serve gates of the replay oracle."""
    import torch

    from magiattention_tpu_torch.kernels.paged_decode import (
        paged_decode_attn, paged_decode_attn_sharded, paged_decode_kernel,
    )
    from magiattention_tpu_torch.serving import ServeEngine
    from magiattention_tpu_torch.serving.decode import decode_route

    gen = torch.Generator(device="cuda").manual_seed(27)
    hq, hk, d = 32, 8, 128
    res, launches = {}, 0
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        cache = decode_pages(dt, hk, seed=27)
        q = torch.randn((8, hq, d), generator=gen, device="cuda").to(dt)
        want = paged_decode_attn(q, cache)
        nbytes = decode_bytes(q, want[1], DECODE_LENGTHS, hk, 16)
        b_ms, b_by = bound(4.0 * hq * d * sum(DECODE_LENGTHS), nbytes, dname, peaks)
        by_n = {}
        for n in SHARD_COUNTS:
            call = lambda n=n: paged_decode_attn_sharded(  # noqa: E731
                q, cache, n, devices=[torch.device("cuda", 0)] * n)
            before = paged_decode_kernel.launches
            got = call()
            torch.cuda.synchronize()
            launched = paged_decode_kernel.launches - before
            if launched != n:
                raise AssertionError(f"decode_sharded {dname} n={n}: {launched} launches")
            launches += launched
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"decode_sharded {dname} n={n}: not the unsharded bits")
            by_n[str(n)] = dict(bitwise=True, launches=launched, ms=time_ms(call))
        res[dname] = dict(
            shards=by_n, unsharded_ms=time_ms(lambda: paged_decode_attn(q, cache)),
            bound_ms=b_ms, bound_by=b_by, **split_of(cache),
            page_copy_bytes_per_call=2 * cache.k_pages.numel() * cache.k_pages.element_size(),
        )
        del cache
        torch.cuda.empty_cache()
    model, reqs = ctx["model"], ctx["requests"](ctx["model"])
    config = dataclasses.replace(ctx["config"], decode_shards=2)
    engine = ServeEngine(model, config)
    stats, wall, counts = serve_run(engine, reqs)
    rung = decode_route(engine.cache, multi_row=False, shards=2)
    if rung != "paged_decode" or any(s["shards"] != 2 for s in stats):
        raise AssertionError(f"decode_sharded: one card with decode_shards=2 took {rung}")
    check_launches("decode_sharded engine", counts, ("ffa_fwd", "paged_decode"))
    err = rows_err("decode_sharded: engine vs replay oracle", reqs, ctx["reference"])
    same = all(np.array_equal(np.stack(r.generated), np.stack(ctx["rows"][r.req_id]))
               for r in reqs)
    out = dict(
        shape=f"8 slots {DECODE_LENGTHS}, hq {hq}, hk {hk}, d {d}", kernels=res,
        launches=launches, engine=dict(
            decode_shards=2, cards=torch.cuda.device_count(), rung=rung, wall_s=wall,
            kernel_launches={k: counts[k] for k in ("ffa_fwd", "paged_decode")},
            oracle_max_abs_err=err[0], oracle_rel_norm_err=err[1],
            rows_equal_serve_rows=same,
        ),
    )
    emit({"phase": "decode_sharded", **out})
    return out


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
    the same inputs, with the max-logits output against
    ``dense_max_logits``. Reports the backward mode the port resolved and
    the kernels the path launched (counts reset just before it)."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.functional import flex_flash_attn_func
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode
    from magiattention_tpu_torch.kernels.sdpa import dense_max_logits

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
    mode = ffa_bwd_mode(plan, runtime._params(CP_D)[0], CP_D, CP_D, 2, CP_HQ, CP_HK)

    def api_path(max_logits=None):
        q, k, v = (t.detach().requires_grad_(True) for t in inputs)
        out_d, meta = api.calc_attn(
            api.dispatch(q, key), api.dispatch(k, key, role="kv"),
            api.dispatch(v, key, role="kv"), key, return_max_logits=max_logits is not None,
        )
        out = api.undispatch(out_d, key)
        if max_logits is not None:
            max_logits.append(meta.max_logits)
        return (out, *torch.autograd.grad(out, (q, k, v), do))

    def direct_path():
        q, k, v = (t.detach().requires_grad_(True) for t in inputs)
        out, _ = flex_flash_attn_func(q, k, v, np.array(docs), np.array(docs), np.array([1, 1]))
        return (out, *torch.autograd.grad(out, (q, k, v), do))

    torch.cuda.synchronize()
    reset_launch_counts()
    ml = []
    got = api_path(ml)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = direct_path()
    err = {
        name: grad_check(f"cp_api {name}", a.float(), b.float(), "bfloat16")
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)
    }
    ml_want = dense_max_logits(inputs[0], inputs[1], np.array(docs), np.array(docs), np.array([1, 1]))
    ml_rel = ((ml[0].double() - ml_want.double()).abs() / ml_want.double().abs()).max().item()
    if ml_rel > ML_RTOL:
        raise AssertionError(f"cp_api: max-logits rel err {ml_rel:.3e} > {ML_RTOL}")
    expected = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels(mode))
    if any(counts[k] != 1 for k in expected) or any(counts[k] for k in PLAIN_NAMES):
        raise AssertionError(f"cp_api: launched {counts}, want one of each of {expected}")
    res = dict(
        shape=f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}, two causal documents",
        cp=1, resolved_bwd_mode=mode, plan_s=plan_s, work_items=plan.num_work,
        launches={k: v for k, v in counts.items() if v}, vs_flex_flash_attn=err,
        max_logits_rel_err=ml_rel, max_logits_rtol=ML_RTOL,
        fwd_bwd_ms=time_ms(api_path, samples=5),
        flex_flash_attn_fwd_bwd_ms=time_ms(direct_path, samples=5),
        atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"],
    )
    emit({"phase": "cp_api", **res})
    return res


def _stage_rows(stage, pos_kv, r: int, cp: int):
    """Global rows of rank r's receive buffer for one GroupCast stage."""
    import torch

    return torch.cat([
        pos_kv[s][torch.as_tensor(stage.send_idx[s, r, : stage.send_counts[s, r]],
                                  dtype=torch.int64, device="cuda")]
        for s in range(cp)
    ])


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
            src_rows = _stage_rows(stage, pos_kv, r, cp)
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
                ffa_bwd_mode(p, prm, CP_D, CP_D, 2, CP_HQ, CP_HK)
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


# the qo_comm phase's cp 4 mask: the JAX solver tests' shared prefix
# (tests/test_solver/test_dynamic_attn_solver.py) scaled to 8192 tokens
QO_CP, QO_CHUNK = 4, 512
QO_MASK = (
    [[0, 1024], [1024, 8192], [1024, 8192]],
    [[0, 1024], [0, 1024], [1024, 8192]],
    [1, 0, 1],
)
QO = {"MAGI_ATTENTION_QO_COMM": "1"}


def _qo_api(inputs, do, key):
    """(out, lse, dq, dk, dv) of the API path on one key, natural order."""
    import torch

    from magiattention_tpu_torch import api

    q, k, v = (t.detach().requires_grad_(True) for t in inputs)
    out_d, meta = api.calc_attn(
        api.dispatch(q, key), api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv"), key,
    )
    out = api.undispatch(out_d, key)
    return (out, api.undispatch(meta.lse, key), *torch.autograd.grad(out, (q, k, v), do))


def qo_comm_phase(cp_api: dict) -> dict:
    """The dynamic (qo-comm) runtime on the card, at the train phase's
    attention shape (bf16, Llama-3.1-8B heads).

    (a) The user path under MAGI_ATTENTION_QO_COMM=1 at cp = 1 over
    ``cp_api``'s two causal documents, unpinned and under the split pin:
    out and lse against ``sdpa_attn``, out and the gradients against the
    static path (``flex_flash_attn_func``); only kernels launch (B1, B7 and
    the backward of the resolved mode); fwd+bwd ms beside ``cp_api``'s,
    and one step of each path under ``torch.profiler`` (device busy time,
    the top device kernels).

    (b) A cp = 4 dynamic plan of a shared-prefix mask on this one card: for
    each rank, its buffers gathered from the full tensors by the plan's send
    indices (exactly the rows the casts deliver; the collectives are held on
    the CPU by tests/test_torch_dynamic.py), the runtime's own forward step
    (B1) and merge step over the partials the other ranks return, then its
    backward steps (B7 on the owner's rows, the backward kernels over the
    buffers) with the partial gradients added back by the same indices.
    Every rank's out and lse, and the summed gradients, against the dense
    plain reference (``sdpa_attn``, ``ffa_bwd_fused_plain`` with dO on every
    row). Also the planning time of each algorithm at this size, the plan's
    communicated rows and bytes beside the static plan's (overlap degree 1),
    and per-rank kernel ms."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.common.enum import AttnMaskType, DynamicAttnAlgType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.config import DistAttnConfig, DynamicAttnConfig, OverlapConfig
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.functional import flex_flash_attn_func
    from magiattention_tpu_torch.functional.dynamic_dist_attn import DynamicDistAttnRuntime
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import (
        ffa_bwd_fused_plain, ffa_bwd_mode, ffa_delta, ffa_delta_plain, plan_params,
    )
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn
    from magiattention_tpu_torch.meta import (
        make_attn_meta_from_dispatch_meta, make_dispatch_meta_from_qk_ranges,
    )
    from magiattention_tpu_torch.meta._make_attn_meta import make_dynamic_attn_plan

    shapes = ((CP_SEQ, CP_HQ, CP_D), (CP_SEQ, CP_HK, CP_D), (CP_SEQ, CP_HK, CP_D))
    total = {}

    def add_counts(counts):
        for k_, v_ in counts.items():
            total[k_] = total.get(k_, 0) + v_

    # ---- (a) the API at cp = 1 -------------------------------------------
    docs = _docs(CP_SEQ, CP_DOC)
    gen = torch.Generator(device="cuda").manual_seed(11)  # cp_api's inputs
    inputs = [torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes]
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    with scoped_env(QO):
        key = api.magi_attn_flex_key(docs, docs, [1, 1], CP_SEQ, CP_SEQ)
    runtime = _mgr(key).runtime
    if not isinstance(runtime, DynamicDistAttnRuntime):
        raise AssertionError(f"qo_comm: the key planned {type(runtime).__name__}")
    a_res = {}
    for pin, env in (("unpinned", {}), ("split", SPLIT)):
        with scoped_env(env):
            mode = ffa_bwd_mode(runtime.ffa_plan, runtime.params(CP_D), CP_D, CP_D, 2, CP_HQ, CP_HK)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = _qo_api(inputs, do, key)
            torch.cuda.synchronize()
            counts = launch_counts()
            expected = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels(mode))
            others = set(FFA_KERNELS) - set(expected)
            if (any(counts[k_] != 1 for k_ in expected) or any(counts[k_] for k_ in others)
                    or any(counts[k_] for k_ in PLAIN_NAMES)):
                raise AssertionError(f"qo_comm cp1 {pin}: launched {counts}, want one of each of {expected}")
            add_counts(counts)
            fwd_bwd_ms = time_ms(lambda: _qo_api(inputs, do, key), samples=5)
        a_res[pin] = dict(resolved_bwd_mode=mode, launches={k_: v_ for k_, v_ in counts.items() if v_},
                          fwd_bwd_ms=fwd_bwd_ms)
    qf, kf_, vf = (t.detach().requires_grad_(True) for t in inputs)
    want_out, want_lse = flex_flash_attn_func(qf, kf_, vf, np.array(docs), np.array(docs), np.array([1, 1]))
    want = (want_out, *torch.autograd.grad(want_out, (qf, kf_, vf), do))
    err = {
        name: grad_check(f"qo_comm cp1 {name} vs static", a.float(), b.float(), "bfloat16")
        for name, a, b in zip(("out", "dq", "dk", "dv"), (got[0], *got[2:]), want)
    }
    with torch.no_grad():
        ref_out, ref_lse = sdpa_attn(*inputs, np.array(docs), np.array(docs), np.array([1, 1]))
    err["out_vs_sdpa"] = grad_check("qo_comm cp1 out vs sdpa", got[0].float(), ref_out.float(), "bfloat16")
    err["lse_vs_sdpa"] = grad_check("qo_comm cp1 lse vs sdpa", got[1], ref_lse, "bfloat16")
    del ref_out, ref_lse, want, got
    static_key = api.magi_attn_flex_key(docs, docs, [1, 1], CP_SEQ, CP_SEQ)  # cp_api's
    for name, k_ in (("static", static_key), ("qo_comm", key)):
        _qo_api(inputs, do, k_)  # warm
        prof = profile_run(lambda k_=k_: _qo_api(inputs, do, k_))
        a_res[f"{name}_profile"] = {
            key_: prof[key_] for key_ in (
                "wall_s", "device_busy_s", "forward_launches", "forward_launches_counted",
                "complete", "top_kernels",
            )
        }
    a_res.update(
        shape=f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}, two causal documents", cp=1,
        errors=err, cp_api_fwd_bwd_ms=cp_api["fwd_bwd_ms"],
        plan_rows={"q_buf": runtime.plan.q_buf_len, "k_buf": runtime.plan.k_buf_len},
    )

    # ---- (b) a cp = 4 plan, every rank on this card ------------------------
    qr_, kr_, types_ = QO_MASK
    mtypes = [AttnMaskType.from_int_type(t) for t in types_]
    q_rng, k_rng = AttnRanges.from_ranges(qr_), AttnRanges.from_ranges(kr_)
    config = DistAttnConfig()
    mq, mkv, bucket = make_dispatch_meta_from_qk_ranges(
        q_rng, k_rng, mtypes, CP_SEQ, CP_SEQ, QO_CHUNK, QO_CP, config.dispatch_config,
    )
    plan_s, plans = {}, {}
    for alg in DynamicAttnAlgType:
        t0 = time.perf_counter()
        plans[alg] = make_dynamic_attn_plan(
            q_rng, k_rng, mtypes, mq, DistAttnConfig(dynamic_config=DynamicAttnConfig(alg=alg)),
            dispatch_meta_kv=mkv,
        )
        plan_s[alg.value] = time.perf_counter() - t0
    plan = plans[config.dynamic_config.alg]
    comm, _ = make_attn_meta_from_dispatch_meta(
        bucket, mq, DistAttnConfig(overlap_config=OverlapConfig(degree=1)), dispatch_meta_kv=mkv,
    )
    row_bytes = {"q": CP_HQ * CP_D * 2, "kv": CP_HK * CP_D * 2, "out_lse": CP_HQ * (CP_D * 2 + 4) / 2}
    comm_rows = {alg.value: p.comm_rows() for alg, p in plans.items()}
    comm_bytes = {
        a_: sum(rows[s] * row_bytes[s] for s in rows) for a_, rows in comm_rows.items()
    }
    static_kv_rows = 2 * sum(s.payload_rows() for s in comm.kv_stages)  # k and v, as comm_rows counts

    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes)
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    qr, kr, types = (np.array(x) for x in QO_MASK)
    with torch.no_grad():
        out_ref, lse_ref = sdpa_attn(q, k, v, qr, kr, types)
    gplan, gparams = plan_params(qr, kr, types, None, None, CP_SEQ, CP_SEQ, CP_D, None, 0.0)
    delta_ref = ffa_delta_plain(out_ref, do)
    dq_ref, dk_ref, dv_ref = ffa_bwd_fused_plain(q, k, v, do, lse_ref, delta_ref, gplan, gparams)
    del delta_ref

    def idx(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device="cuda")

    pos_q = [idx(p) for p in mq.position_ids]
    pos_kv = [idx(p) for p in mkv.position_ids]

    def fetched(stage, pos, r):
        """Global rows of rank r's receive buffer for one cast."""
        return torch.cat([
            pos[s][idx(stage.send_idx[s, r, : stage.send_counts[s, r]])] for s in range(QO_CP)
        ])

    def gather(x, rows, buf_len, fill=0.0):
        out = x.new_full((buf_len, *x.shape[1:]), fill)
        out[: len(rows)] = x[rows]
        return out

    rts = [DynamicDistAttnRuntime(plan, cp_rank=r) for r in range(QO_CP)]
    q_rows = [torch.cat([pos_q[r], fetched(plan.q_cast, pos_q, r)]) for r in range(QO_CP)]
    kv_rows = [torch.cat([pos_kv[r], fetched(plan.kv_cast, pos_kv, r)]) for r in range(QO_CP)]
    bufs = [
        (gather(q, q_rows[r], plan.q_buf_len), gather(k, kv_rows[r], plan.k_buf_len),
         gather(v, kv_rows[r], plan.k_buf_len))
        for r in range(QO_CP)
    ]
    params = rts[0].params(CP_D)
    torch.cuda.synchronize()
    reset_launch_counts()
    fwd = [rts[r].fwd_step(*bufs[r], params) for r in range(QO_CP)]
    out_full = torch.empty_like(q)
    lse_full = torch.empty_like(lse_ref)
    deltas = []
    for r in range(QO_CP):
        ret = plan.ret
        ret_out = torch.zeros((ret.r_max, CP_HQ, CP_D), dtype=q.dtype, device="cuda")
        ret_lse = torch.zeros((ret.r_max, CP_HQ), device="cuda")
        n = 0
        for s in range(QO_CP):  # the partials each compute rank returns to owner r
            rows = idx(ret.send_idx[s, r, : ret.send_counts[s, r]])
            ret_out[n: n + len(rows)] = fwd[s][0][rows]
            ret_lse[n: n + len(rows)] = fwd[s][1][rows]
            n += len(rows)
        out_r, lse_r = rts[r].merge_step(fwd[r][0], fwd[r][1], ret_out, ret_lse)
        out_r = out_r.to(q.dtype)
        out_full[pos_q[r]], lse_full[pos_q[r]] = out_r, lse_r
        deltas.append(ffa_delta(out_r, do[pos_q[r]]))  # B7, on the owner's rows
    delta_full = torch.empty_like(lse_ref)
    for r in range(QO_CP):
        delta_full[pos_q[r]] = deltas[r]
    dq = torch.zeros(shapes[0], device="cuda")
    dk = torch.zeros(shapes[1], device="cuda")
    dv = torch.zeros(shapes[2], device="cuda")
    modes = []
    for r in range(QO_CP):
        nq, nk = len(q_rows[r]), len(kv_rows[r])
        do_buf = gather(do, q_rows[r], plan.q_buf_len)
        lse_buf = gather(lse_full, q_rows[r], plan.q_buf_len, float("-inf"))
        delta_buf = gather(delta_full, q_rows[r], plan.q_buf_len)
        dq_b, dk_b, dv_b = rts[r].bwd_step(*bufs[r], do_buf, lse_buf, delta_buf, params)
        dq.index_add_(0, q_rows[r], dq_b[:nq].to(q.dtype).float())
        dk.index_add_(0, kv_rows[r], dk_b[:nk].to(k.dtype).float())
        dv.index_add_(0, kv_rows[r], dv_b[:nk].to(v.dtype).float())
        modes.append(ffa_bwd_mode(rts[r].ffa_plan, params, CP_D, CP_D, 2, CP_HQ, CP_HK))
    torch.cuda.synchronize()
    counts = launch_counts()
    add_counts(counts)
    want_launch = {"ffa_fwd": QO_CP, "ffa_bwd_delta": QO_CP}
    for m in modes:
        for k_ in _bwd_kernels(m):
            want_launch[k_] = want_launch.get(k_, 0) + 1
    if (any(counts[k_] != n_ for k_, n_ in want_launch.items())
            or any(counts[k_] for k_ in set(FFA_KERNELS) - set(want_launch))
            or any(counts[k_] for k_ in PLAIN_NAMES)):
        raise AssertionError(f"qo_comm cp{QO_CP}: launched {counts}, want {want_launch}")
    ranks = []
    for r in range(QO_CP):
        e_out = grad_check(f"qo_comm r{r} out", out_full[pos_q[r]].float(), out_ref[pos_q[r]].float(), "bfloat16")
        e_lse = grad_check(f"qo_comm r{r} lse", lse_full[pos_q[r]], lse_ref[pos_q[r]], "bfloat16")
        ranks.append(dict(
            rank=r, q_buf_rows=len(q_rows[r]), k_buf_rows=len(kv_rows[r]),
            area=int(plan.attn_args[r].area()), bwd_mode=modes[r],
            fwd_ms=time_ms(lambda r=r: rts[r].fwd_step(*bufs[r], params), samples=3),
            out_max_abs_err=e_out["max_abs_err"], lse_max_abs_err=e_lse["max_abs_err"],
        ))
    grads = {
        name: grad_check(f"qo_comm summed {name}", got, want_, "bfloat16")
        for name, got, want_ in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))
    }
    b_res = dict(
        mask=f"shared prefix: q {qr_}, k {kr_}, types {types_} (1 causal, 0 full)",
        cp=QO_CP, chunk_size=QO_CHUNK, alg=config.dynamic_config.alg.value,
        plan_s=plan_s, comm_rows=comm_rows, comm_bytes=comm_bytes,
        static_kv_rows=static_kv_rows, static_kv_bytes=static_kv_rows * row_bytes["kv"],
        launches={k_: v_ for k_, v_ in counts.items() if v_}, ranks=ranks, summed_grads=grads,
        q_buf_len=plan.q_buf_len, k_buf_len=plan.k_buf_len, ret_len=plan.ret_len,
    )
    del dq_ref, dk_ref, dv_ref, fwd, bufs
    torch.cuda.empty_cache()
    res = dict(cp1=a_res, cp4=b_res, launches=total, atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"])
    emit({"phase": "qo_comm", **res})
    return res


# the cp_baselines phase: the train attention shape, a world of four ranks
# on this one card; cp_api's two causal documents and one causal mask
CPB_WORLD = 4
CPB_MASKS = {
    "two_docs": (_docs(CP_SEQ, CP_DOC), [1, 1]),
    "causal": ([[0, CP_SEQ]], [1]),
}
CPB_RUNS = (
    "ring_contig", "ring_zigzag", "ring_allgather_zigzag", "allgather", "ulysses", "usp_r2u2",
    "loongtrain_o2i2_zigzag", "loongtrain_o1i2u2_head_first", "hybrid_o2i2",
)


@dataclasses.dataclass
class RankJob:
    """One rank's body of a CP baseline as its collectives leave it: its q
    rows (global, natural order) and q heads, per kv part the global rows
    the part holds (zero rows past them up to ``kv_lens``) and the kv
    heads, and per part a plan and its params; ``plans`` None is Ulysses
    (one ``ffa_attn`` over the global metadata)."""

    rank: str
    q_rows: np.ndarray
    heads: slice
    kv_heads: slice
    kv_rows: list
    plans: list | None
    params: list | None = None
    kv_lens: list | None = None


def plan_area(plan) -> int:
    """The (query, key) pairs a plan's work items cover (each item's
    slice band within its tile; dummy items cover none)."""
    from magiattention_tpu_torch.kernels.ffa_plan import DHI, DLO, KE, KS, QE, QS
    from magiattention_tpu_torch.meta.container.slice import band_area_batch

    m = plan.meta.astype(np.int64)
    qb = plan.work_qt.astype(np.int64) * plan.block_q
    kb = plan.work_kt.astype(np.int64) * plan.block_k
    i0 = np.maximum(m[:, QS], qb)
    i1 = np.maximum(np.minimum(m[:, QE], qb + plan.block_q), i0)
    j0 = np.maximum(m[:, KS], kb)
    j1 = np.maximum(np.minimum(m[:, KE], kb + plan.block_k), j0)
    return int(band_area_batch(i0, i1, j0, j1, m[:, DLO], m[:, DHI]).sum())


def baseline_jobs(name: str, qr, types) -> list[RankJob]:
    """Every rank's body of the run ``name`` (``CPB_RUNS``) at cp 4 on the
    mask: the plans the port's entry point builds for that rank
    (``parallel.ring``, ``loongtrain``, ``hybrid``) and the rows its
    collectives deliver."""
    from magiattention_tpu_torch.parallel._utils import baseline_params, zigzag_perm
    from magiattention_tpu_torch.parallel.hybrid import hybrid_rank_plans
    from magiattention_tpu_torch.parallel.loongtrain import loongtrain_rank_plans, src_of
    from magiattention_tpu_torch.parallel.ring import allgather_rank_plan, ring_rank_plans

    S, nat = CP_SEQ, np.arange(CP_SEQ)
    allq, allkv = slice(0, CP_HQ), slice(0, CP_HK)

    def blocks(order, n):
        return [order[i * (S // n):(i + 1) * (S // n)] for i in range(n)]

    def halves(u):  # head subset u of 2 (Ulysses size 2)
        return slice(u * CP_HQ // 2, (u + 1) * CP_HQ // 2), slice(u * CP_HK // 2, (u + 1) * CP_HK // 2)

    jobs = []
    if name in ("ring_contig", "ring_zigzag"):
        sharding = name.split("_")[1]
        b = blocks(nat if sharding == "contig" else zigzag_perm(S, 4), 4)
        for r in range(4):
            jobs.append(RankJob(str(r), b[r], allq, allkv, [b[(r - s) % 4] for s in range(4)],
                                ring_rank_plans(qr, qr, types, S, 4, r, sharding)))
    elif name in ("ring_allgather_zigzag", "allgather"):
        sharding = "zigzag" if name.startswith("ring") else "contig"
        b = blocks(nat if sharding == "contig" else zigzag_perm(S, 4), 4)
        for r in range(4):
            jobs.append(RankJob(str(r), b[r], allq, allkv, [nat],
                                [allgather_rank_plan(qr, qr, types, S, 4, r, sharding)]))
    elif name == "ulysses":
        for j in range(4):
            jobs.append(RankJob(str(j), nat, slice(j * CP_HQ // 4, (j + 1) * CP_HQ // 4),
                                slice(j * CP_HK // 4, (j + 1) * CP_HK // 4), [nat], None))
    elif name == "usp_r2u2":
        b = blocks(nat, 2)
        for r in range(2):
            for u in range(2):
                jobs.append(RankJob(f"r{r}u{u}", b[r], *halves(u), [b[(r - s) % 2] for s in range(2)],
                                    ring_rank_plans(qr, qr, types, S, 2, r, "contig")))
    elif name == "loongtrain_o2i2_zigzag":
        b, src = blocks(zigzag_perm(S, 4), 4), src_of(2, 2)
        for rb in range(4):
            jobs.append(RankJob(f"b{rb}", b[rb], allq, allkv, [b[src(rb, t)] for t in range(4)],
                                loongtrain_rank_plans(qr, qr, types, S, 2, 2, rb, "zigzag")))
    elif name == "loongtrain_o1i2u2_head_first":  # the placement moves ranks, not work
        b, src = blocks(zigzag_perm(S, 2), 2), src_of(1, 2)
        for rb in range(2):
            for u in range(2):
                jobs.append(RankJob(f"b{rb}u{u}", b[rb], *halves(u), [b[src(rb, t)] for t in range(2)],
                                    loongtrain_rank_plans(qr, qr, types, S, 1, 2, rb, "zigzag")))
    elif name == "hybrid_o2i2":
        b, sup = blocks(nat, 4), blocks(nat, 2)
        for rb in range(4):
            jobs.append(RankJob(f"b{rb}", b[rb], allq, allkv, [sup[(rb // 2 - o) % 2] for o in range(2)],
                                hybrid_rank_plans(qr, qr, types, S, 2, 2, rb)))
    else:
        raise ValueError(f"unknown baseline run {name!r}")
    scale = CP_D ** -0.5
    for job in jobs:
        if job.plans is not None:
            job.params = [baseline_params(p, scale) for p in job.plans]
    return jobs


def magi_jobs(qr, types, chunk: int = 512) -> list[RankJob]:
    """Every rank's parts of MagiAttention's own cp 4 plan on the mask
    (the API's default config): its dispatched q rows, its kv shard and
    each stage's receive buffer (``cp_stages``'s gathers)."""
    import torch

    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.functional.dist_attn import DistAttnRuntime
    from magiattention_tpu_torch.meta import (
        make_attn_meta_from_dispatch_meta, make_dispatch_meta_from_qk_ranges,
    )

    config = DistAttnConfig()
    mq, mkv, bucket = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(qr),
        [AttnMaskType.from_int_type(t) for t in types], CP_SEQ, CP_SEQ, chunk, CPB_WORLD,
        config.dispatch_config,
    )
    comm, calc = make_attn_meta_from_dispatch_meta(bucket, mq, config, dispatch_meta_kv=mkv)
    pos_kv = [torch.as_tensor(p, dtype=torch.int64, device="cuda") for p in mkv.position_ids]
    jobs = []
    for r in range(CPB_WORLD):
        runtime = DistAttnRuntime(comm, calc, cp_rank=r, use_overlap=True)
        rows = [pos_kv[r]] + [_stage_rows(st, pos_kv, r, CPB_WORLD) for st in comm.kv_stages]
        lens = [len(pos_kv[r])] + [c.buf_len for c in runtime.cast_plans]
        jobs.append(RankJob(str(r), np.asarray(mq.position_ids[r]), slice(0, CP_HQ), slice(0, CP_HK),
                            [x.cpu().numpy() for x in rows], runtime.plans, runtime._params(CP_D), lens))
    return jobs


def job_tensors(job: RankJob, q, k, v, do):
    """(q, kv parts of k, of v, dO) of a job, gathered from the whole
    tensors by its rows and heads (what the collectives deliver)."""
    import torch

    def rows(x, r, heads, n=None):
        part = x[torch.as_tensor(r, dtype=torch.int64, device="cuda")][:, heads]
        if n is None or n == len(r):
            return part.contiguous()
        return torch.cat([part, part.new_zeros((n - len(r), *part.shape[1:]))])

    lens = job.kv_lens or [None] * len(job.kv_rows)
    ks = [rows(k, r, job.kv_heads, n) for r, n in zip(job.kv_rows, lens)]
    vs = [rows(v, r, job.kv_heads, n) for r, n in zip(job.kv_rows, lens)]
    return rows(q, job.q_rows, job.heads), ks, vs, rows(do, job.q_rows, job.heads)


def job_fwd_bwd(job: RankJob, qj, ks, vs, do_j, qr, types):
    """The job's body, forward and backward: (out, lse, dq, dks, dvs)."""
    import torch

    from magiattention_tpu_torch.functional.dist_attn import multi_ffa
    from magiattention_tpu_torch.kernels.ffa import ffa_attn

    n = len(ks)
    leaves = [t.detach().requires_grad_(True) for t in (qj, *ks, *vs)]
    if job.plans is None:
        out, lse = ffa_attn(leaves[0], leaves[1], leaves[2], qr, qr, types)
    else:
        out, lse = multi_ffa(leaves[0], leaves[1:1 + n], leaves[1 + n:], job.plans, job.params)
    grads = torch.autograd.grad(out, leaves, do_j)
    return out, lse, grads[0], grads[1:1 + n], grads[1 + n:]


def run_jobs(what: str, jobs: list, inputs, refs, qr, types, total: dict) -> dict:
    """Every rank's body of one run on the card: out and lse against the
    dense reference on its rows, the gradients summed as the collectives'
    adjoints would sum them against the reference gradients (bf16 gates),
    parts with no work item giving out 0, lse -inf and zero gradients;
    only kernels launch (counts zeroed just before each rank's body, read
    just after, added to ``total``); per-rank fwd+bwd ms."""
    import torch

    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import ffa_fwd_dispatch, plan_params
    from magiattention_tpu_torch.parallel._utils import live_items

    q, k, v, do = inputs
    out_ref, lse_ref, dq_ref, dk_ref, dv_ref = refs
    dq, dk, dv = (torch.zeros(t.shape, device="cuda") for t in (q, k, v))
    unit = (CP_SEQ // CPB_WORLD) ** 2
    ranks = []
    for job in jobs:
        qj, ks, vs, do_j = job_tensors(job, q, k, v, do)
        rows = torch.as_tensor(job.q_rows, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        reset_launch_counts()
        out, lse, g_q, g_ks, g_vs = job_fwd_bwd(job, qj, ks, vs, do_j, qr, types)
        torch.cuda.synchronize()
        counts = launch_counts()
        n = len(ks)
        if (any(counts[p] for p in PLAIN_NAMES) or counts["ffa_fwd"] + counts["ffa_fwd_gqa"] != n
                or counts["ffa_bwd_delta"] != 1 or counts["ffa_bwd_fused"] + counts["ffa_bwd_dkv"] != n):
            raise AssertionError(f"{what} rank {job.rank}: launched {counts} for {n} parts")
        for k_, v_ in counts.items():
            total[k_] = total.get(k_, 0) + v_
        e_out = grad_check(f"{what} r{job.rank} out", out.float(),
                           out_ref[rows][:, job.heads].float(), "bfloat16")
        e_lse = grad_check(f"{what} r{job.rank} lse", lse, lse_ref[rows][:, job.heads], "bfloat16")
        dq[rows, job.heads] += g_q.float()
        for r_, gk, gv in zip(job.kv_rows, g_ks, g_vs):
            idx = torch.as_tensor(r_, dtype=torch.int64, device="cuda")
            dk[idx, job.kv_heads] += gk[: len(r_)].float()
            dv[idx, job.kv_heads] += gv[: len(r_)].float()
        if job.plans is None:  # Ulysses: ffa_attn's own plan of the global mask
            plan, params = plan_params(qr, qr, types, None, None, CP_SEQ, CP_SEQ, CP_D, None, 0.0)
            plans, params = [plan], [params]
        else:
            plans, params = job.plans, job.params
        empty = [i for i, p in enumerate(plans) if live_items(p) == 0]
        for i in empty:  # a part with no work: out 0, lse -inf, no gradient
            o_e, l_e = ffa_fwd_dispatch(qj, ks[i], vs[i], plans[i], params[i])
            if not (torch.all(o_e == 0) and torch.all(torch.isneginf(l_e))
                    and torch.all(g_ks[i] == 0) and torch.all(g_vs[i] == 0)):
                raise AssertionError(f"{what} rank {job.rank}: empty part {i} is not 0 / -inf / 0")
        heads = (job.heads.stop - job.heads.start) / CP_HQ
        ranks.append(dict(
            rank=job.rank, parts=n, empty_parts=len(empty),
            area_units=sum(plan_area(p) for p in plans) * heads / unit,
            fwd_bwd_ms=time_ms(lambda: job_fwd_bwd(job, qj, ks, vs, do_j, qr, types), samples=5),
            out_max_abs_err=e_out["max_abs_err"], lse_max_abs_err=e_lse["max_abs_err"],
        ))
        del out, lse, g_q, g_ks, g_vs, qj, ks, vs, do_j
    grads = {
        name: grad_check(f"{what} summed {name}", got, want, "bfloat16")
        for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))
    }
    ms = [r["fwd_bwd_ms"] for r in ranks]
    return dict(ranks=ranks, summed_grads=grads, fwd_bwd_ms_min=min(ms), fwd_bwd_ms_max=max(ms))


def cp_baselines_phase() -> dict:
    """The CP baselines of ``parallel/`` on the card, at the train phase's
    attention shape (bf16, Llama-3.1-8B heads), a world of 4 on this one
    card over ``cp_api``'s two causal documents and one causal mask: for
    each run (``CPB_RUNS``) every rank's body as its entry point calls it
    after its collectives, its buffers gathered from the whole tensors by
    index (the collectives are held on the CPU by
    tests/test_torch_baselines.py). Each rank's out and lse against
    ``sdpa_attn`` on its rows, the gradients summed as the collectives'
    adjoints sum them against ``ffa_bwd_fused_plain`` (dO on every row),
    in the bf16 gates; parts with no work checked; only kernels launch.
    Per-rank fwd+bwd ms (min / max over ranks: the slowest sets a CP
    step's pace), each rank's area in units of (S/4)^2 (heads-weighted),
    MagiAttention's own cp 4 plan on the same mask timed the same way, the
    single-device ``ffa_attn`` fwd+bwd, and one profiled rank step each of
    the zigzag ring and Ulysses."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import (
        ffa_attn, ffa_bwd_fused_plain, ffa_delta_plain, plan_params,
    )
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    shapes = ((CP_SEQ, CP_HQ, CP_D), (CP_SEQ, CP_HK, CP_D), (CP_SEQ, CP_HK, CP_D))
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes)
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    total: dict = {}
    res = dict(shape=f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}", world=CPB_WORLD)
    for mask, (docs, types_) in CPB_MASKS.items():
        qr, types = np.array(docs), np.array(types_)
        with torch.no_grad():
            out_ref, lse_ref = sdpa_attn(q, k, v, qr, qr, types)
        gplan, gparams = plan_params(qr, qr, types, None, None, CP_SEQ, CP_SEQ, CP_D, None, 0.0)
        delta = ffa_delta_plain(out_ref, do)
        refs = (out_ref, lse_ref, *ffa_bwd_fused_plain(q, k, v, do, lse_ref, delta, gplan, gparams))
        del delta
        runs = {}
        for name in CPB_RUNS:
            jobs = baseline_jobs(name, qr, types)
            runs[name] = run_jobs(f"cp_baselines {mask} {name}", jobs, (q, k, v, do), refs, qr, types, total)
        runs["magi_cp4"] = run_jobs(f"cp_baselines {mask} magi", magi_jobs(qr, types), (q, k, v, do),
                                    refs, qr, types, total)

        def single():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out, _ = ffa_attn(*leaves, qr, qr, types)
            return torch.autograd.grad(out, leaves, do)

        profiles = {}
        for name in ("ring_zigzag", "ulysses") if mask == "two_docs" else ():
            job = baseline_jobs(name, qr, types)[0]
            tensors = job_tensors(job, q, k, v, do)
            prof = profile_run(lambda: job_fwd_bwd(job, *tensors, qr, types))
            profiles[name] = {key: prof[key] for key in (
                "wall_s", "device_busy_s", "forward_device_ms", "forward_launches",
                "forward_launches_counted", "complete", "top_kernels")}
        res[mask] = dict(
            mask=f"q = k ranges {docs}, types {types_} (1 causal)", runs=runs,
            single_device_fwd_bwd_ms=time_ms(single, samples=5), rank0_profiles=profiles,
        )
        del refs, out_ref, lse_ref
        torch.cuda.empty_cache()
    res.update(launches=total, atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"])
    emit({"phase": "cp_baselines", **res})
    return res


# ---------------------------------------------------------------------------
# cp_hier_tp: two-level comm, TP over heads and the high-precision reduce
# through the API, four processes on this one card over gloo (gloo stages
# CUDA tensors through the host; NCCL puts no two ranks on one card); the
# sink drop-ins of extensions/ in this process
# ---------------------------------------------------------------------------

HT_WORLD, HT_CHUNK = 4, 512
HIER_ENV = {"MAGI_ATTENTION_HIERARCHICAL_COMM": "1"}
HP_ENV = {"MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE": "1"}
PAIR = ("dcn", "ici")


def ht_meshes():
    """The (dcn 2, ici 2) mesh and the (cp 2, tp 2) mesh over ranks 0-3
    (every process builds both, in this order: ``new_group`` is
    collective)."""
    from magiattention_tpu_torch.parallel import ProcessMesh

    return (ProcessMesh(np.arange(4).reshape(2, 2), PAIR),
            ProcessMesh(np.arange(4).reshape(2, 2), ("cp", "tp")))


def ht_key(docs, types, env: dict, device: str = "cuda", **kw):
    """A key of the mask built under ``env`` (the key reads the flags)."""
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.env.general import scoped_env

    seq = docs[-1][1]
    with scoped_env(env):
        return api.magi_attn_flex_key(docs, docs, list(types), seq, seq, device=device,
                                      chunk_size=min(HT_CHUNK, seq // 8), **kw)


class HTCase:
    """One key's run on this rank: its dispatched rows of the heads given,
    ``step()`` (calc_attn forward and backward under ``env``: out, lse,
    dq, dk, dv), ``forward()`` (out alone) and ``want``, the
    single-device result in the same rows and heads."""

    def __init__(self, key, env: dict, inputs, want_full, heads=slice(None), kv_heads=slice(None)):
        from magiattention_tpu_torch import api

        q, k, v, do = (x[:, h] for x, h in zip(inputs, (heads, kv_heads, kv_heads, heads)))
        self.key, self.env = key, env
        self.q, self.do = api.dispatch(q, key), api.dispatch(do, key)
        self.k, self.v = api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv")
        o, lse, dq, dk, dv = want_full
        self.want = (api.dispatch(o[:, heads], key), api.dispatch(lse[:, heads], key),
                     api.dispatch(dq[:, heads], key), api.dispatch(dk[:, kv_heads], key, role="kv"),
                     api.dispatch(dv[:, kv_heads], key, role="kv"))

    def step(self):
        import torch

        from magiattention_tpu_torch import api
        from magiattention_tpu_torch.env.general import scoped_env

        with scoped_env(self.env):
            ls = [t.detach().requires_grad_(True) for t in (self.q, self.k, self.v)]
            out, meta = api.calc_attn(*ls, self.key)
            return (out, meta.lse, *torch.autograd.grad(out, ls, self.do))

    def forward(self):
        import torch

        from magiattention_tpu_torch import api
        from magiattention_tpu_torch.env.general import scoped_env

        with scoped_env(self.env), torch.no_grad():
            return api.calc_attn(self.q, self.k, self.v, self.key)[0]


def ht_check(what: str, got, want) -> dict:
    return {n: grad_check(f"{what} {n}", a.float(), b.float(), "bfloat16")
            for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want)}


def ht_reference(inputs, qr, types):
    """The single-device ``ffa_attn`` on the whole problem: out, lse and
    the gradients of sum(out * dO)."""
    import torch

    from magiattention_tpu_torch.kernels.ffa import ffa_attn

    q, k, v, do = inputs
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out, lse = ffa_attn(*leaves, qr, qr, types)
    return (out.detach(), lse, *torch.autograd.grad(out, leaves, do))


def ht_inputs(seed: int, seq: int = CP_SEQ, device: str = "cuda"):
    """bf16 q, k, v and dO at the train attention shape (float32 in a CPU
    rehearsal, whose plain versions are float32 references)."""
    import torch

    dt = torch.bfloat16 if device == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ((seq, CP_HQ, CP_D), (seq, CP_HK, CP_D), (seq, CP_HK, CP_D))
    q, k, v = (torch.randn(sh, generator=gen, device=device).to(dt) for sh in shapes)
    do = (torch.randn(shapes[0], generator=gen, device=device) / 4).to(dt)
    return q, k, v, do


def wire_dtypes(fn) -> tuple[list[str], object]:
    """``fn()`` with every ``all_to_all_single`` input's dtype logged."""
    import torch.distributed as dist

    log, a2a = [], dist.all_to_all_single

    def rec(out, inp, *args, **kwargs):
        log.append(str(inp.dtype).removeprefix("torch."))
        return a2a(out, inp, *args, **kwargs)

    dist.all_to_all_single = rec
    try:
        res = fn()
    finally:
        dist.all_to_all_single = a2a
    return log, res


def counted(fn, on_card: bool = True) -> tuple[dict, object]:
    """``fn()`` with the launch counts zeroed just before and read just
    after; on the card no plain version may run."""
    import torch

    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts

    if on_card:
        torch.cuda.synchronize()
    reset_launch_counts()
    res = fn()
    if on_card:
        torch.cuda.synchronize()
    counts = launch_counts()
    if on_card and any(counts[p] for p in PLAIN_NAMES):
        raise AssertionError(f"a plain version ran: {counts}")
    return {k: c for k, c in counts.items() if c}, res


def cross_node_rows(stages, n_inner: int) -> list[int]:
    """Per stage, the rows the flat cast sends between ranks of different
    nodes (each once per destination rank)."""
    cp = len(stages[0].transfer_table) if stages else 0
    return [sum(s.transfer_table[d][src].total_seqlen for d in range(cp) for src in range(cp)
                if d // n_inner != src // n_inner) for s in stages]


def cp_hier_tp_rank(rank: int, device: str = "cuda", seq: int = CP_SEQ) -> dict:
    """One rank of ``cp_hier_tp`` on both of ``cp_baselines``' masks:
    (a) the flat and the two-level cast at (dcn 2, ici 2): every stage's
    receive buffer equal to the bit, out and lse equal to the bit, the
    gradients within the bf16 gates of the flat run's and of the
    single-device ``ffa_attn``'s, ``dcn_rows`` beside the flat cast's
    cross-node rows; (b) the high-precision reduce on both: the forward
    sends bf16 and out is the run's without it, to the bit; (c) (cp 2,
    tp 2): 16 q and 4 kv heads a process against ``ffa_attn`` on those
    heads, the solves this process ran (one; a key without ``head_axis``
    reuses it). Launch counts of the two-level and the TP run, fwd+bwd
    ms of every rank. ``device="cpu"`` rehearses it (the plain versions,
    nothing timed)."""
    import torch

    from magiattention_tpu_torch import dist_attn_runtime_mgr
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.comm.primitives import group_cast_all

    solves, solve = [], dist_attn_runtime_mgr.make_attn_meta_from_dispatch_meta

    def counted_solve(*args, **kwargs):
        solves.append(1)
        return solve(*args, **kwargs)

    dist_attn_runtime_mgr.make_attn_meta_from_dispatch_meta = counted_solve
    try:
        on_card = device == "cuda"
        mesh_h, mesh_t = ht_meshes()
        inputs = ht_inputs(31, seq, device)
        res = {}
        for mask, (docs, types) in CPB_MASKS.items():
            docs = [[a * seq // CP_SEQ, b * seq // CP_SEQ] for a, b in docs]
            want_full = ht_reference(inputs, np.array(docs), np.array(types))
            flat = HTCase(ht_key(docs, types, {}, device, mesh=mesh_h, cp_axis=PAIR), {}, inputs,
                          want_full)
            hier = HTCase(ht_key(docs, types, HIER_ENV, device, mesh=mesh_h, cp_axis=PAIR), HIER_ENV,
                          inputs, want_full)
            rt_f, rt_h = _mgr(flat.key).runtime, _mgr(hier.key).runtime
            if rt_f.hier or not rt_h.hier:
                raise AssertionError(f"cp_hier_tp {mask}: the runtimes did not take their paths")
            # (a) the receive buffers, out and lse to the bit; gradients in the gates
            kv = torch.cat([flat.k, flat.v], dim=-1)
            bufs_equal = []
            for p_f, p_h in zip(rt_f.cast_plans, rt_h.cast_plans):
                (_, b_f), w_f = group_cast_all(kv, [p_f], rt_f.cast_group)
                (_, b_h), w_h = group_cast_all(kv, [p_h], rt_h.cast_group)
                w_f[0]()
                w_h[0]()
                bufs_equal.append(bool(torch.equal(b_f, b_h)))
            if not bufs_equal or not all(bufs_equal):
                raise AssertionError(f"cp_hier_tp {mask} rank {rank}: receive buffers {bufs_equal}")
            got_f = flat.step()
            launches_h, got_h = counted(hier.step, on_card)
            if not (torch.equal(got_h[0], got_f[0]) and torch.equal(got_h[1], got_f[1])):
                raise AssertionError(f"cp_hier_tp {mask} rank {rank}: two-level out/lse differ from flat")
            err_h = ht_check(f"cp_hier_tp {mask} two-level vs dense", got_h, hier.want)
            err_hf = ht_check(f"cp_hier_tp {mask} two-level vs flat", got_h, got_f)
            stages = _mgr(hier.key).comm_meta.kv_stages
            # (b) the high-precision reduce: bf16 on the forward's wire, out unchanged
            hp = {}
            for name, env, ref_out in (("flat", HP_ENV, got_f[0]), ("two_level", {**HIER_ENV, **HP_ENV},
                                                                     got_h[0])):
                case = HTCase(ht_key(docs, types, env, device, mesh=mesh_h, cp_axis=PAIR), env, inputs,
                              want_full)
                wires, out_hp = wire_dtypes(case.forward)
                if set(wires) != {str(inputs[1].dtype).removeprefix("torch.")} or not torch.equal(
                        out_hp, ref_out):
                    raise AssertionError(f"cp_hier_tp {mask} hp {name} rank {rank}: wire {set(wires)}, "
                                         f"out equal {torch.equal(out_hp, ref_out)}")
                hp[name] = dict(forward_wire=sorted(set(wires)), transfers=len(wires), out_bitwise=True)
                del case, out_hp
            # (c) TP over heads at (cp 2, tp 2)
            t = mesh_t.coord("tp")
            heads = slice(t * CP_HQ // 2, (t + 1) * CP_HQ // 2)
            kv_heads = slice(t * CP_HK // 2, (t + 1) * CP_HK // 2)
            before = len(solves)
            tp = HTCase(ht_key(docs, types, {}, device, mesh=mesh_t, cp_axis="cp", head_axis="tp"), {},
                        inputs, want_full, heads, kv_heads)
            reuse = _mgr(ht_key(docs, types, {}, device, mesh=mesh_t, cp_axis="cp")).plan_source
            tp_solves = len(solves) - before
            if tp_solves != 1 or reuse != "memory":
                raise AssertionError(f"cp_hier_tp {mask} rank {rank}: {tp_solves} solves, reuse {reuse}")
            launches_t, got_t = counted(tp.step, on_card)
            err_t = ht_check(f"cp_hier_tp {mask} tp", got_t, tp.want)
            del got_f, got_h, got_t, want_full
            res[mask] = dict(
                two_level=dict(
                    errors_vs_dense=err_h, errors_vs_flat=err_hf, buffers_bitwise=bufs_equal,
                    out_lse_bitwise=True, launches=launches_h,
                    dcn_rows=[s.hier_plan.dcn_rows() for s in stages],
                    flat_cross_node_rows=cross_node_rows(stages, 2),
                    fwd_bwd_ms=_world_ms(hier.step, on_card, warmup=2, samples=5),
                    flat_fwd_bwd_ms=_world_ms(flat.step, on_card, warmup=2, samples=5),
                ),
                hp=hp,
                tp=dict(tp_rank=t, q_heads=[heads.start, heads.stop],
                        kv_heads=[kv_heads.start, kv_heads.stop], errors=err_t, solves=tp_solves,
                        no_head_axis_key=reuse, launches=launches_t,
                        fwd_bwd_ms=_world_ms(tp.step, on_card, warmup=2, samples=5)),
            )
            del flat, hier, tp
            torch.cuda.empty_cache()
        res["gloo_a2a_32mb_ms"] = gloo_a2a_ms(device)
        return res
    finally:
        dist_attn_runtime_mgr.make_attn_meta_from_dispatch_meta = solve


def gloo_a2a_ms(device: str, rows: int = 8192, samples: int = 5) -> float:
    """The host-clock ms of one ``all_to_all_single`` of 32 MB a rank
    (8 MB to each of four ranks, bf16 rows of k|v at 8 heads), what the
    phase's collectives cost on this setup."""
    import torch
    import torch.distributed as dist

    x = torch.zeros((rows, CP_HK, 2 * CP_D), dtype=torch.bfloat16, device=device)
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(samples):
        dist.all_to_all_single(y, x)
    if device == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / samples * 1e3


def cp_hier_tp_worker(rank: int, init_file: str, out_dir: str, device: str, seq: int) -> None:
    """One process of ``cp_hier_tp`` (gloo, on card 0); its results to
    ``out_dir/rank<r>.json``."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=HT_WORLD,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = cp_hier_tp_rank(rank, device, seq)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()  # leave together
    finally:
        dist.destroy_process_group()


SINK_WINDOW, SINK_SLOTS = (4096, -1), 4


def sink_dropins(device: str = "cuda", seq: int = CP_SEQ) -> dict:
    """``fa3_func_with_sink`` (batch 1) and ``fa3_varlen_func_with_sink``
    (two documents of 4096) at the train attention shape, bf16, causal
    with a 4096-token window and an ``sh`` sink of 4 slots: out, lse and
    the gradients (q, k, v, sink) against the same entries on the plain
    ``sdpa`` backend (run 8 q heads at a time: the dense logits of all 32
    would take 35 GB), bf16 gates; launch counts and fwd+bwd ms."""
    import torch

    from magiattention_tpu_torch.extensions import fa3_func_with_sink, fa3_varlen_func_with_sink

    q, k, v, do = ht_inputs(37, seq, device)
    gen = torch.Generator(device=device).manual_seed(38)
    sink = torch.randn((SINK_SLOTS, CP_HQ), generator=gen, device=device)
    cu = [0, seq // 2, seq]
    entries = {
        "fa3_func_with_sink": lambda q, k, v, s, **kw: (lambda o, l: (o[0], l[0].transpose(0, 1)))(
            *fa3_func_with_sink(q[None], k[None], v[None], s, causal=True, window_size=SINK_WINDOW,
                                return_attn_probs=True, **kw)),
        "fa3_varlen_func_with_sink": lambda q, k, v, s, **kw: fa3_varlen_func_with_sink(
            q, k, v, cu, cu, sink=s, causal=True, window_size=SINK_WINDOW, return_attn_probs=True, **kw),
    }
    res = {}
    g = CP_HQ // CP_HK
    for name, fn in entries.items():
        def run(q=q, k=k, v=v, s=sink, do=do, fn=fn, **kw):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v, s)]
            out, lse = fn(*leaves, **kw)
            return (out, lse, *torch.autograd.grad(out, leaves, do))

        launches, got = counted(run, device == "cuda")
        parts = [run(q[:, h:h + 8], k[:, h // g:(h + 8) // g], v[:, h // g:(h + 8) // g],
                     sink[:, h:h + 8], do[:, h:h + 8], backend="sdpa") for h in range(0, CP_HQ, 8)]
        want = [torch.cat([p[i] for p in parts], dim=1) for i in range(6)]
        del parts
        err = {n: grad_check(f"sink {name} {n}", a.float(), b.float(), "bfloat16")
               for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want)}
        # dsink sums over every row: held as the repo holds such sums
        err["dsink"] = sum_check(f"sink {name} dsink", got[5], want[5], "bfloat16")
        del want, got
        res[name] = dict(errors=err, launches=launches,
                         fwd_bwd_ms=time_ms(run, samples=5) if device == "cuda" else None)
        torch.cuda.empty_cache()
    return res


def cp_hier_tp_phase(device: str = "cuda", seq: int = CP_SEQ) -> dict:
    """Two-level comm at (dcn 2, ici 2), TP over heads at (cp 2, tp 2) and
    the high-precision reduce through the API at the train attention
    shape (bf16, Llama-3.1-8B heads) on ``cp_baselines``' masks: four
    processes on this one card over gloo (the kernels built here first:
    four builds into one cache would race), each running
    :func:`cp_hier_tp_rank`; then the sink drop-ins in this process. The
    slowest rank's fwd+bwd ms per case and the summed launch counts. Four
    processes on one card share it, and gloo moves the rows through the
    host: the times say what the phase costs here, not what a
    deployment's step does (``--cp4`` times the NCCL runs).
    ``cp_hier_tp_phase("cpu", 512)`` rehearses it on the CPU."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if device == "cuda":
        torch.cuda.empty_cache()  # the four processes share this card
    out_dir = tempfile.mkdtemp(prefix="cp_hier_tp_")
    t0 = time.perf_counter()
    mp.start_processes(cp_hier_tp_worker, args=(os.path.join(out_dir, "init"), out_dir, device, seq),
                       nprocs=HT_WORLD, start_method="spawn", join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(HT_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches: dict = {}
    res = dict(world=HT_WORLD, backend="gloo (one card)", wall_s=spawn_s,
               gloo_a2a_32mb_ms=[rk["gloo_a2a_32mb_ms"] for rk in ranks],
               shape=f"bf16 q [{seq}, {CP_HQ}, {CP_D}], k/v [{seq}, {CP_HK}, {CP_D}]")
    for mask in CPB_MASKS:
        per = [rk[mask] for rk in ranks]
        for p in per:
            for part in ("two_level", "tp"):
                for k_, c in p[part]["launches"].items():
                    launches[k_] = launches.get(k_, 0) + c
        two, tp = [p["two_level"] for p in per], [p["tp"] for p in per]
        res[mask] = dict(
            two_level=dict(
                fwd_bwd_ms_max=max(max(p["fwd_bwd_ms"]) for p in two),
                flat_fwd_bwd_ms_max=max(max(p["flat_fwd_bwd_ms"]) for p in two),
                dcn_rows=two[0]["dcn_rows"], flat_cross_node_rows=two[0]["flat_cross_node_rows"],
                buffers_bitwise=all(all(p["buffers_bitwise"]) for p in two), out_lse_bitwise=True,
                max_err_vs_dense={n: max(p["errors_vs_dense"][n]["max_abs_err"] for p in two)
                                  for n in two[0]["errors_vs_dense"]},
                max_rel_norm_vs_flat={n: max(p["errors_vs_flat"][n]["rel_norm_err"] for p in two)
                                      for n in two[0]["errors_vs_flat"]},
                launches_per_rank=[p["launches"] for p in two],
            ),
            hp=per[0]["hp"],
            tp=dict(
                fwd_bwd_ms_max=max(max(p["fwd_bwd_ms"]) for p in tp),
                solves_per_process=[p["solves"] for p in tp],
                max_err={n: max(p["errors"][n]["max_abs_err"] for p in tp) for n in tp[0]["errors"]},
                launches_per_rank=[p["launches"] for p in tp],
            ),
        )
    sink = sink_dropins(device, seq)
    for s in sink.values():
        for k_, c in s["launches"].items():
            launches[k_] = launches.get(k_, 0) + c
    res.update(sink_dropins=sink, launches=launches, atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"])
    emit({"phase": "cp_hier_tp", **res})
    return res


# meta-llama/Llama-3.1-8B config.json widths; depth cut from 32 layers
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_DOC, TRAIN_STEPS, TRAIN_LR = 2, 8192, 4096, 3, 1e-4
CHECK_SEQ, CHECK_DOC = 2048, 1024
TRAIN_LOSS_RTOL, TRAIN_GRAD_RNORM = 1e-2, 2e-2
FFA_KERNELS = (
    "ffa_fwd", "ffa_fwd_gqa", "ffa_bwd_delta", "ffa_bwd_dq", "ffa_bwd_dq_gqa",
    "ffa_bwd_dkv", "ffa_bwd_fused",
)
SPLIT = {"MAGI_ATTENTION_BACKEND_FFA_BWD": "split"}
PACK = {"MAGI_ATTENTION_FFA_GQA_PACK": "1", "MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1"}


def train_phase() -> dict:
    """``models.llama.train_step`` on the card, attention through the API
    (``magi_attn_flex_key`` at cp = 1, ``calc_attn`` per layer); asserts
    finite losses, one launch of each FFA kernel of the resolved path per
    layer per step, no plain version on the path. The cost model must
    resolve the fused backward unpinned here; TRAIN_STEPS steps run so.
    Then one step under the split pin, one under both GQA pack flags with
    the split pin (B2, B7, B4, B5/B6) and one under the pack flags unpinned
    (B2, B7, B8/B9). Then the kernels' loss and gradients against the plain
    path's (``MAGI_ATTENTION_KERNEL_BACKEND=sdpa``: dense float32 attention
    under autograd) at CHECK_SEQ tokens: the plain path keeps float32 (32,
    S, S) tensors per layer for autograd, which at 8192 tokens do not fit
    twice over on 80 GB."""
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

    def key_of(seq, doc, **env):
        docs = _docs(seq, doc)
        with scoped_env(env):
            return api.magi_attn_flex_key(docs, docs, [1] * len(docs), seq, seq)

    labels = next_token_labels(tokens, TRAIN_DOC)
    key = key_of(TRAIN_SEQ, TRAIN_DOC)
    runtime = _mgr(key).runtime
    model_mode = ffa_bwd_mode(
        runtime.plans[0], runtime._params(cfg.head_dim)[0], cfg.head_dim,
        cfg.head_dim, 2, cfg.n_heads, cfg.n_kv_heads,
    )
    if model_mode != "fused":
        raise AssertionError(f"train: the unpinned backward resolves {model_mode}, want fused")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step(i, env, kernels):
        before = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nonlocal params
        with scoped_env(env):
            params, loss = train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR)
            loss = loss.item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        rec = dict(
            step=i, env=env, loss=loss, ms=ms, tokens_per_s=TRAIN_SEQ / (ms * 1e-3),
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
        return rec

    fused_kernels = ("ffa_fwd", "ffa_bwd_delta", "ffa_bwd_fused")
    reset_launch_counts()
    steps = [step(i, {}, fused_kernels) for i in range(TRAIN_STEPS)]
    fused_counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_launch_counts()
    split_step = step(TRAIN_STEPS, SPLIT, ("ffa_fwd", "ffa_bwd_delta", "ffa_bwd_dq", "ffa_bwd_dkv"))
    split_counts = launch_counts()
    reset_launch_counts()
    packed_steps = [
        step(TRAIN_STEPS + 1, {**PACK, **SPLIT},
             ("ffa_fwd_gqa", "ffa_bwd_delta", "ffa_bwd_dq_gqa", "ffa_bwd_dkv")),
        step(TRAIN_STEPS + 2, PACK, ("ffa_fwd_gqa", "ffa_bwd_delta", "ffa_bwd_fused")),
    ]
    packed_counts = launch_counts()
    remat = remat_check(params, cfg, tokens, labels, key)

    prof = profile_run(lambda: train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR))

    # kernels against the plain path, same weights and tokens
    tok2 = tokens[:CHECK_SEQ]
    lab2 = next_token_labels(tok2, CHECK_DOC)
    loss_k, g_k = value_and_grad(params, cfg, tok2, lab2, key_of(CHECK_SEQ, CHECK_DOC))
    plain_env = {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}
    with scoped_env(plain_env):
        loss_p, g_p = value_and_grad(
            params, cfg, tok2, lab2, key_of(CHECK_SEQ, CHECK_DOC, **plain_env)
        )
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst, worst_rn, _ = grads_rel_norm(param_names(params), g_k, g_p)
    if loss_rel > TRAIN_LOSS_RTOL or worst_rn > TRAIN_GRAD_RNORM:
        raise AssertionError(
            f"train: kernels vs plain loss rel {loss_rel:.3e}, worst gradient "
            f"{worst} rel-norm {worst_rn:.3e} beyond {TRAIN_LOSS_RTOL}, "
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
        cost_model_bwd_mode=model_mode, setup_s=setup_s, steps=steps,
        losses=[s["loss"] for s in steps], split_step=split_step,
        packed_steps=packed_steps,
        launches={k: fused_counts[k] for k in FFA_KERNELS},
        split_launches={k: split_counts[k] for k in FFA_KERNELS},
        packed_launches={k: packed_counts[k] for k in FFA_KERNELS},
        plain_calls={k: fused_counts[k] for k in PLAIN_NAMES},
        peak_memory_gb=peak_gb, remat=remat, profile_step=prof,
        check=dict(
            tokens=CHECK_SEQ, documents=CHECK_SEQ // CHECK_DOC,
            loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
            loss_rel_err=loss_rel, worst_grad=worst,
            worst_grad_rel_norm_err=worst_rn,
            loss_rtol=TRAIN_LOSS_RTOL, grad_rnorm=TRAIN_GRAD_RNORM,
        ),
    )
    emit({"phase": "train", **res})
    return res


# meta-llama/Llama-3.1-8B config.json: hidden 4096, 32 heads, 8 kv heads
# (head dim 128), intermediate 14336, vocab 128256, rope_theta 500000,
# rms_norm_eps 1e-5, 32 layers (the train phase's widths)
LLAMA_WIDTHS = dict(vocab_size=128256, dim=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                    ffn_hidden=14336, rope_theta=500000.0, norm_eps=1e-5)
LLAMA_LAYERS = 32
# ``cp4_main("cpu")``'s rehearsal widths (heads split over tp 2)
LLAMA_SMALL = dict(vocab_size=256, dim=64, n_heads=4, n_kv_heads=2, head_dim=16, ffn_hidden=128)


def llama_config(on_card: bool, **kw):
    from magiattention_tpu_torch.models.llama import LlamaConfig

    widths = LLAMA_WIDTHS if on_card else LLAMA_SMALL
    return LlamaConfig(**{**widths, "n_layers": TRAIN_LAYERS, "dtype": "bfloat16", **kw})


def llama_param_count(cfg) -> int:
    """The parameters of ``init_params(cfg)``, counted on the host."""
    attn = cfg.dim * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    layer = 2 * cfg.dim + attn + 3 * cfg.dim * cfg.ffn_hidden
    return 2 * cfg.vocab_size * cfg.dim + cfg.dim + cfg.n_layers * layer


def sharded_llama_init(cfg, seed: int, mesh, device: str, **shard_kw) -> dict:
    """``shard_params(init_params(cfg, seed), mesh, **shard_kw)`` without
    the whole tree on the card: each layer's leaves are drawn in
    ``init_params``' order (layers first, then embed and lm_head) from the
    same generator and sharded at once, so at most one layer or one
    embedding table is whole at a time; the shards are those of the whole
    tree's to the bit."""
    import dataclasses

    import torch

    from magiattention_tpu_torch.models.llama import shard_params

    gen = torch.Generator(device=device).manual_seed(seed)
    dh, hq, hk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def dense(shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(shape[0] ** -0.5)

    def ones():
        return torch.ones((cfg.dim,), device=device, dtype=torch.float32)

    layers, layer_specs = [], None
    for _ in range(cfg.n_layers):
        one = {"attn_norm": ones(), "wq": dense((cfg.dim, hq * dh)),
               "wk": dense((cfg.dim, hk * dh)), "wv": dense((cfg.dim, hk * dh)),
               "wo": dense((hq * dh, cfg.dim)), "mlp_norm": ones(),
               "w_gate": dense((cfg.dim, cfg.ffn_hidden)), "w_up": dense((cfg.dim, cfg.ffn_hidden)),
               "w_down": dense((cfg.ffn_hidden, cfg.dim))}
        tree = shard_params({"layers": [one]}, mesh, **shard_kw)
        layers.append(tree["layers"][0])
        layer_specs = tree["sharding"].layer
        del one, tree
    top = shard_params({"embed": dense((cfg.vocab_size, cfg.dim)), "final_norm": ones(),
                        "lm_head": dense((cfg.dim, cfg.vocab_size)), "layers": []},
                       mesh, **shard_kw)
    top["layers"] = layers
    top["sharding"] = dataclasses.replace(top.pop("sharding"), layer=layer_specs)
    return top


def shard_cp1_phase() -> dict:
    """``shard_params`` on a one-rank mesh at the train phase's model and
    tokens: every block is the whole leaf and every gather the identity,
    so under MAGI_ATTENTION_DETERMINISTIC_MODE=1 the sharded tree's loss
    and gradients equal the unsharded tree's to the bit; then one unpinned
    ``train_step`` on the sharded tree (B1, B7, B8/B9 once a layer, no
    plain version). Its launches join the ``kernels`` line; the sharded
    paths across cards run in ``--cp4``."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts
    from magiattention_tpu_torch.models.llama import (
        init_params, shard_params, train_step, value_and_grad,
    )
    from magiattention_tpu_torch.parallel import ProcessMesh

    cfg = llama_config(True)
    params = init_params(cfg, seed=0, device="cuda")
    sharded = shard_params(params, ProcessMesh(np.arange(1), ("cp",)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_SEQ,), generator=gen, device="cuda")
    labels = next_token_labels(tokens, TRAIN_DOC)
    docs = _docs(TRAIN_SEQ, TRAIN_DOC)
    with scoped_env(DETERMINISTIC_ENV):
        key = api.magi_attn_flex_key(docs, docs, [1, 1], TRAIN_SEQ, TRAIN_SEQ)
        loss, grads = value_and_grad(params, cfg, tokens, labels, key)
        loss_s, grads_s = value_and_grad(sharded, cfg, tokens, labels, key)
    differ = [i for i, (a, b) in enumerate(zip(grads, grads_s)) if not torch.equal(a, b)]
    if not torch.equal(loss, loss_s) or differ:
        raise AssertionError(f"shard_cp1: the sharded tree's step differs (gradients {differ})")
    del params, grads, grads_s
    key = api.magi_attn_flex_key(docs, docs, [1, 1], TRAIN_SEQ, TRAIN_SEQ)
    reset_launch_counts()
    sharded, loss = train_step(sharded, cfg, tokens, labels, key, lr=TRAIN_LR)
    launches = {k: v for k, v in launch_counts().items() if v}
    mode = step_launches("shard_cp1", launches, cfg.n_layers)
    res = dict(layers=cfg.n_layers, tokens=TRAIN_SEQ, deterministic_bitwise=True,
               loss=loss.item(), bwd_mode=mode, launches=launches)
    del sharded
    torch.cuda.empty_cache()
    emit({"phase": "shard_cp1", **res})
    return res


def remat_check(params, cfg, tokens, labels, key) -> dict:
    """One step's loss and gradients (``value_and_grad``) with
    ``cfg.remat`` (each layer recomputed in the backward) against the same
    without it: loss rel and every gradient's rel-norm within the bf16
    gate, B1 twice per layer (the recompute), and each run's peak memory
    above what was allocated when it started and its ms (host clock
    around a synchronize, one sample each)."""
    import torch

    from magiattention_tpu_torch.kernels import launch_counts
    from magiattention_tpu_torch.models.llama import param_names, value_and_grad

    runs = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t1 = time.perf_counter()
        runs[remat] = value_and_grad(params, dataclasses.replace(cfg, remat=remat), tokens,
                                     labels, key)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        after = launch_counts()
        runs[remat] += ((torch.cuda.max_memory_allocated() - start) / 1e9, ms,
                        {k: after[k] - before[k] for k in after if after[k] != before[k]})
    (loss_a, g_a, mem_a, ms_a, _), (loss_r, g_r, mem_r, ms_r, launches) = runs[False], runs[True]
    loss_rel = abs(loss_r.item() - loss_a.item()) / abs(loss_a.item())
    worst, worst_rn, _ = grads_rel_norm(param_names(params), g_r, g_a)
    max_diff = max((a.double() - b.double()).abs().max().item() for a, b in zip(g_r, g_a))
    if launches.get("ffa_fwd") != 2 * cfg.n_layers:
        raise AssertionError(f"train remat: B1 launched {launches}, want twice per layer")
    if loss_rel > RNORM["bfloat16"] or worst_rn > RNORM["bfloat16"]:
        raise AssertionError(
            f"train remat: loss rel {loss_rel:.3e}, gradient {worst} rel-norm "
            f"{worst_rn:.3e} beyond {RNORM['bfloat16']}")
    del g_a, g_r
    torch.cuda.empty_cache()
    return dict(loss=loss_r.item(), loss_no_remat=loss_a.item(), loss_rel_err=loss_rel,
                worst_grad=worst, worst_grad_rel_norm_err=worst_rn,
                max_abs_grad_diff=max_diff, launches=launches,
                peak_gb_above_start=mem_r, peak_gb_above_start_no_remat=mem_a,
                ms=ms_r, ms_no_remat=ms_a)


# ---------------------------------------------------------------------------
# the MoE and video DiT families on one card
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1 config.json: hidden 4096, 32 heads, 8 kv
# heads (head dim 128), intermediate 14336, 8 local experts, 2 a token,
# vocab 32000, rope_theta 1e6, rms_norm_eps 1e-5; depth cut to 2 of 32
MOE_WIDTHS = dict(vocab_size=32000, dim=4096, n_heads=32, n_kv_heads=8, head_dim=128,
                  ffn_hidden=14336, rope_theta=1e6, norm_eps=1e-5, n_experts=8, top_k=2)
# DiT-XL (arXiv:2212.09748, Table 1): hidden 1152, 16 heads (head dim 72),
# MLP 4 x 1152 (the family's SwiGLU hidden), 2 of 28 layers; latents of
# 256 x 256 frames at patch 2: 4 channels x 2 x 2 = in_dim 16, 256 tokens
# a frame; 32 frames = 8192 tokens, every frame seeing all earlier ones
DIT_WIDTHS = dict(dim=1152, n_heads=16, n_kv_heads=16, head_dim=72, ffn_hidden=4608, in_dim=16,
                  tokens_per_frame=256, num_frames=32, window_frames=32)
DIT_CHECK_FRAMES = 8  # the dense twin's (seqlen, seqlen) mask at 2048 tokens
# the small widths of ``cp4_main("cpu")``, the four ranks' rehearsal over gloo
MOE_SMALL = dict(vocab_size=256, dim=64, n_heads=4, n_kv_heads=2, head_dim=16, ffn_hidden=96,
                 n_experts=8, top_k=2)
DIT_SMALL = dict(dim=64, n_heads=2, n_kv_heads=2, head_dim=24, ffn_hidden=128, in_dim=8,
                 tokens_per_frame=64, num_frames=8, window_frames=8)
DIT_TS = (0.25, 0.5, 0.75)  # diffusion times of the three steps
# float32 model-level gates (the MoE through the kernels against the plain
# attention path, and at cp 4 = ep 4 against cp 1): loss rel, gradients
# rel-norm; an H100 reads 0-9e-8 and 5e-6-8e-6 there
F32_LOSS_RTOL, F32_GRAD_RNORM = 1e-5, 1e-4


def moe_config(on_card: bool, **kw):
    from magiattention_tpu_torch.models.moe import MoEConfig

    widths = MOE_WIDTHS if on_card else MOE_SMALL
    return MoEConfig(**{**widths, "n_layers": TRAIN_LAYERS, "dtype": "bfloat16", **kw})


def dit_config(on_card: bool, **kw):
    from magiattention_tpu_torch.models.video_dit import VideoDiTConfig

    widths = DIT_WIDTHS if on_card else DIT_SMALL
    return VideoDiTConfig(**{**widths, "n_layers": TRAIN_LAYERS, "dtype": "bfloat16", **kw})


def next_token_labels(tok, doc: int):
    """Next token; -100 (ignored) at each document's end."""
    import torch

    labels = torch.roll(tok, -1).clone()
    labels[doc - 1 :: doc] = -100
    return labels


def grads_rel_norm(names, got, want) -> tuple[str, float, dict]:
    """(the worst name, its rel-norm error, every rel-norm error)."""
    rn = {
        n: ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()
        for n, a, b in zip(names, got, want)
    }
    worst = max(rn, key=rn.get)
    return worst, rn[worst], rn


def step_launches(what: str, launches: dict, n_layers: int) -> str:
    """The FFA launches of one training step: B1 and B7 once per layer, and
    one backward mode's kernels once per layer (fused B8/B9, or split B3 +
    B5/B6), no packed kernel and no plain version. Returns the mode."""
    from magiattention_tpu_torch.kernels import PLAIN_NAMES

    mode = "fused" if launches.get("ffa_bwd_fused") else "split"
    want = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels(mode))
    others = set(FFA_KERNELS) - set(want)
    if any(launches.get(k, 0) != n_layers for k in want) or any(launches.get(k) for k in others):
        raise AssertionError(f"{what}: launched {launches}, want {n_layers} of each of {want}")
    if any(launches.get(k) for k in PLAIN_NAMES):
        raise AssertionError(f"{what}: a plain version ran on the card: {launches}")
    return mode


def timed_steps(what: str, step, n: int, tokens: int, n_layers: int):
    """``n`` calls of ``step(i)`` (returning a loss tensor), each timed on
    the host clock around a synchronize, its FFA launches asserted
    (:func:`step_launches`). Returns (records, launches summed, mode)."""
    import torch

    from magiattention_tpu_torch.kernels import launch_counts

    recs, total, mode = [], {}, None
    for i in range(n):
        before = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = step(i).item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if not np.isfinite(loss):
            raise AssertionError(f"{what}: step {i} loss {loss} is not finite")
        mode = step_launches(f"{what} step {i}", launches, n_layers)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        recs.append(dict(step=i, loss=loss, ms=ms, tokens_per_s=tokens / (ms * 1e-3)))
        emit({"phase": f"{what}_step", **recs[-1], "launches": launches})
    return recs, total, mode


def route_picks(fn):
    """``fn()``'s result and the top-k expert picks of each ``moe._route``
    call it made (one ``(S, K)`` tensor a layer, in call order)."""
    from magiattention_tpu_torch.models import moe

    picks, route = [], moe._route

    def recording(h32, router_w, cfg):
        picks.append(moe._top_k(h32 @ router_w, cfg.top_k)[1])
        return route(h32, router_w, cfg)

    moe._route = recording
    try:
        return fn(), picks
    finally:
        moe._route = route


def moe_phase() -> dict:
    """``models.moe`` at Mixtral-8x7B's widths (2 of 32 layers, bf16 over
    float32 masters, seed 0) on ``TRAIN_SEQ`` tokens in two causal
    documents at cp 1, no EP, capacity factor 1.25: three
    ``moe_train_step``s (finite losses; one B1, B7 and B8/B9 a layer a
    step, no plain version), step ms and tokens/s after the first, one step
    under ``torch.profiler`` (device ms by kernel family). Gates, on the
    seed-0 weights before the steps (whose dq atomics would move the
    weights, and so near-tied picks, from run to run): the routed FFN of
    one full-width layer against ``moe_ffn_reference`` at capacity factor
    8 on ``CHECK_SEQ`` rows in float32 and bf16; and the model's loss and
    gradients through the kernels against the plain attention path
    (``MAGI_ATTENTION_KERNEL_BACKEND=sdpa``) at ``CHECK_SEQ`` tokens, each
    layer's count of (token, choice) expert picks that differ between the
    two runs reported: in float32 no pick may move, loss and gradients at
    ``F32_LOSS_RTOL`` and ``F32_GRAD_RNORM``; in bf16 the loss at the
    train gate, the gradients at the train gates only where no pick moved
    (routing is a step function of the hidden state, and a pick moved by
    the two attention paths' bf16 roundings changes the gradients by more
    than a rounding)."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels import reset_launch_counts
    from magiattention_tpu_torch.models import moe

    device, seq, check_seq = "cuda", TRAIN_SEQ, CHECK_SEQ
    cfg = moe_config(True)
    t0 = time.perf_counter()
    params = moe.init_moe_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (seq,), generator=gen, device=device)
    labels = next_token_labels(tokens, seq // 2)
    docs = _docs(seq, seq // 2)
    key = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, device=device)
    n_params = sum(p.numel() for p in moe.LAYOUT.leaves(params))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the routed FFN of one full-width layer against the dense reference
    lyr = params["layers"][0]
    h = torch.randn((check_seq, cfg.dim), generator=gen, device=device)
    ffn = {}
    for dname in ("float32", "bfloat16"):
        c8 = dataclasses.replace(cfg, capacity_factor=8.0, dtype=dname)
        hd = h.to(getattr(torch, dname))
        with torch.no_grad():
            y, _ = moe.moe_ffn(hd, lyr, c8)
            ref = moe.moe_ffn_reference(hd, lyr, c8)
        ffn[dname] = scaled_check(f"moe ffn {dname}", y.float(), ref.float(), dname)
    del h, y, ref

    # the model through the kernels against the plain attention path
    tok2 = tokens[:check_seq]
    lab2 = next_token_labels(tok2, check_seq // 2)
    docs2 = _docs(check_seq, check_seq // 2)
    names = moe.LAYOUT.names(params)
    gates = {"float32": (F32_LOSS_RTOL, F32_GRAD_RNORM),
             "bfloat16": (TRAIN_LOSS_RTOL, TRAIN_GRAD_RNORM)}
    check = {}
    for dname, (loss_gate, grad_gate) in gates.items():
        c = dataclasses.replace(cfg, dtype=dname)
        key_k = api.magi_attn_flex_key(docs2, docs2, [1, 1], check_seq, check_seq, device=device)
        (loss_k, g_k), picks_k = route_picks(
            lambda: moe.moe_value_and_grad(params, c, tok2, lab2, key_k))
        with scoped_env({"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa"}):
            key_p = api.magi_attn_flex_key(docs2, docs2, [1, 1], check_seq, check_seq,
                                           device=device)
            (loss_p, g_p), picks_p = route_picks(
                lambda: moe.moe_value_and_grad(params, c, tok2, lab2, key_p))
        moved = [int((a != b).sum().item()) for a, b in zip(picks_k, picks_p)]
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        worst, worst_rn, rn = grads_rel_norm(names, g_k, g_p)
        grads_gated = dname == "float32" or not any(moved)
        ok = loss_rel <= loss_gate and (worst_rn <= grad_gate or not grads_gated)
        check[dname] = dict(loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
                            loss_rel_err=loss_rel, loss_gate=loss_gate, worst_grad=worst,
                            worst_grad_rel_norm_err=worst_rn, grad_gate=grad_gate,
                            grads_beyond_gate=sum(v > grad_gate for v in rn.values()),
                            picks_moved_by_layer=moved, picks_a_layer=picks_k[0].numel(),
                            grads_gated=grads_gated)
        if not ok or (dname == "float32" and any(moved)):
            raise AssertionError(
                f"moe {dname}: kernels vs plain loss rel {loss_rel:.3e}, worst gradient {worst} "
                f"rel-norm {worst_rn:.3e} beyond {loss_gate}, {grad_gate} "
                f"(expert picks moved by layer {moved})")
        del g_k, g_p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step(i):
        return moe.moe_train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR)[1]

    reset_launch_counts()
    steps, launches, mode = timed_steps("moe", step, TRAIN_STEPS, seq, cfg.n_layers)
    if mode != "fused":
        raise AssertionError(f"moe: the unpinned backward resolved {mode}, want fused")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_run(lambda: step(0))

    res = dict(
        model=("Mixtral-8x7B widths (mistralai/Mixtral-8x7B-v0.1 config.json: hidden 4096, "
               "32/8 heads, head_dim 128, intermediate 14336, 8 experts top-2, vocab 32000, "
               f"rope_theta 1e6), {cfg.n_layers} of 32 layers, bf16 over float32 masters, "
               "seed 0, aux_loss_coef 0.01"),
        params=n_params, tokens=seq, documents=2, capacity_factor=cfg.capacity_factor,
        attention="api: magi_attn_flex_key (cp 1) -> dispatch -> calc_attn per layer",
        bwd_mode=mode, setup_s=setup_s, steps=steps, losses=[r["loss"] for r in steps],
        step_ms_after_first=[r["ms"] for r in steps[1:]],
        tokens_per_s_after_first=[r["tokens_per_s"] for r in steps[1:]],
        launches=launches, peak_memory_gb=peak_gb, profile_step=prof,
        ffn_vs_reference=dict(tokens=check_seq, capacity_factor=8.0, **ffn),
        check=dict(tokens=check_seq, **check),
    )
    emit({"phase": "moe", **res})
    del params
    torch.cuda.empty_cache()
    return res


def video_dit_phase() -> dict:
    """``models.video_dit`` at DiT-XL's transformer widths (2 of 28
    layers, head dim 72 through ``kernels/head_dims.py``'s padding to the
    128-wide instances, bf16 over float32 masters, seed 0) on 32 frames of
    256 tokens under the Magi-1 block-causal mask (``window_frames`` 32)
    at cp 1: three AdamW steps through ``make_optim_train_step`` (finite
    losses; B1, B7 and one backward mode a layer a step), step ms,
    tokens/s, one step under ``torch.profiler``; loss and gradients
    against ``loss_fn_dense`` (dense float32 attention over the boolean
    mask) at 8 frames, in the train gates."""
    import torch

    from magiattention_tpu_torch.kernels import reset_launch_counts
    from magiattention_tpu_torch.kernels.head_dims import kernel_head_dim
    from magiattention_tpu_torch.models import video_dit
    from magiattention_tpu_torch.models.llama import tree_value_and_grad

    device = "cuda"
    cfg = dit_config(True)
    width = kernel_head_dim(cfg.head_dim)
    if width != 128:
        raise AssertionError(f"video_dit: head dim {cfg.head_dim} runs at {width}, want 128")
    t0 = time.perf_counter()
    params = video_dit.init_params(cfg, seed=0, device=device)
    key = video_dit.make_video_attn_key(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    clean, noise = (torch.randn((cfg.seqlen, cfg.in_dim), generator=gen, device=device)
                    for _ in range(2))
    optim = torch.optim.AdamW(video_dit.param_list(params), lr=TRAIN_LR)
    step_fn = video_dit.make_optim_train_step(cfg, key, optim)
    setup_s = time.perf_counter() - t0

    def step(i):
        return step_fn(params, clean, noise, DIT_TS[i % len(DIT_TS)])[1]

    reset_launch_counts()
    steps, launches, mode = timed_steps("video_dit", step, TRAIN_STEPS, cfg.seqlen, cfg.n_layers)
    prof = profile_run(lambda: step(0))

    # against the dense twin at fewer frames
    c8 = dataclasses.replace(cfg, num_frames=DIT_CHECK_FRAMES)
    p8 = video_dit.init_params(c8, seed=1, device=device)
    clean8, noise8 = clean[:c8.seqlen], noise[:c8.seqlen]
    key8 = video_dit.make_video_attn_key(c8, device=device)
    loss_k, g_k = video_dit.value_and_grad(p8, c8, clean8, noise8, DIT_TS[0], key8)
    mask = torch.from_numpy(video_dit.dense_video_mask(c8)).to(device)
    loss_d, g_d = tree_value_and_grad(
        lambda live: video_dit.loss_fn_dense(live, c8, clean8, noise8, DIT_TS[0], mask), p8,
        video_dit.LAYOUT)
    loss_rel = abs(loss_k.item() - loss_d.item()) / abs(loss_d.item())
    worst, worst_rn, _ = grads_rel_norm(video_dit.param_names(p8), g_k, g_d)
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst_rn <= TRAIN_GRAD_RNORM):
        raise AssertionError(
            f"video_dit: CP vs dense loss rel {loss_rel:.3e}, worst gradient {worst} rel-norm "
            f"{worst_rn:.3e} beyond {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_RNORM}")
    del g_k, g_d, p8, mask
    res = dict(
        model=("DiT-XL transformer widths (arXiv:2212.09748 Table 1: hidden 1152, 16 heads, "
               "head_dim 72, MLP 4608 as the SwiGLU hidden), 2 of 28 layers, bf16 over float32 "
               "masters, seed 0"),
        frames=cfg.num_frames, tokens_per_frame=cfg.tokens_per_frame, tokens=cfg.seqlen,
        window_frames=cfg.window_frames, head_dim=cfg.head_dim, kernel_head_dim=width,
        optimizer="torch.optim.AdamW lr 1e-4", bwd_mode=mode, setup_s=setup_s, steps=steps,
        losses=[r["loss"] for r in steps],
        step_ms_after_first=[r["ms"] for r in steps[1:]],
        tokens_per_s_after_first=[r["tokens_per_s"] for r in steps[1:]],
        launches=launches, profile_step=prof,
        check=dict(frames=c8.num_frames, tokens=c8.seqlen, loss_cp=loss_k.item(),
                   loss_dense=loss_d.item(), loss_rel_err=loss_rel, worst_grad=worst,
                   worst_grad_rel_norm_err=worst_rn, loss_rtol=TRAIN_LOSS_RTOL,
                   grad_rnorm=TRAIN_GRAD_RNORM),
    )
    emit({"phase": "video_dit", **res})
    del params, optim
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# NSA: the block-sparse kernels (B13, B14) and nsa_attn over them
# ---------------------------------------------------------------------------

BSP_L_SLC, BSP_BQ = 64, 16
# (name, g, head_dim, dtype, d_stride, seq, hk, top_k): g 1, 2, 4, 8; head
# dims 64, 128, 256; float32, bf16; d_stride 16, 32 at l_slc 64, so the clustered
# picks of bsp_table overlap and put duplicate chunks in a row; the last is
# the nsa phase's shape (Llama-3.1-8B heads, the NSA paper's settings)
BSP_CASES = (
    ("g1_d64_f32_ds16", 1, 64, "float32", 16, 2048, 2, 4),
    ("g4_d128_f32_ds32", 4, 128, "float32", 32, 2048, 2, 4),
    ("g8_d64_bf16_ds32", 8, 64, "bfloat16", 32, 2048, 2, 4),
    ("g8_d128_bf16_ds16", 8, 128, "bfloat16", 16, 2048, 2, 4),
    ("g1_d128_bf16_ds16", 1, 128, "bfloat16", 16, 2048, 4, 4),
    ("g4_d64_f32_ds16", 4, 64, "float32", 16, 2048, 2, 4),
    ("slice_g4_d128_bf16_ds16", 4, 128, "bfloat16", 16, 8192, 8, 16),
    # the 256 instances at the slice shape's sequence and Gemma-2-9B's
    # heads (16 / 8, head_dim 256)
    ("slice_g2_d256_bf16_ds16", 2, 256, "bfloat16", 16, 8192, 8, 16),
    ("g2_d256_f32_ds16", 2, 256, "float32", 16, 2048, 2, 4),
)


def bsp_table(gen, seq: int, hk: int, top_k: int, ds: int):
    """A top-k block table over the stride-``ds`` blocks of one sequence,
    clustered as NSA's selections are: each row picks ``top_k`` distinct
    blocks among ``2 * top_k`` consecutive ones, so neighbouring picks
    overlap. Returns (block_idx (hk, n_qb, top_k) on the card, starts)."""
    import torch

    starts = np.arange(0, seq - BSP_L_SLC + 1, ds, dtype=np.int32)
    n_qb = seq // BSP_BQ
    base = torch.randint(
        0, len(starts) - 2 * top_k + 1, (hk, n_qb, 1), generator=gen, device="cuda"
    )
    offs = torch.rand((hk, n_qb, 2 * top_k), generator=gen, device="cuda").argsort(-1)
    return base + offs[..., :top_k], starts


def build_report(name: str) -> list[str]:
    """The ``ptxas -v`` register and spill lines of one kernel library."""
    from magiattention_tpu_torch.kernels import _build

    log = _build.library_path(name).with_suffix(".log")
    return [
        line.strip() for line in log.read_text().splitlines()
        if "registers" in line or "spill" in line
    ] if log.exists() else []


# the libraries whose bf16 entries run on the tensor cores; every such
# kernel's name carries TC_TAG (csrc/ffa_fwd_tc.cuh, csrc/ffa_bwd_dq_tc.cuh,
# csrc/bwd_kv_tc.cuh), and the float32 forward's (3xTF32,
# csrc/ffa_fwd_tf32.cuh) TF32_TAG
TC_LIBRARIES = (
    "ffa_fwd", "ffa_fwd_gqa", "ffa_bwd_dq", "ffa_bwd_dq_gqa", "ffa_bwd_dkv", "ffa_bwd_fused",
)
TC_TAG = "_tc_kernel"
TF32_TAG = "_tf32_kernel"
# the split backward's libraries: the deterministic mode, no atomics
SPLIT_LIBRARIES = ("ffa_bwd_dq", "ffa_bwd_dq_gqa", "ffa_bwd_dkv")
# SASS opcodes of global and shared-memory atomics and reductions
ATOMIC_OPS = ("RED", "REDG", "REDAS", "ATOM", "ATOMG", "ATOMS")
# the NSA libraries and their tensor-core (bf16) instances at d 64, 128 and
# 256: B13's forward, B14's dq and dk/dv walks (csrc/block_sparse_tc.cuh);
# their float32 instances run on the CUDA cores
BSP_TC_INSTANCES = {"block_sparse_fwd": 3, "block_sparse_bwd": 6}


def kernel_label(mangled: str) -> str:
    """``ffa_fwd_tc_kernel<128,1>`` from a kernel's mangled name (its name
    and template arguments: integers, float, bf16, int8): the nested
    name's length-prefixed parts are read in turn, the last one ending in
    ``_kernel`` is the name."""
    import re

    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else None
    if i is None:
        return mangled
    name = None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if name is None or not name.endswith("_kernel"):
        return mangled
    m = re.match(r"I(.*?)EEv", mangled[i:])
    if not m:
        return name
    args = re.findall(r"Li(\d+)E|(f)|(13__nv_bfloat16)|(a)|Lb(\d)E", m.group(1) + "E")
    parts = [n or ("float" if f else "bf16" if b else "int8" if a else c) for n, f, b, a, c in args]
    return f"{name}<{','.join(parts)}>"


def ptxas_report(name: str) -> dict[str, dict]:
    """Per kernel of one library (by :func:`kernel_label`), what its
    ``ptxas -v`` log says: registers and spill bytes."""
    import re

    from magiattention_tpu_torch.kernels import _build

    report, fn = {}, None
    for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernel_label(m.group(1))
            report[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            report[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
    return report


def cuobjdump() -> str:
    """The CUDA toolkit's ``cuobjdump``, else the copy in Triton's package."""
    import os
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    import triton

    return os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin", "cuobjdump")


def sass_counts(name: str) -> dict[str, dict]:
    """Per kernel of one library (by :func:`kernel_label`), its HGMMA
    (wgmma), HMMA (mma.sync), atomic (:data:`ATOMIC_OPS`, by opcode) and
    LDGSTS (cp.async) instructions in the SASS."""
    import re

    from magiattention_tpu_torch.kernels import _build

    out = subprocess.run(
        [cuobjdump(), "-sass", str(_build.library_path(name))],
        check=True, capture_output=True, text=True, timeout=300,
    ).stdout
    # "/*0a70*/  @!P0 REDG.E.ADD.F32x4... ;": the opcode after an optional
    # predicate
    instr = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = kernel_label(line.split("Function :")[1].strip())
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "atomics": 0, "LDGSTS": 0}
            continue
        m = instr.search(line) if fn else None
        if not m:
            continue
        op = m.group(1)
        if op == "HGMMA":
            counts[fn]["HGMMA"] += 1
        elif op == "HMMA":
            counts[fn]["HMMA"] += 1
        elif op in ATOMIC_OPS:
            counts[fn]["atomics"] += 1
        elif op == "LDGSTS":
            counts[fn]["LDGSTS"] += 1
    return counts


def tensor_core_phase() -> dict[str, dict]:
    """Proof that every bf16 FFA kernel (B1/B2, B3/B4, B5/B6, B8/B9), the
    float32 forward (B1/B2, 3xTF32) and the bf16 NSA kernels (B13, B14's
    two walks) run on the tensor cores: per
    library, the HGMMA, HMMA and atomic counts of each kernel's SASS, and
    beside each tensor-core instance its registers, spills and dynamic
    shared memory (the library's own ``<name>_smem_bytes``, held equal to
    the Python figure the guards use). Fails if a library has no
    tensor-core kernel, if one has no HGMMA or any HMMA, if one spills, if
    the two shared-memory figures differ, or if a bf16 instance of a split
    library (the deterministic mode) has an atomic; the fused kernel's bf16
    instance must show its dq atomics, which proves the count reads the
    SASS. The NSA libraries: every bf16 instance HGMMA and no HMMA, no
    instance spills, and none of B14's (either dtype) has an atomic."""
    import re

    from magiattention_tpu_torch.kernels import ffa as kffa

    guards = {  # library -> the guard's figure of (d, heads, itemsize, bq, bk)
        "ffa_fwd": lambda d, g, isz, bq, bk: kffa.fwd_pack_smem_bytes(d, 1, isz, bq, bk),
        "ffa_fwd_gqa": lambda d, g, isz, bq, bk: kffa.fwd_pack_smem_bytes(d, g, isz, bq, bk),
        "ffa_bwd_dq": lambda d, g, isz, bq, bk: kffa.dq_pack_smem_bytes(d, 1, isz, bq, bk),
        "ffa_bwd_dq_gqa": lambda d, g, isz, bq, bk: kffa.dq_pack_smem_bytes(d, g, isz, bq, bk),
        "ffa_bwd_dkv": lambda d, g, isz, bq, bk: kffa.dkv_smem_bytes(d, isz, bq, bk),
        "ffa_bwd_fused": lambda d, g, isz, bq, bk: kffa.fused_bwd_smem_bytes(d, isz, bq, bk),
    }
    results = {}
    for lib in TC_LIBRARIES:
        sass, ptxas = sass_counts(lib), ptxas_report(lib)
        query = getattr(kffa._lib(lib), f"{lib}_smem_bytes")
        tc = {}
        for fn, n in sass.items():
            if TC_TAG not in fn and TF32_TAG not in fn:
                continue
            # template <D, G (heads a CTA) or FUSED, BQ, BK>
            d_, g_, bq_, bk_ = [int(x) for x in re.findall(r"\d+", fn.split("<")[1])]
            bf16 = TC_TAG in fn
            packed = lib.endswith("_gqa")
            smem = (query(d_, g_, bq_, bk_, int(bf16)) if packed
                    else query(d_, bq_, bk_, int(bf16)))
            want = guards[lib](d_, g_ if packed else 1, 2 if bf16 else 4, bq_, bk_)
            if smem != want:
                raise AssertionError(f"{lib}: {fn} shared memory {smem} != guard's {want}")
            tc[fn] = dict(**n, **ptxas.get(fn, {}), smem_bytes=smem)
        row = dict(
            library=lib,
            hgmma=sum(n["HGMMA"] for n in sass.values()),
            hmma=sum(n["HMMA"] for n in sass.values()),
            atomics=sum(n["atomics"] for n in sass.values()),
            tensor_core_kernels=tc,
            cuda_core_kernels={fn: n for fn, n in sass.items() if fn not in tc},
        )
        emit({"phase": "tensor_cores", **row})
        if not tc:
            raise AssertionError(f"{lib}: no tensor-core kernel in the library")
        for fn, r in tc.items():
            if r["HGMMA"] == 0 or r["HMMA"]:
                raise AssertionError(f"{lib}: {fn} has no HGMMA or has HMMA: {r}")
            if r.get("spill_stores", 1) or r.get("spill_loads", 1):
                raise AssertionError(f"{lib}: {fn} spills (or has no ptxas report): {r}")
            if lib in SPLIT_LIBRARIES and r["atomics"]:
                raise AssertionError(f"{lib}: {fn} (deterministic mode) has atomics: {r}")
            if lib == "ffa_bwd_fused" and not r["atomics"]:
                raise AssertionError(f"{lib}: {fn} shows no atomics: the SASS count is wrong")
        if lib.startswith("ffa_fwd") and not any(TF32_TAG in fn for fn in tc):
            raise AssertionError(f"{lib}: no float32 (3xTF32) tensor-core kernel: {list(tc)}")
        results[lib] = row
    for lib, n_tc in BSP_TC_INSTANCES.items():  # B13, B14
        sass, ptxas = sass_counts(lib), ptxas_report(lib)
        every = {fn: dict(**n, **ptxas.get(fn, {})) for fn, n in sass.items()}
        tc = {fn: r for fn, r in every.items() if TC_TAG in fn}
        row = dict(
            library=lib,
            hgmma=sum(r["HGMMA"] for r in every.values()),
            hmma=sum(r["HMMA"] for r in every.values()),
            atomics=sum(r["atomics"] for r in every.values()),
            tensor_core_kernels=tc,
            cuda_core_kernels={fn: r for fn, r in every.items() if fn not in tc},
        )
        emit({"phase": "tensor_cores", **row})
        if len(tc) != n_tc:
            raise AssertionError(f"{lib}: {len(tc)} tensor-core instances, want {n_tc}: {list(every)}")
        for fn, r in every.items():
            if fn in tc and (r["HGMMA"] == 0 or r["HMMA"]):
                raise AssertionError(f"{lib}: {fn} has no HGMMA or has HMMA: {r}")
            if r.get("spill_stores", 1) or r.get("spill_loads", 1):
                raise AssertionError(f"{lib}: {fn} spills (or has no ptxas report): {r}")
            if lib == "block_sparse_bwd" and r["atomics"]:
                raise AssertionError(f"{lib}: {fn} has atomics: {r}")
        results[lib] = row
    return results


def block_sparse_phase(peaks: dict) -> dict[str, dict]:
    """B13 and B14 against their plain versions on the same chunk tables
    (``block_sparse_fwd_plain`` / ``block_sparse_bwd_plain``: a gathered
    dense softmax, duplicate chunks counted twice), the backward on the
    kernel forward's lse and the same delta, run twice and equal to the bit
    (dq, dk, dv: no atomics). B14's time is the whole call, and beside it
    each of its two launches (the dq walk, the dk/dv walk) and the key
    table's build. Bounds: 4 flops per (query row, key slot) pair and head
    dim for the forward, 10 for the backward (S, dP, P^T dO, dS^T Q, dS
    K); bytes count q, dO, out, lse, delta and the k/v rows the table
    names, once, and the float32 gradients. No single PyTorch call
    computes the same function (a chunk named twice doubles its keys'
    softmax mass), so library_ms is null."""
    import torch

    from magiattention_tpu_torch.kernels.block_sparse import (
        BSPParams, block_sparse_bwd_dkv_kernel, block_sparse_bwd_dq_kernel,
        block_sparse_bwd_kernel, block_sparse_bwd_plain, block_sparse_fwd_kernel,
        block_sparse_fwd_plain, chunk_table, key_table,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    results = {}
    for name, g, d, dname, ds, seq, hk, top_k in BSP_CASES:
        dt = getattr(torch, dname)
        hq = hk * g
        idx, starts = bsp_table(gen, seq, hk, top_k, ds)
        q = torch.randn((seq, hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((seq, hk, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((seq, hk, d), generator=gen, device="cuda").to(dt)
        do = torch.randn((seq, hq, d), generator=gen, device="cuda").to(dt)
        ctbl = chunk_table(idx, starts, ds, BSP_L_SLC)
        params = BSPParams(softmax_scale=d ** -0.5, d_stride=ds, block_size_q=BSP_BQ)
        out, lse = block_sparse_fwd_kernel(q, k, v, ctbl, params)
        out_p, lse_p = block_sparse_fwd_plain(q, k, v, ctbl, params)
        fwd_err = errors(out, lse, out_p, lse_p)
        check(f"block_sparse {name} fwd", fwd_err, dname)
        del out_p, lse_p
        delta = (out.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, delta, ctbl, params)
        got, want = block_sparse_bwd_kernel(*args), block_sparse_bwd_plain(*args)
        bwd_err = {
            n: grad_check(f"block_sparse {name} {n}", a, b, dname)
            for n, a, b in zip(("dq", "dk", "dv"), got, want)
        }
        again = block_sparse_bwd_kernel(*args)
        for n, a, b in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"block_sparse {name}: two backward runs differ in {n}")
        del got, want, again
        torch.cuda.synchronize()

        n_keys = ctbl.shape[2] * ds
        rows = ctbl.sort(-1).values
        dup = int((rows[..., 1:] == rows[..., :-1]).sum().item())  # chunks named twice
        heads = torch.arange(hk, device="cuda")[:, None, None] * (seq // ds)
        kv_rows = torch.unique(ctbl.long() + heads).numel() * ds  # (head, key) rows read
        isz = q.element_size()
        pairs = seq * hq * n_keys
        q_bytes, kv_bytes, row_bytes = q.numel() * isz, kv_rows * d * isz, seq * hq * 4
        fwd_b = bound(4.0 * pairs * d, 2 * q_bytes + 2 * kv_bytes + row_bytes, dname, peaks)
        bwd_b = bound(
            10.0 * pairs * d,
            2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + (q.numel() + 2 * k.numel()) * 4,
            dname, peaks,
        )
        samples = 3 if seq > 4096 else 10
        ktbl = key_table(ctbl, seq, ds)
        visits = ktbl.ptr[1:] - ktbl.ptr[:-1]
        ms_f = time_ms(lambda: block_sparse_fwd_kernel(q, k, v, ctbl, params))
        ms_b = time_ms(lambda: block_sparse_bwd_kernel(*args))
        res = dict(
            case=name, dtype=dname, q=list(q.shape), kv=list(k.shape), g=g,
            d_stride=ds, l_slc=BSP_L_SLC, block_size_q=BSP_BQ, top_k=top_k,
            chunks_per_row=ctbl.shape[2], keys_per_row=n_keys,
            duplicate_chunk_entries=dup, pairs=pairs,
            key_tiles=ktbl.order.numel(), key_table_visits=int(visits.sum().item()),
            most_visits_a_tile=int(visits.max().item()),
            atol=ATOL[dname], rnorm=RNORM[dname],
            block_sparse_fwd=dict(
                **fwd_err, ms=ms_f,
                plain_ms=time_ms(lambda: block_sparse_fwd_plain(q, k, v, ctbl, params),
                                 warmup=1, samples=samples),
                bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None,
                tflops=4.0 * pairs * d / (ms_f * 1e-3) / 1e12,
            ),
            block_sparse_bwd=dict(
                max_abs_err=max(e["max_abs_err"] for e in bwd_err.values()),
                errors=bwd_err, ms=ms_b, bitwise_repeat=True,
                dq_walk_ms=time_ms(lambda: block_sparse_bwd_dq_kernel(*args)),
                key_table_ms=time_ms(lambda: key_table(ctbl, seq, ds)),
                dkv_walk_ms=time_ms(
                    lambda: block_sparse_bwd_dkv_kernel(q, k, v, do, lse, delta, ktbl, params)
                ),
                plain_ms=time_ms(lambda: block_sparse_bwd_plain(*args), warmup=1,
                                 samples=samples),
                bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None,
                tflops=10.0 * pairs * d / (ms_b * 1e-3) / 1e12,
            ),
        )
        if name.startswith("slice"):
            res["ptxas"] = {n: build_report(n) for n in ("block_sparse_fwd", "block_sparse_bwd")}
        emit({"phase": "block_sparse", **res})
        results[name] = res
        del q, k, v, do, out, lse, delta, args, ktbl
        torch.cuda.empty_cache()
    return results


def sum_check(name: str, got, want, dtype: str) -> dict:
    """Max abs and rel-norm error of a result that is a sum over the
    sequence (NSA's outputs and gradients, returned in bf16 where the
    inputs are): rel-norm within the dtype's bound and max abs within its
    atol times the largest magnitude (at least 1), since one bf16 ulp of a
    gradient of size 4 is already 0.03."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: not finite")
    a, b = got.double(), want.double()
    scale = max(1.0, b.abs().max().item())
    err = {
        "max_abs_err": (a - b).abs().max().item(),
        "rel_norm_err": ((a - b).norm() / b.norm().clamp_min(1e-30)).item(),
        "max_abs_want": scale,
    }
    atol, rnorm = ATOL[dtype] * scale, RNORM[dtype]
    if not (err["max_abs_err"] <= atol and err["rel_norm_err"] <= rnorm):
        raise AssertionError(f"{name}: {err} beyond atol {atol}, rel-norm {rnorm}")
    return err


# the slice's NSA: Llama-3.1-8B attention widths, two causal documents of
# 4096, the NSA paper's sparse settings (Yuan et al., arXiv:2502.11089, §4)
NSA_SEQ, NSA_DOC, NSA_HQ, NSA_HK, NSA_D = 8192, 4096, 32, 8, 128
NSA_KW = dict(
    l_cmp=32, l_slc=64, d_stride=16, block_size_q=16, slc_top_k=16,
    window=(512, 0), causal=True,
)
NSA_GATHERED = {"MAGI_ATTENTION_BACKEND_NSA_SLC": "gathered_dense"}


def nsa_phase() -> dict:
    """``nsa_attn`` forward and backward at the slice's configuration
    (bf16 q/k/v, float32 parameters from a seed), gradients to q, k, v and
    the six parameters: the kernel route (unpinned: B13 and B14's two
    walks for the slc branch, B1, B7 and the resolved FFA backward for the
    win branch; the
    counts zeroed just before and read just after, no plain version)
    against the gathered route (MAGI_ATTENTION_BACKEND_NSA_SLC=
    gathered_dense) on the same inputs: the selection tables equal first,
    then out and every gradient within the bf16 bounds (``sum_check``).
    Then the same at float32 over 2048 tokens (two documents of 1024)
    within the float32 bounds. Reports both routes' fwd+bwd ms and the
    kernel route's device time by kernel (``torch.profiler``)."""
    import torch

    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode, plan_params
    from magiattention_tpu_torch.parallel.nsa import PARAM_NAMES, init_nsa_params, nsa_attn

    def case(seq, doc, dtype, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn((seq, NSA_HQ, NSA_D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((seq, NSA_HK, NSA_D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((seq, NSA_HK, NSA_D), generator=gen, device="cuda").to(dtype)
        params = init_nsa_params(gen, NSA_D, NSA_KW["l_cmp"], device="cuda")
        do = torch.randn((seq, NSA_HQ, NSA_D), generator=gen, device="cuda")
        cu = list(range(0, seq + 1, doc))

        def fwd_bwd(env=None):
            with scoped_env(env or {}):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                ps = {n: params[n].detach().requires_grad_(True) for n in PARAM_NAMES}
                out, idx = nsa_attn(*leaves, ps, cu, return_selection=True, **NSA_KW)
                grads = torch.autograd.grad(out, [*leaves, *ps.values()], do.to(out.dtype))
            return out, idx, grads

        return fwd_bwd, cu

    def compare(what, got, want, dname):
        if not torch.equal(got[1], want[1]):
            rows = (got[1] != want[1]).any(-1).nonzero()[:4].tolist()
            raise AssertionError(f"{what}: the routes selected other blocks at {rows}")
        names = ("out", "dq", "dk", "dv", *PARAM_NAMES)
        return {
            n: sum_check(f"{what} {n}", a, b, dname)
            for n, a, b in zip(names, (got[0], *got[2]), (want[0], *want[2]))
        }

    fwd_bwd, cu = case(NSA_SEQ, NSA_DOC, torch.bfloat16, 21)
    qr = np.array([[a, b] for a, b in zip(cu[:-1], cu[1:])], np.int32)
    n_seg = len(qr)
    plan, params = plan_params(
        qr, qr, None, np.full(n_seg, -NSA_KW["window"][0], np.int32),
        np.zeros(n_seg, np.int32), NSA_SEQ, NSA_SEQ, NSA_D, None, 0.0,
    )
    mode = ffa_bwd_mode(plan, params, NSA_D, NSA_D, 2, NSA_HQ, NSA_HK)
    torch.cuda.synchronize()
    reset_launch_counts()
    got = fwd_bwd()
    torch.cuda.synchronize()
    counts = launch_counts()
    want_counts = {
        "block_sparse_fwd": 1, "block_sparse_bwd_dq": 1, "block_sparse_bwd_dkv": 1,
        "ffa_fwd": 1, "ffa_bwd_delta": 1,
        **({"ffa_bwd_fused": 1} if mode == "fused" else {"ffa_bwd_dq": 1, "ffa_bwd_dkv": 1}),
    }
    launched = {k: v for k, v in counts.items() if v}
    if launched != want_counts or any(counts[k] for k in PLAIN_NAMES):
        raise AssertionError(f"nsa: launched {launched}, want {want_counts}")
    reset_launch_counts()
    want = fwd_bwd(NSA_GATHERED)
    gathered_counts = {k: v for k, v in launch_counts().items() if v}
    if any(n.startswith("block_sparse") for n in gathered_counts):
        raise AssertionError(f"nsa: the gathered route launched {gathered_counts}")
    err = compare("nsa bf16", got, want, "bfloat16")
    sel = got[1]
    del got, want
    res = dict(
        shape=(
            f"bf16 q [{NSA_SEQ}, {NSA_HQ}, {NSA_D}], k/v [{NSA_SEQ}, {NSA_HK}, "
            f"{NSA_D}], documents of {NSA_DOC}; float32 parameters"
        ),
        settings=NSA_KW, resolved_win_bwd_mode=mode, launches=launched,
        gathered_route_launches=gathered_counts,
        selection_shape=list(sel.shape), vs_gathered=err,
        fwd_bwd_ms=time_ms(fwd_bwd, warmup=1, samples=3),
        gathered_fwd_bwd_ms=time_ms(lambda: fwd_bwd(NSA_GATHERED), warmup=1, samples=3),
        profile=profile_run(fwd_bwd),
        atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"],
    )
    torch.cuda.empty_cache()

    fwd_bwd, _ = case(2048, 1024, torch.float32, 22)
    res["float32_2048"] = compare("nsa float32", fwd_bwd(), fwd_bwd(NSA_GATHERED), "float32")
    res["float32_atol"], res["float32_rnorm"] = ATOL["float32"], RNORM["float32"]
    emit({"phase": "nsa", **res})
    torch.cuda.empty_cache()
    return res


USP_NSA_R, USP_NSA_U = 2, 2
# b_cmp_k shifts every compressed key of a query's softmax alike: its true
# gradient is 0, so a sum of partials and the whole differ in noise only
NSA_ZERO_GRADS = ("b_cmp_k",)


def usp_nsa_phase() -> dict:
    """``usp_nsa_attn``'s per-rank body on the card at the ``nsa`` phase's
    configuration, (ring 2, ulysses 2) on this one card: for each rank
    (r, u), ``nsa_attn`` over its head subset (16 q / 4 kv heads) and the
    whole sequence (what the all-to-all and the ring all-gather deliver),
    sliced to ring block r, forward and backward. Each rank's rows against
    ``nsa_attn`` on the whole (``sum_check``, bf16), its selection against
    the whole's on its kv heads, and the gradients summed as the
    collectives' adjoints and the trainer's all-reduce sum them (q, k, v
    over ring ranks, the parameters over all four) against the whole's;
    only kernels launch (counts per rank body). Per-rank fwd+bwd ms beside
    the single-device fwd+bwd: every ring rank computes every query of
    its heads (the reference's USPAllGatherNSA), R-fold redundant."""
    import torch

    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.parallel.nsa import PARAM_NAMES, init_nsa_params, nsa_attn

    gen = torch.Generator(device="cuda").manual_seed(23)
    q = torch.randn((NSA_SEQ, NSA_HQ, NSA_D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((NSA_SEQ, NSA_HK, NSA_D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((NSA_SEQ, NSA_HK, NSA_D), generator=gen, device="cuda").to(torch.bfloat16)
    params = init_nsa_params(gen, NSA_D, NSA_KW["l_cmp"], device="cuda")
    do = torch.randn((NSA_SEQ, NSA_HQ, NSA_D), generator=gen, device="cuda").to(torch.bfloat16)
    cu = list(range(0, NSA_SEQ + 1, NSA_DOC))
    blk, hq_u, hk_u = NSA_SEQ // USP_NSA_R, NSA_HQ // USP_NSA_U, NSA_HK // USP_NSA_U

    def fwd_bwd(heads, kv_heads, rows):
        leaves = [x[:, h].detach().contiguous().requires_grad_(True)
                  for x, h in ((q, heads), (k, kv_heads), (v, kv_heads))]
        ps = {n: params[n].detach().requires_grad_(True) for n in PARAM_NAMES}
        out, idx = nsa_attn(*leaves, ps, cu, return_selection=True, **NSA_KW)
        grads = torch.autograd.grad(out[rows], [*leaves, *ps.values()], do[rows][:, heads])
        return out[rows], idx, grads

    whole = slice(0, NSA_SEQ)
    want = fwd_bwd(slice(0, NSA_HQ), slice(0, NSA_HK), whole)
    sums = [torch.zeros(t.shape, device="cuda") for t in (q, k, v)]
    sums += [torch.zeros_like(params[n], dtype=torch.float32) for n in PARAM_NAMES]
    total, ranks = {}, []
    for r in range(USP_NSA_R):
        for u in range(USP_NSA_U):
            heads = slice(u * hq_u, (u + 1) * hq_u)
            kv_heads = slice(u * hk_u, (u + 1) * hk_u)
            rows = slice(r * blk, (r + 1) * blk)
            torch.cuda.synchronize()
            reset_launch_counts()
            out, idx, grads = fwd_bwd(heads, kv_heads, rows)
            torch.cuda.synchronize()
            counts = launch_counts()
            if (any(counts[p] for p in PLAIN_NAMES) or counts["ffa_fwd"] != 1
                    or any(counts[b] != 1 for b in ("block_sparse_fwd", "block_sparse_bwd_dq",
                                                    "block_sparse_bwd_dkv"))):
                raise AssertionError(f"usp_nsa r{r}u{u}: launched {counts}")
            for k_, v_ in counts.items():
                total[k_] = total.get(k_, 0) + v_
            err = sum_check(f"usp_nsa r{r}u{u} out", out, want[0][rows][:, heads], "bfloat16")
            sums[0][:, heads] += grads[0].float()
            sums[1][:, kv_heads] += grads[1].float()
            sums[2][:, kv_heads] += grads[2].float()
            for i in range(len(PARAM_NAMES)):
                sums[3 + i] += grads[3 + i].float()
            ranks.append(dict(
                rank=f"r{r}u{u}", out_max_abs_err=err["max_abs_err"],
                out_rel_norm_err=err["rel_norm_err"],
                selection_rows_differing=int((idx != want[1][kv_heads]).any(-1).sum().item()),
                fwd_bwd_ms=time_ms(lambda: fwd_bwd(heads, kv_heads, rows), warmup=1, samples=3),
            ))
            del out, idx, grads
    names = ("dq", "dk", "dv", *PARAM_NAMES)
    summed = {}
    for n, got, w in zip(names, sums, want[2]):
        if n in NSA_ZERO_GRADS:  # rounding residue on both sides: held absolutely
            summed[n] = {"max_abs": max(got.abs().max().item(), w.abs().max().item())}
            if summed[n]["max_abs"] > ATOL["bfloat16"]:
                raise AssertionError(f"usp_nsa summed {n}: {summed[n]} beyond {ATOL['bfloat16']}")
        else:
            summed[n] = sum_check(f"usp_nsa summed {n}", got, w.float(), "bfloat16")
    ms = [x["fwd_bwd_ms"] for x in ranks]
    res = dict(
        shape=(f"bf16 q [{NSA_SEQ}, {NSA_HQ}, {NSA_D}], k/v [{NSA_SEQ}, {NSA_HK}, {NSA_D}], "
               f"documents of {NSA_DOC}; float32 parameters"),
        settings=NSA_KW, ring=USP_NSA_R, ulysses=USP_NSA_U, ranks=ranks, summed_grads=summed,
        fwd_bwd_ms_min=min(ms), fwd_bwd_ms_max=max(ms),
        single_device_fwd_bwd_ms=time_ms(lambda: fwd_bwd(slice(0, NSA_HQ), slice(0, NSA_HK), whole),
                                         warmup=1, samples=3),
        launches=total, atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"],
    )
    emit({"phase": "usp_nsa", **res})
    torch.cuda.empty_cache()
    return res


def deterministic_phase() -> dict:
    """ROADMAP C1: the backward is bitwise reproducible when asked. Two
    forward + backward runs at the train phase's attention shape through
    ``calc_attn`` at cp 1 under MAGI_ATTENTION_DETERMINISTIC_MODE=1, and
    two through ``flex_flash_attn_func(deterministic=True)``: out, lse,
    dq, dk and dv equal to the bit within each pair, the split kernels
    launched and not the fused one. Reported, not gated: whether the two
    paths agree to the bit, the largest difference between two unpinned
    (fused) runs of ``flex_flash_attn_func``, and the forward + backward
    ms of ``flex_flash_attn_func`` deterministic and unpinned."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.functional import flex_flash_attn_func
    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts

    docs = _docs(CP_SEQ, CP_DOC)
    gen = torch.Generator(device="cuda").manual_seed(13)
    shapes = ((CP_SEQ, CP_HQ, CP_D), (CP_SEQ, CP_HK, CP_D), (CP_SEQ, CP_HK, CP_D))
    inputs = [torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes]
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    det_env = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    with scoped_env(det_env):
        key = api.magi_attn_flex_key(docs, docs, [1, 1], CP_SEQ, CP_SEQ)

    def api_path():
        q, k, v = (t.detach().requires_grad_(True) for t in inputs)
        with scoped_env(det_env):
            out_d, meta = api.calc_attn(
                api.dispatch(q, key), api.dispatch(k, key, role="kv"),
                api.dispatch(v, key, role="kv"), key,
            )
            out = api.undispatch(out_d, key)
            grads = torch.autograd.grad(out, (q, k, v), do)
        return (out, meta.lse, *grads)

    def flex_path(deterministic=True):
        q, k, v = (t.detach().requires_grad_(True) for t in inputs)
        out, meta = flex_flash_attn_func(
            q, k, v, np.array(docs), np.array(docs), np.array([1, 1]),
            deterministic=deterministic,
        )
        return (out, meta.lse, *torch.autograd.grad(out, (q, k, v), do))

    names = ("out", "lse", "dq", "dk", "dv")
    res = {}
    for what, fn in (("calc_attn_env", api_path), ("flex_deterministic", flex_path)):
        torch.cuda.synchronize()
        reset_launch_counts()
        first = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        second = fn()
        differ = [n for n, a, b in zip(names, first, second) if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"deterministic {what}: two runs differ in {differ}")
        if counts.get("ffa_bwd_fused") or not (counts.get("ffa_bwd_dq") or counts.get("ffa_bwd_dq_gqa")):
            raise AssertionError(f"deterministic {what}: launched {counts}, want the split backward")
        res[what] = dict(bitwise_equal=True, launches=counts)
        res[f"{what}_outputs"] = first
    a, b = res.pop("calc_attn_env_outputs"), res.pop("flex_deterministic_outputs")
    # lse stays in the dispatched order on the calc_attn path
    res["paths_bitwise_equal"] = {
        n: torch.equal(x, y) for n, x, y in zip(names, a, b) if n != "lse"
    }
    x, y = flex_path(False), flex_path(False)
    res["unpinned_two_runs_max_abs_diff"] = {
        n: (s.double() - t.double()).abs().max().item()
        for n, s, t in zip(names, x, y) if n != "lse"
    }
    del x, y
    res["fwd_bwd_ms"] = dict(
        deterministic=time_ms(flex_path, samples=5),
        unpinned=time_ms(lambda: flex_path(False), samples=5),
    )
    res["shape"] = f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}, two causal documents"
    emit({"phase": "deterministic", **res})
    return res


def bitwise_rows(what: str, reqs, want: dict) -> None:
    """Every request's generated rows equal ``want[req_id]`` to the bit."""
    for r in reqs:
        a, b = np.stack(r.generated), np.stack(want[r.req_id])
        if a.shape != b.shape or not np.array_equal(a, b):
            i = next((i for i in range(min(len(a), len(b))) if not np.array_equal(a[i], b[i])), None)
            raise AssertionError(f"{what}: request {r.req_id} differs first at row {i}")


SERVE_PIN = {"MAGI_ATTENTION_BACKEND_SERVE_DECODE": "gather_ffa"}


def serve_pinned_phase(ctx: dict) -> dict:
    """ROADMAP C2: the serve phases under MAGI_ATTENTION_BACKEND_SERVE_DECODE=
    gather_ffa, where the engine runs the replay oracle's own calls: every
    row of ``serve``, ``serve_spec`` (greedy and oracle drafts) and
    ``serve_int8`` equal to its replay's to the bit, only B1 launched for
    attention (no decode kernel, no plain version). Reports the oracle
    draft's accept rate and whether every window a request could commit
    was accepted, and (not gated) whether B1's multi-row call equals its
    single-row calls to the bit at the verify geometry."""
    import torch

    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.kernels.paged_kv import paged_attn
    from magiattention_tpu_torch.serving import ServeEngine, oracle_draft_fn, run_reference

    model, base = ctx["model"], ctx["config"]
    res = {}
    with scoped_env(SERVE_PIN):
        for what, config, draft in (
            ("serve", base, None),
            ("serve_spec_greedy", dataclasses.replace(base, spec_tokens=4), None),
            ("serve_spec_oracle", dataclasses.replace(base, spec_tokens=4),
             oracle_draft_fn(ctx["reference"])),
            ("serve_int8", dataclasses.replace(base, kv_dtype="int8"), None),
        ):
            reqs = ctx["requests"](model)
            stats, wall, counts = serve_run(ServeEngine(model, config, draft_fn=draft), reqs)
            check_launches(f"serve_pinned {what}", counts, ("ffa_fwd",))
            decode = {k: counts[k] for k in ("paged_decode", "paged_decode_spec", "paged_decode_int8")}
            if any(decode.values()):
                raise AssertionError(f"serve_pinned {what}: a decode kernel ran: {decode}")
            want = (
                run_reference(model, reqs, config) if config.kv_dtype == "int8"
                else ctx["reference"]
            )
            bitwise_rows(f"serve_pinned {what}", reqs, want)
            att = sum(s["draft_attempted"] for s in stats)
            acc = sum(s["draft_accepted"] for s in stats)
            k = config.spec_tokens
            res[what] = dict(
                wall_s=wall, ticks=len(stats), bitwise_equal_to_replay=True,
                ffa_fwd_launches=counts["ffa_fwd"], draft_attempted=att,
                draft_accepted=acc, accept_rate=acc / att,
                # every draft window accepted <=> no tick beyond ceil(n / k)
                all_windows_accepted=att == k * sum(-(-r.max_new_tokens // k) for r in reqs),
            )
    if not res["serve_spec_oracle"]["all_windows_accepted"]:
        raise AssertionError(f"serve_pinned: the oracle draft was rejected: {res['serve_spec_oracle']}")

    # B1: a verify call's rows against the same rows alone (reported)
    from magiattention_tpu_torch.kernels.paged_kv import PagedKVCache, append_kv, assign_pages

    gen = torch.Generator(device="cuda").manual_seed(5)
    pages = 256
    cache = PagedKVCache.create(pages, 16, 8, 128, 1, pages, dtype=torch.float32, device="cuda")
    cache = assign_pages(cache, 0, np.arange(pages, dtype=np.int32))
    length = 3001
    kv = torch.randn((2, length, 8, 128), generator=gen, device="cuda")
    cache = append_kv(cache, 0, kv[0], kv[1])
    q = torch.randn((4, 32, 128), generator=gen, device="cuda")
    multi, _ = paged_attn(q, cache, 0, q_start=length - 4, max_pages=pages)
    single = torch.cat([
        paged_attn(q[t : t + 1], cache, 0, q_start=length - 4 + t, max_pages=pages)[0]
        for t in range(4)
    ])
    res["b1_multi_row_equals_single_rows"] = bool(torch.equal(multi, single))
    res["b1_multi_row_max_abs_diff"] = (multi - single).abs().max().item()
    emit({"phase": "serve_pinned", **res})
    return res


# ---------------------------------------------------------------------------
# Head dim 256 (ROADMAP C4b): each family's 256 instance, Gemma-2-9B
# attention through the API with a re-keyed window, and a padded train step
# ---------------------------------------------------------------------------

# google/gemma-2-9b's attention: 16 query heads, 8 kv heads, head_dim 256,
# attn_logit_softcapping 50, sliding_window 4096, query_pre_attn_scalar 256
GEMMA_SEQ, GEMMA_HQ, GEMMA_HK, GEMMA_D, GEMMA_SOFTCAP, GEMMA_WINDOW = 8192, 16, 8, 256, 50.0, 4096
BWD_MODE_SLACK = 1.05  # bwd_mode's rule: the model's pick within 5% of the faster


def d256_phase(peaks: dict) -> dict[str, dict]:
    """Every kernel family's 256 instance timed at a main-path shape,
    against its plain version, with its bound: B1 bf16 at Gemma-2-9B's
    attention (q 8192 x 16 x 256, k/v 8192 x 8 x 256, causal, no softcap)
    against SDPA (``is_causal``, ``enable_gqa``), with B2's 256 instance
    (2 heads a CTA) on the same inputs, bit for bit B1's; B1 float32 at the
    serving prefill shape at d 256; the backward at the bf16 shape: B3 (dq)
    + B5 (dk/dv) and B8 (fused), against SDPA's backward alone, and the
    unpinned mode held to ``bwd_mode``'s rule (the faster where the two
    differ by more than 5%); B10 on the decode phase's 8 slots at hq 16,
    hk 8, d 256, float32 and bf16. B13/B14 at d 256 run in the
    block_sparse phase. Bounds count the true work (forward 4, dq 6, dk/dv
    8, fused 10 flops per live pair, head and d), not the halves'
    recompute of S and dP."""
    import torch
    import torch.nn.functional as F

    from magiattention_tpu_torch.kernels.ffa import (
        ffa_bwd_dkv_kernel, ffa_bwd_dkv_plain, ffa_bwd_dq_kernel, ffa_bwd_dq_plain,
        ffa_bwd_fused_kernel, ffa_bwd_fused_plain, ffa_bwd_mode, ffa_delta_plain,
        ffa_fwd_gqa_kernel, ffa_fwd_kernel, fwd_pack_heads,
    )
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band
    from magiattention_tpu_torch.kernels.paged_decode import paged_decode_kernel, paged_decode_plain
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    gen = torch.Generator(device="cuda").manual_seed(25)
    cases = mask_cases()
    d = GEMMA_D
    results = {}
    for key in ("causal_8192_bf16", "serving_prefill_f32"):
        c = dict(cases[key], d=d)
        if key == "causal_8192_bf16":
            c.update(hq=GEMMA_HQ, hk=GEMMA_HK)
        dname = str(c["dtype"]).removeprefix("torch.")
        (q, k, v, do), (qr, kr, lo, hi), plan, params = case_inputs(c, gen, with_do=True)
        do = (do / 4).to(q.dtype)
        scale = params.softmax_scale
        out, lse = ffa_fwd_kernel(q, k, v, plan, params)
        plain = lambda: sdpa_attn(q, k, v, qr, kr, softmax_scale=scale, d_lo=lo, d_hi=hi)  # noqa: E731
        err = errors(out, lse, *plain())
        check(f"d256 {key} fwd", err, dname)
        mask = build_dense_mask_band(qr, kr, lo, hi, c["sq"], c["sk"], device="cuda")
        live = int(mask.sum().item())
        hq, isz = c["hq"], q.element_size()
        flops = 4.0 * hq * d * live
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + lse.numel() * 4
        b_ms, b_by = fwd_bound(flops, nbytes, dname, peaks)
        ms = time_ms(lambda: ffa_fwd_kernel(q, k, v, plan, params))
        causal = c.get("library") == "causal"
        res = {"ffa_fwd": dict(
            **err, ms=ms, plain_ms=time_ms(plain, warmup=1, samples=3), bound_ms=b_ms,
            bound_by=b_by, share=b_ms / ms, tflops=flops / (ms * 1e-3) / 1e12,
            library_ms=sdpa_ms(c, q, k, v, mask)[0],
        )}
        if causal:  # B2's 256 instance on the same inputs, beside B1
            heads = fwd_pack_heads(hq // c["hk"], d, d, isz)
            if heads < 2:
                raise AssertionError(f"d256: the packed forward's guard refuses g {hq // c['hk']}")
            gqa = lambda: ffa_fwd_gqa_kernel(q, k, v, plan, params)  # noqa: E731
            out_g, lse_g = gqa()
            if not (torch.equal(out_g, out) and torch.equal(lse_g, lse)):
                raise AssertionError("d256: the packed forward is not bit-identical to B1")
            ms_g = time_ms(gqa)
            res["ffa_fwd_gqa"] = dict(
                **err, heads_per_cta=heads, bit_identical_to_unpacked=True, ms=ms_g,
                unpacked_ms=time_ms(lambda: ffa_fwd_kernel(q, k, v, plan, params)),
                plain_ms=res["ffa_fwd"]["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                share=b_ms / ms_g, tflops=flops / (ms_g * 1e-3) / 1e12,
                library_ms=res["ffa_fwd"]["library_ms"],
            )
            del out_g, lse_g
        if causal:  # the backward's 256 instances, both modes
            delta = ffa_delta_plain(out, do)
            args = (q, k, v, do, lse, delta, plan, params)
            dq, (dk, dv) = ffa_bwd_dq_kernel(*args), ffa_bwd_dkv_kernel(*args)
            want = (ffa_bwd_dq_plain(*args), *ffa_bwd_dkv_plain(*args))
            errs = {n: grad_check(f"d256 split {n}", a, b, dname)
                    for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
            fused = ffa_bwd_fused_kernel(*args)
            errs.update({f"fused_{n}": grad_check(f"d256 fused {n}", a, b, dname)
                         for n, a, b in zip(("dq", "dk", "dv"), fused, want)})
            del dq, dk, dv, fused, want
            n_q, n_kv, rows = q.numel(), k.numel(), c["sq"] * hq
            in_bytes = (2 * n_q + 2 * n_kv) * isz + 2 * rows * 4
            for kname, kern, plain_fn, fl, nb in (
                ("ffa_bwd_dq", ffa_bwd_dq_kernel, ffa_bwd_dq_plain, 6.0, in_bytes + n_q * 4),
                ("ffa_bwd_dkv", ffa_bwd_dkv_kernel, ffa_bwd_dkv_plain, 8.0, in_bytes + 2 * n_kv * 4),
                ("ffa_bwd_fused", ffa_bwd_fused_kernel, ffa_bwd_fused_plain, 10.0,
                 in_bytes + (n_q + 2 * n_kv) * 4),
            ):
                b_ms, b_by = bound(fl * hq * d * live, nb, dname, peaks)
                ms = time_ms(lambda kern=kern: kern(*args), samples=5)
                res[kname] = dict(
                    ms=ms, plain_ms=time_ms(lambda p=plain_fn: p(*args), warmup=1, samples=3),
                    bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                    tflops=fl * hq * d * live / (ms * 1e-3) / 1e12, library_ms=None,
                )
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = F.scaled_dot_product_attention(*(t.transpose(0, 1)[None] for t in (qg, kg, vg)),
                                               is_causal=True, enable_gqa=True)
            do_t = do.transpose(0, 1)[None]
            sdpa_bwd = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do_t, retain_graph=True),
                               samples=5)
            del o
            split_ms = res["ffa_bwd_dq"]["ms"] + res["ffa_bwd_dkv"]["ms"]
            fused_ms = res["ffa_bwd_fused"]["ms"]
            mode = ffa_bwd_mode(plan, params, d, d, isz, hq, c["hk"])
            picked, other = (fused_ms, split_ms) if mode == "fused" else (split_ms, fused_ms)
            emit({"phase": "bwd_mode", "case": "causal_8192_bf16_d256", "resolved": mode,
                  "split_ms": split_ms, "fused_ms": fused_ms, "slack": BWD_MODE_SLACK})
            if picked > other * BWD_MODE_SLACK:
                raise AssertionError(
                    f"bwd_mode d256: the model picks {mode} ({picked:.3f} ms), the other mode "
                    f"takes {other:.3f} ms")
            res.update(
                bwd_errors=errs, split_ms=split_ms, sdpa_bwd_ms=sdpa_bwd, resolved_bwd_mode=mode,
                split_bound_ms=res["ffa_bwd_dq"]["bound_ms"] + res["ffa_bwd_dkv"]["bound_ms"],
                split_library_ms=sdpa_bwd,
            )
            res["ffa_bwd_fused"]["library_ms"] = sdpa_bwd
            del qg, kg, vg, delta, args
        res.update(case=f"{key}_d{d}", dtype=dname, q=list(q.shape), kv=list(k.shape),
                   live_pairs=live, atol=ATOL[dname], rnorm=RNORM[dname])
        emit({"phase": "d256_kernels", **res})
        results[key] = res
        del q, k, v, do, out, lse, mask
        torch.cuda.empty_cache()

    dec = {}
    for dt in (torch.float32, torch.bfloat16):  # B10
        dname = str(dt).removeprefix("torch.")
        cache = decode_pages(dt, GEMMA_HK, seed=26, d=d)
        q = torch.randn((8, GEMMA_HQ, d), generator=gen, device="cuda").to(dt)
        kernel = lambda: paged_decode_kernel(q, cache, d ** -0.5)  # noqa: E731
        plain = lambda: paged_decode_plain(q, cache, d ** -0.5)  # noqa: E731
        out_k, lse_k = kernel()
        err = errors(out_k, lse_k, *plain())
        check(f"d256 paged_decode {dname}", err, dname)
        nbytes = decode_bytes(q, lse_k, DECODE_LENGTHS, GEMMA_HK, 16)
        b_ms, b_by = bound(4.0 * GEMMA_HQ * d * sum(DECODE_LENGTHS), nbytes, dname, peaks)
        ms, dev = time_ms(kernel), graph_ms(kernel)
        dec[dname] = dict(**err, **split_of(cache), ms=ms, device_ms=dev,
                          plain_ms=time_ms(plain, warmup=1), bound_ms=b_ms, bound_by=b_by,
                          share=b_ms / dev, gb_s=nbytes / (ms * 1e-3) / 1e9, library_ms=None)
        del cache
    emit({"phase": "d256_kernels", "case": f"decode_8slots_d{d}", "q_heads": GEMMA_HQ,
          "kv_heads": GEMMA_HK, "lengths": DECODE_LENGTHS, "paged_decode": dec})
    results["paged_decode"] = dec
    torch.cuda.empty_cache()
    return results


def hybrid_d256_phase(peaks: dict) -> dict:
    """Gemma-2-9B attention through the API at cp 1, at full width (bf16,
    hq 16, hk 8, d 256, softcap 50, scale 256^-0.5) over 8192 tokens in one
    causal document: the dispatch key is the global causal mask
    (``magi_attn_varlen_key``), re-keyed by
    ``make_varlen_key_for_new_mask_after_dispatch`` to the 4096-token
    sliding window ``(4095, 0)``, whose partitions must equal the dispatch
    key's. Through each key, q/k/v dispatched by the first: ``calc_attn``,
    ``undispatch`` and the backward, against ``sdpa_attn`` (the plain
    version) on the key's own mask under autograd, at the bf16 gates;
    fwd+bwd ms, the bound (4 + 10 flops per live pair, head and d; the split
    mode 4 + 14) and the share for each key, and the launches of the
    resolved kernels (counts reset just before each run). The API takes
    no softcap (as the JAX package's), so each key's runtime gets it."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode
    from magiattention_tpu_torch.kernels.mask_utils import build_dense_mask_band, types_to_bands
    from magiattention_tpu_torch.kernels.sdpa import sdpa_attn

    s, hq, hk, d = GEMMA_SEQ, GEMMA_HQ, GEMMA_HK, GEMMA_D
    gen = torch.Generator(device="cuda").manual_seed(27)
    shapes = ((s, hq, d), (s, hk, d), (s, hk, d))
    inputs = [torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16) for sh in shapes]
    do = (torch.randn(shapes[0], generator=gen, device="cuda") / 4).to(torch.bfloat16)
    t0 = time.perf_counter()
    key_g = api.magi_attn_varlen_key([0, s], causal=True)
    key_w = api.make_varlen_key_for_new_mask_after_dispatch(
        [0, s], [0, s], key_g, causal=False, window_size=(GEMMA_WINDOW - 1, 0))
    plan_s = time.perf_counter() - t0
    parts = [list(p) for p in _mgr(key_g).dispatch_meta_q.partitions]
    if [list(p) for p in key_w.fixed_partitions] != parts or (
            [list(p) for p in _mgr(key_w).dispatch_meta_q.partitions] != parts):
        raise AssertionError("hybrid_d256: the re-keyed partitions differ from the dispatch key's")
    res = dict(
        model="google/gemma-2-9b attention: 16/8 heads, head_dim 256, softcap 50, "
              "scale 256^-0.5, sliding window 4096 beside global causal",
        shape=f"bf16 q {list(shapes[0])}, k/v {list(shapes[1])}, one causal document",
        cp=1, plan_s=plan_s, partitions=len(parts),
    )
    for name, key in (("global", key_g), ("window", key_w)):
        runtime = _mgr(key).runtime
        runtime.softcap = GEMMA_SOFTCAP  # the API takes none: the runtime's field
        mode = ffa_bwd_mode(runtime.plans[0], runtime._params(d)[0], d, d, 2, hq, hk)

        def api_path():
            q, k, v = (t.detach().requires_grad_(True) for t in inputs)
            out_d, _ = api.calc_attn(api.dispatch(q, key_g), api.dispatch(k, key_g, role="kv"),
                                     api.dispatch(v, key_g, role="kv"), key)
            out = api.undispatch(out_d, key)
            return (out, *torch.autograd.grad(out, (q, k, v), do))

        qr, kr = np.array(key.q_ranges), np.array(key.k_ranges)
        types = np.array(key.attn_mask_type)

        def plain_path():
            q, k, v = (t.detach().requires_grad_(True) for t in inputs)
            out, _ = sdpa_attn(q, k, v, qr, kr, attn_type_map=types, softcap=GEMMA_SOFTCAP)
            return (out, *torch.autograd.grad(out, (q, k, v), do))

        torch.cuda.synchronize()
        reset_launch_counts()
        got = api_path()
        torch.cuda.synchronize()
        counts = launch_counts()
        expected = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels(mode))
        if any(counts[k] != 1 for k in expected) or any(counts[k] for k in PLAIN_NAMES):
            raise AssertionError(f"hybrid_d256 {name}: launched {counts}, want one of {expected}")
        want = plain_path()
        err = {n: grad_check(f"hybrid_d256 {name} {n}", a.float(), b.float(), "bfloat16")
               for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
        del got, want
        lo, hi = types_to_bands(qr.astype(np.int32), kr.astype(np.int32), types.astype(np.int32))
        mask = build_dense_mask_band(qr, kr, lo, hi, s, s, device="cuda")
        live = int(mask.sum().item())
        del mask
        flops = (4.0 + (10.0 if mode == "fused" else 14.0)) * hq * d * live
        nbytes = (4 * inputs[0].numel() + 4 * inputs[1].numel()) * 2 + 2 * s * hq * 4
        b_ms, b_by = bound(flops, nbytes, "bfloat16", peaks)
        ms = time_ms(api_path, samples=5)
        res[name] = dict(
            resolved_bwd_mode=mode, live_pairs=live, launches={k: v for k, v in counts.items() if v},
            vs_plain=err, fwd_bwd_ms=ms, bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
            tflops=flops / (ms * 1e-3) / 1e12,
        )
        torch.cuda.empty_cache()
    res.update(atol=ATOL["bfloat16"], rnorm=RNORM["bfloat16"])
    emit({"phase": "hybrid_d256", **res})
    return res


# train_padded: two documents of 4096 and 3904 tokens, padded to 8192
PAD_DOCS, PAD_CHUNK = (4096, 3904), 512


def train_padded_phase(train: dict) -> dict:
    """The Llama trainer at the train phase's widths (2 layers, bf16, seed
    0) on 8000 tokens in two documents (4096 + 3904), padded to 8192 with
    ``compute_pad_size`` / ``apply_padding`` / ``pad_at_dim`` at chunk 512
    and cp 1, labels -100 on the pad rows: one step, its loss within rel
    1e-2 of the unpadded 8000-token step's, and the attention output of the
    pad rows 0 (lse -inf) through the padded key; its step ms beside the
    train phase's."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.functools import infer_attn_mask_from_cu_seqlens
    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts
    from magiattention_tpu_torch.models.llama import LlamaConfig, init_params, train_step, value_and_grad

    cfg = LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=TRAIN_LAYERS, n_heads=32, n_kv_heads=8,
        head_dim=128, ffn_hidden=14336, rope_theta=500000.0, norm_eps=1e-5, dtype="bfloat16",
    )
    params = init_params(cfg, seed=0, device="cuda")
    s = sum(PAD_DOCS)
    cu = [0, PAD_DOCS[0], s]
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1).clone()
    labels[torch.tensor(cu[1:], device="cuda") - 1] = -100  # each document's end
    qr, kr, types = infer_attn_mask_from_cu_seqlens(cu, causal=True)
    key_u = api.magi_attn_flex_key(qr, kr, types, s, s)
    loss_u, _ = value_and_grad(params, cfg, tokens, labels, key_u)
    loss_u = loss_u.item()
    pad = api.compute_pad_size(s, 1, PAD_CHUNK)
    qr_p, kr_p, types_p = api.apply_padding(qr, kr, types, s, pad)
    key_p = api.magi_attn_flex_key(qr_p, kr_p, types_p, s + pad, s + pad, chunk_size=PAD_CHUNK)
    tokens_p = api.pad_at_dim(tokens, 0, pad)
    labels_p = api.pad_at_dim(labels, 0, pad, value=-100)
    # the pad rows' attention through the padded key: out 0, lse -inf
    att = [torch.randn((s + pad, h, cfg.head_dim), generator=gen, device="cuda").to(torch.bfloat16)
           for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    out_d, meta = api.calc_attn(api.dispatch(att[0], key_p), api.dispatch(att[1], key_p, role="kv"),
                                api.dispatch(att[2], key_p, role="kv"), key_p)
    out = api.undispatch(out_d, key_p)
    lse = api.undispatch(meta.lse, key_p)
    if out[s:].any() or not torch.isneginf(lse[s:]).all():
        raise AssertionError("train_padded: the pad rows' attention is not (0, -inf)")
    del att, out_d, out, lse
    train_step(params, cfg, tokens_p, labels_p, key_p, lr=0.0)  # warm: plans, shapes
    reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, loss_p = train_step(params, cfg, tokens_p, labels_p, key_p, lr=TRAIN_LR)
    loss_p = loss_p.item()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    counts = {k: v for k, v in launch_counts().items() if v}
    rel = abs(loss_p - loss_u) / abs(loss_u)
    if not np.isfinite(loss_p) or rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"train_padded: loss {loss_p} vs unpadded {loss_u} (rel {rel:.3e})")
    if not counts.get("ffa_fwd"):
        raise AssertionError(f"train_padded: no FFA launch: {counts}")
    res = dict(
        tokens=s, documents=list(PAD_DOCS), pad=pad, padded_tokens=s + pad, chunk=PAD_CHUNK,
        loss_padded=loss_p, loss_unpadded=loss_u, loss_rel_err=rel, loss_rtol=TRAIN_LOSS_RTOL,
        step_ms=ms, train_step_ms=train["steps"][-1]["ms"], launches=counts,
    )
    emit({"phase": "train_padded", **res})
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --cp4: the CP baselines and MagiAttention's API end
# to end on four cards of one host, the collectives over NCCL
# ---------------------------------------------------------------------------

LT_AXES = ("rp_out", "rp_in", "sp")
# name -> (function of magiattention_tpu_torch.parallel, mesh, the data's
# sharding axes, the ring dispatch (ring size, sharding) or None, kwargs);
# a mesh is (axis names, shape), or ("loongtrain", (U, O, I), placement)
CP4_RUNS = {
    "ring_contig": ("ring_attn", (("cp",), (4,)), ("cp",), (4, "contig"), {"sharding": "contig"}),
    "ring_zigzag": ("ring_attn", (("cp",), (4,)), ("cp",), (4, "zigzag"), {"sharding": "zigzag"}),
    "ring_allgather_zigzag": ("ring_attn_allgather", (("cp",), (4,)), ("cp",), (4, "zigzag"),
                              {"sharding": "zigzag"}),
    "allgather": ("allgather_attn", (("cp",), (4,)), ("cp",), None, {}),
    "ulysses": ("ulysses_attn", (("cp",), (4,)), ("cp",), None, {}),
    "usp_r2u2": ("usp_attn", (("rp", "sp"), (2, 2)), ("rp", "sp"), None, {}),
    "loongtrain_o2i2_zigzag": ("loongtrain_attn", (LT_AXES[:2], (2, 2)), LT_AXES[:2], (4, "zigzag"),
                               {"sharding": "zigzag"}),
    "loongtrain_o1i2u2_head_first": ("loongtrain_attn", ("loongtrain", (2, 1, 2), "head_first"),
                                     LT_AXES, (2, "zigzag"), {"ulysses_axis": "sp"}),
    "loongtrain_o1i2u2_context_first": ("loongtrain_attn", ("loongtrain", (2, 1, 2), "context_first"),
                                        LT_AXES, (2, "zigzag"), {"ulysses_axis": "sp"}),
    "hybrid_o2i2": ("hybrid_cp_attn", (("cp_inter", "cp_intra"), (2, 2)), ("cp_inter", "cp_intra"),
                    None, {}),
}


def _cp4_mesh(spec):
    from magiattention_tpu_torch.parallel import ProcessMesh, make_loongtrain_mesh

    if spec[0] == "loongtrain":
        (u, o, i), placement = spec[1], spec[2]
        return make_loongtrain_mesh(None, u, o, i, placement)
    names, shape = spec
    return ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape), names)


def _world_ms(step, on_card: bool, warmup: int = 3, samples: int = 10) -> list[float]:
    """Every rank's median ms of ``step()`` (CUDA events on the card), the
    ranks leaving a barrier together before each sample."""
    import torch
    import torch.distributed as dist

    if not on_card:  # a rehearsal on the CPU measures nothing
        step()
        return [0.0] * dist.get_world_size()
    for _ in range(warmup):
        step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        dist.barrier()
        torch.cuda.synchronize()
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return _every_rank(statistics.median(times))


def cp4_run(device: str, seq: int) -> dict:
    """One rank's part of ``--cp4``: each baseline of ``CP4_RUNS`` and
    MagiAttention's API at cp 4 on both of ``cp_baselines``' masks, then
    the API's two-level run at (dcn 2, ici 2) and its TP run at (cp 2, tp
    2), fwd+bwd on this rank's shard through the distributed entry point;
    out, lse and the gradients of its shard against the single-device
    ``ffa_attn`` on the whole (bf16 gates), and every rank's step ms."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api, parallel
    from magiattention_tpu_torch.kernels.ffa import ffa_attn
    from magiattention_tpu_torch.parallel._utils import zigzag_perm

    on_card = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(29)
    shapes = ((seq, CP_HQ, CP_D), (seq, CP_HK, CP_D), (seq, CP_HK, CP_D))
    q, k, v = (torch.randn(sh, generator=gen, device=device).to(torch.bfloat16) for sh in shapes)
    do = (torch.randn(shapes[0], generator=gen, device=device) / 4).to(torch.bfloat16)
    meshes, res = {}, {}
    for mask, (docs, types_) in CPB_MASKS.items():
        docs = [[a * seq // CP_SEQ, b * seq // CP_SEQ] for a, b in docs]
        qr, types = np.array(docs), np.array(types_)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out_ref, lse_ref = ffa_attn(*leaves, qr, qr, types)
        want_full = (out_ref.detach(), lse_ref, *torch.autograd.grad(out_ref, leaves, do))
        runs = {}
        for name, (fn, spec, axes, dispatch, kw) in CP4_RUNS.items():
            if repr(spec) not in meshes:
                meshes[repr(spec)] = _cp4_mesh(spec)
            mesh = meshes[repr(spec)]
            perm = torch.as_tensor(
                zigzag_perm(seq, dispatch[0]) if dispatch and dispatch[1] == "zigzag" else np.arange(seq),
                device=device,
            )

            def shard(x, mesh=mesh, axes=axes, perm=perm):
                return parallel.local_shard(x[perm], mesh, axes)

            q_s, k_s, v_s, do_s = (shard(t) for t in (q, k, v, do))

            def step(fn=fn, mesh=mesh, kw=kw, q_s=q_s, k_s=k_s, v_s=v_s, do_s=do_s):
                ls = [t.detach().requires_grad_(True) for t in (q_s, k_s, v_s)]
                out, lse = getattr(parallel, fn)(*ls, qr, qr, types, mesh, **kw)
                return (out, lse, *torch.autograd.grad(out, ls, do_s))

            got = step()
            err = {n: grad_check(f"cp4 {mask} {name} {n}", a.float(), shard(b).float(), "bfloat16")
                   for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want_full)}
            runs[name] = dict(errors=err, fwd_bwd_ms=_world_ms(step, on_card))
            del got
        # MagiAttention's own: the API at cp 4 (default config, chunks of 512)
        key = api.magi_attn_flex_key(docs, docs, list(types_), seq, seq, cp_group=dist.group.WORLD,
                                     device=device, chunk_size=min(512, seq // 8))
        q_d, do_d = api.dispatch(q, key), api.dispatch(do, key)
        k_d, v_d = api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv")

        def magi_step():
            ls = [t.detach().requires_grad_(True) for t in (q_d, k_d, v_d)]
            out, meta = api.calc_attn(*ls, key)
            return (out, meta.lse, *torch.autograd.grad(out, ls, do_d))

        got = magi_step()
        want = (api.dispatch(want_full[0], key), api.dispatch(want_full[1], key),
                api.dispatch(want_full[2], key), api.dispatch(want_full[3], key, role="kv"),
                api.dispatch(want_full[4], key, role="kv"))
        err = {n: grad_check(f"cp4 {mask} magi {n}", a.float(), b.float(), "bfloat16")
               for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want)}
        runs["magi_api"] = dict(errors=err, fwd_bwd_ms=_world_ms(magi_step, on_card))
        # two-level comm at (dcn 2, ici 2) and TP over heads at (cp 2, tp 2)
        if "ht" not in meshes:
            meshes["ht"] = ht_meshes()
        mesh_h, mesh_t = meshes["ht"]
        t = mesh_t.coord("tp")
        cases = {
            "magi_two_level_dcn2_ici2": HTCase(
                ht_key(docs, types_, HIER_ENV, device, mesh=mesh_h, cp_axis=PAIR), HIER_ENV,
                (q, k, v, do), want_full),
            "magi_tp_cp2_tp2": HTCase(
                ht_key(docs, types_, {}, device, mesh=mesh_t, cp_axis="cp", head_axis="tp"), {},
                (q, k, v, do), want_full, slice(t * CP_HQ // 2, (t + 1) * CP_HQ // 2),
                slice(t * CP_HK // 2, (t + 1) * CP_HK // 2)),
        }
        for name, case in cases.items():
            err = ht_check(f"cp4 {mask} {name}", case.step(), case.want)
            runs[name] = dict(errors=err, fwd_bwd_ms=_world_ms(case.step, on_card))
        del cases
        res[mask] = dict(
            runs=runs, overlap=cp4_overlap(docs, types_, seq, (q, k, v, do), want_full, on_card),
            collectives=cp4_collectives(docs, types_, seq, (q, k, v, do), mesh_h, on_card),
            single_device_fwd_bwd_ms=_world_ms(
                lambda: torch.autograd.grad(ffa_attn(*leaves, qr, qr, types)[0], leaves, do),
                on_card),
        )
        del want_full, out_ref, leaves
    return res


# the API's overlap settings at cp 4: name -> (overlap degree, use_overlap
# forced on, or None for the API's own choice: on iff the plan has more
# than one stage)
OVERLAP_RUNS = (("degree1", 1, None), ("degree1_overlap", 1, True), ("degree2", 2, None),
                ("degree4", 4, None))
DETERMINISTIC_ENV = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}


def _runtime_step(rt, q_d, k_d, v_d, do_d):
    """fwd+bwd of this rank's dispatched rows through ``rt``: out, lse,
    dq, dk, dv."""
    import torch

    ls = [t.detach().requires_grad_(True) for t in (q_d, k_d, v_d)]
    out, lse = rt.calc_attn(*ls)
    return (out, lse, *torch.autograd.grad(out, ls, do_d))


def cp4_overlap(docs, types_, seq: int, inputs, want_full, on_card: bool) -> dict:
    """The API's runtime at each of ``OVERLAP_RUNS`` on this mask: its
    stages, whether it overlaps, out, lse and gradients against the
    single-device ``ffa_attn`` (bf16 gates) and every rank's fwd+bwd ms;
    where it overlaps at degree >= 2, the staged backward under
    MAGI_ATTENTION_DETERMINISTIC_MODE=1 equal to the bit to the same
    stages with every reduce after every part's backward (that order's
    fwd+bwd ms too, then the staged one's again), and
    ``assert_overlap_safe`` (bf16 tolerance)."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig
    from magiattention_tpu_torch.env.general import scoped_env
    from magiattention_tpu_torch.functional.dist_attn import DistAttnRuntime
    from magiattention_tpu_torch.testing import assert_overlap_safe

    q, k, v, do = inputs
    group = dist.group.WORLD
    runs = {}
    for name, degree, force in OVERLAP_RUNS:
        key = api.magi_attn_flex_key(
            docs, docs, list(types_), seq, seq, cp_group=group, device=q.device.type,
            chunk_size=min(512, seq // 8),
            dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(degree=degree)),
        )
        mgr = _mgr(key)
        rt = mgr.runtime if force is None else DistAttnRuntime(
            mgr.comm_meta, mgr.calc_meta, dist.get_rank(group), group, use_overlap=force)
        q_d, do_d = api.dispatch(q, key), api.dispatch(do, key)
        k_d, v_d = api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv")
        want = (api.dispatch(want_full[0], key), api.dispatch(want_full[1], key),
                api.dispatch(want_full[2], key), api.dispatch(want_full[3], key, role="kv"),
                api.dispatch(want_full[4], key, role="kv"))

        def step(rt=rt, args=(q_d, k_d, v_d, do_d)):
            return _runtime_step(rt, *args)

        res = dict(degree=degree, stages=rt.num_stages, overlapped=rt.use_overlap,
                   errors=ht_check(f"cp4 overlap {name}", step(), want),
                   fwd_bwd_ms=_world_ms(step, on_card))
        if degree >= 2 and rt.use_overlap:
            with scoped_env(DETERMINISTIC_ENV):
                staged = step()
                rt.staged_backward = False
                unstaged = step()
                rt.staged_backward = True
            same = [bool(torch.equal(a, b)) for a, b in zip(staged, unstaged)]
            if not all(same):
                raise AssertionError(f"cp4 overlap {name}: the staged backward under "
                                     f"deterministic mode is not the unstaged one's bits: {same}")
            assert_overlap_safe(mgr.comm_meta, mgr.calc_meta, group, q_d, k_d, v_d, do=do_d,
                                atol=ATOL["bfloat16"], rtol=RNORM["bfloat16"], iters=2)
            rt.staged_backward = False  # every reduce after every part, timed alike
            unstaged_ms = _world_ms(step, on_card)
            rt.staged_backward = True
            res.update(deterministic_bitwise=True, overlap_safe=True,
                       unstaged_fwd_bwd_ms=unstaged_ms,
                       staged_again_fwd_bwd_ms=_world_ms(step, on_card))
        runs[name] = res
    return runs


def _a2a_step(out, inp, out_splits, in_splits, group):
    """One ``all_to_all_single`` of ``inp``'s rows, waited for."""
    import torch.distributed as dist

    def step():
        dist.all_to_all_single(out, inp, list(out_splits), list(in_splits), group=group)
    return step


def cp4_collectives(docs, types_, seq: int, inputs, mesh_h, on_card: bool) -> dict:
    """Each collective of a degree-2 plan alone, per stage: every rank's
    ms (median of CUDA-event samples after a barrier) and the bytes it
    sent, for the GroupCast of K|V (bf16), the GroupReduce of dK|dV in
    bf16 and under the high-precision reduce in float32 (cast and reduce
    as the runtime issues them, waits and sums included), and the
    two-level cast's phase A (over the outer line) and phase B (over the
    inner line) at (dcn 2, ici 2) over ``mesh_h``, each one
    ``all_to_all_single`` of the plan's rows. ``gb_s`` is the bytes every rank sent over the slowest
    rank's time."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig

    q, k, v, _ = inputs
    config = DistAttnConfig(overlap_config=OverlapConfig(degree=2))
    group = dist.group.WORLD
    key = api.magi_attn_flex_key(docs, docs, list(types_), seq, seq, cp_group=group,
                                 device=q.device.type, chunk_size=min(512, seq // 8),
                                 dist_attn_config=config)
    rt = _mgr(key).runtime
    key_h = ht_key(docs, types_, HIER_ENV, q.device.type, mesh=mesh_h, cp_axis=PAIR,
                   dist_attn_config=config)
    rt_h = _mgr(key_h).runtime
    kv = torch.cat([api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv")], dim=-1)
    row = kv[0].numel()
    gen = torch.Generator(device=q.device.type).manual_seed(31)

    def timed(step, sent_rows: int, itemsize: int) -> dict:
        ms = _world_ms(step, on_card)
        sent = torch.tensor([float(sent_rows * row * itemsize)], device=kv.device)
        every = [torch.zeros_like(sent) for _ in range(dist.get_world_size())]
        dist.all_gather(every, sent)
        total = sum(t.item() for t in every)
        return dict(ms=ms, bytes_sent=[t.item() for t in every],
                    gb_s=total / (max(ms) * 1e-3) / 1e9 if on_card else None)

    stages = []
    for st, (plan, hplan) in enumerate(zip(rt.cast_plans, rt_h.cast_plans)):
        n_send = len(plan.send_rows)

        def cast(plan=plan):
            plan.cast_start(kv, group, kv.dtype)[1]()

        res = dict(stage=st, recv_rows=plan.recv_len, send_rows=n_send,
                   group_cast_bf16=timed(cast, n_send, 2))
        for tag, dt in (("group_reduce_bf16", torch.bfloat16),
                        ("group_reduce_hp_f32", torch.float32)):
            y = torch.randn((plan.buf_len, *kv.shape[1:]), generator=gen, device=kv.device).to(dt)

            def reduce(plan=plan, y=y, dt=dt):
                plan.reduce_finish(None, plan.reduce_start(y, group, dt), group, kv.shape[0])

            res[tag] = timed(reduce, plan.recv_len, dt.itemsize)
        outer, inner = rt_h.cast_group
        send_a = kv.index_select(0, hplan.rows(kv.device))
        recv_a = kv.new_empty((hplan.recv_a_len, *kv.shape[1:]))
        res["two_level_phase_a_bf16"] = timed(
            _a2a_step(recv_a, send_a, hplan.a_recv_splits, hplan.a_send_splits, outer),
            len(hplan.a_send_rows), 2)
        held = torch.cat([kv, recv_a])
        send_b = held.index_select(0, hplan._index("b_send_rows", kv.device))
        recv_b = kv.new_empty((hplan.recv_len, *kv.shape[1:]))
        res["two_level_phase_b_bf16"] = timed(
            _a2a_step(recv_b, send_b, hplan.b_recv_splits, hplan.b_send_splits, inner),
            len(hplan.b_send_rows), 2)
        stages.append(res)
    return dict(row_bytes_bf16=row * 2, kv_shard=list(kv.shape), stages=stages)


def cp4_sharded_engine() -> dict:
    """The head-sharded serve engine on this host's cards, in the parent
    process after the four ranks have left: ``ServeEngine`` at
    ``decode_shards`` 2 and 4 (B10 once per shard, shard s on card s) on
    the serve phase's model and requests, every generated row equal to
    the one-card engine's (``decode_shards=1``) to the bit; the rung,
    launches and wall."""
    import torch

    from magiattention_tpu_torch.serving import ServeEngine
    from magiattention_tpu_torch.serving.decode import decode_route

    model, config = serve_model("cuda")
    base = serve_requests(model)
    _, base_wall, _ = serve_run(ServeEngine(model, config), base)
    res = dict(one_card_wall_s=base_wall, cards=torch.cuda.device_count())
    for n in (2, 4):
        reqs = serve_requests(model)
        engine = ServeEngine(model, dataclasses.replace(config, decode_shards=n))
        stats, wall, counts = serve_run(engine, reqs)
        rung = decode_route(engine.cache, multi_row=False, shards=n)
        if rung != "paged_decode_sharded":
            raise AssertionError(f"cp4 sharded engine: decode_shards={n} took {rung}")
        check_launches(f"cp4 sharded engine n={n}", counts, ("ffa_fwd", "paged_decode"))
        for a, b in zip(base, reqs):
            if not np.array_equal(np.stack(a.generated), np.stack(b.generated)):
                raise AssertionError(f"cp4 sharded engine n={n}: request {a.req_id} differs "
                                     "from the one-card engine's rows")
        res[f"decode_shards_{n}"] = dict(
            rung=rung, wall_s=wall, bitwise=True, ticks=len(stats),
            kernel_launches={k: counts[k] for k in ("ffa_fwd", "paged_decode")},
        )
    return res


def moe_ep_reference(params, cfg, tokens, labels, key1, keys) -> tuple[list, tuple, float]:
    """What the one-layer MoE at cp = ep should give under each key of
    ``keys`` (experts over as many ranks as the key's cp group, each EP
    rank routing the rows its cp rank holds), from one cp 1 pass of the
    model on this card. Under a key, each rank's aux is the Switch aux of
    the rows of cp 1's MoE input that the key dispatches to it: the loss
    is cp 1's cross entropy plus ``aux_loss_coef`` x the key's group mean
    of the ranks' aux, the gradients cp 1's cross entropy's plus
    ``aux_loss_coef / cp`` x the group sum of the ranks' aux gradients.
    Without EP every rank routes the whole batch: cp 1's loss and
    gradients, aux of all rows (at a capacity with no drop, the same in
    any row order). Returns ([(loss, gradients in ``LAYOUT.leaves`` order,
    aux) a key], that of the whole batch, the first key's aux term's
    direct router gradient, summed over its group, as a rel-norm of its
    whole router gradient: how much of that gradient the aux path
    holds)."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models import moe
    from magiattention_tpu_torch.models.llama import _rms_norm, attn_block, masked_ce

    coef = cfg.aux_loss_coef
    leaves = [p.detach().requires_grad_(True) for p in moe.LAYOUT.leaves(params)]
    live = moe.LAYOUT.rebuild(leaves, 1)
    lyr = live["layers"][0]
    x = live["embed"][api.dispatch(tokens, key1).long()]
    x = attn_block(x, lyr, cfg, api.get_position_ids(key1), key1)
    h = _rms_norm(x, lyr["mlp_norm"], cfg.norm_eps)
    y, aux_all = moe.moe_ffn(h, lyr, cfg)
    logits = _rms_norm(x + y, live["final_norm"], cfg.norm_eps) @ live["lm_head"]
    ce = masked_ce(logits, api.dispatch(labels, key1))
    h_nat = api.undispatch(h, key1)
    shards = []
    for key in keys:
        group, cp = key.cp_group, key.cp_size
        mine = h_nat.index_select(
            0, api.dispatch(torch.arange(tokens.shape[0], device=tokens.device), key))
        aux = moe._route(mine, lyr["router"], cfg)[2]
        g_aux = torch.autograd.grad(aux, leaves, allow_unused=True, retain_graph=True)
        aux = aux.detach().clone()
        for g in (aux, *(g for g in g_aux if g is not None)):
            dist.all_reduce(g, group=group)
        shards.append((mine.detach(), aux / cp, [g if g is None else g / cp for g in g_aux]))
    g_all = torch.autograd.grad(aux_all, leaves, allow_unused=True, retain_graph=True)
    g_ce = torch.autograd.grad(ce, leaves)

    def ref(aux, g_aux):
        return (ce.detach() + coef * aux,
                [gc if ga is None else gc + coef * ga for gc, ga in zip(g_ce, g_aux)], aux)

    refs = [ref(aux, g_aux) for _, aux, g_aux in shards]
    whole = ref(aux_all.detach(), g_all)
    router = lyr["router"].detach().requires_grad_(True)
    direct = torch.autograd.grad(
        coef * moe._route(shards[0][0], router, cfg)[2] / keys[0].cp_size, router)[0]
    dist.all_reduce(direct, group=keys[0].cp_group)
    g_router = refs[0][1][moe.LAYOUT.names(params).index("layers.0.router")]
    return refs, whole, (direct.norm() / g_router.norm()).item()


def cp4_moe_ep(device: str, seq: int) -> dict:
    """``--cp4``'s MoE at Mixtral-8x7B's widths on ``seq`` tokens in two
    causal documents at cp 4 = ep 4 (two experts a card): (a) float32,
    capacity factor 8 (no drop at cp 1 or cp 4), one layer (a float32
    cp 1 run at capacity 8 takes ~60 GB), aux_loss_coef at its default:
    the tree of ``shard_moe_params(..., ep_axis="cp")`` (expert blocks,
    ZeRO-3 elsewhere): this rank's undispatched logits against a cp 1 run
    of the same weights on this card, and the loss, the aux and every
    gradient (gathered) against :func:`moe_ep_reference` (cp 1's model
    with each rank's aux share taken of its own cp 4 rows), at
    ``F32_LOSS_RTOL`` and ``F32_GRAD_RNORM`` (float32 so that no near-tied
    token changes expert between the runs); then the loss and gradients
    again under a key of overlap degree 2 (the staged runtime's
    collectives beside the MoE exchanges); the ZeRO-3 tree without EP
    (expert stacks over cp, gathered each layer; every rank routes the
    whole batch) against the whole batch's reference; and EP over
    ``"tp"`` of a (cp 2, tp 2) mesh against its key's reference, at the
    same gates; (b) bf16, the default capacity,
    two layers: three ``moe_train_step``s, finite, each loss equal to the
    sum of the ranks' shares (``moe_loss_fn`` at the same weights, rel
    1e-5), every rank's step ms, and one slot exchange (``all_to_all`` of
    this rank's ``(E, C, dim)`` slots) alone, every rank's ms."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.comm.functional import all_to_all
    from magiattention_tpu_torch.config import DistAttnConfig, OverlapConfig
    from magiattention_tpu_torch.models import moe
    from magiattention_tpu_torch.models.shard import gather_leaves
    from magiattention_tpu_torch.parallel import ProcessMesh

    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    group, cp = dist.group.WORLD, dist.get_world_size()
    docs = _docs(seq, seq // 2)

    def key_of(cp_group):
        return api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, cp_group=cp_group,
                                      device=device)

    def f32_check(what, got, want, tree):
        worst, worst_rn, rn = grads_rel_norm(names, gather_leaves(got, tree, moe.LAYOUT), want)
        if not (all(torch.isfinite(g).all() for g in got) and worst_rn <= F32_GRAD_RNORM):
            raise AssertionError(f"cp4 moe{what}: gradient {worst} rel-norm {worst_rn:.3e} "
                                 f"against the reference, gate {F32_GRAD_RNORM}")
        return worst, rn

    def rel(a, b):
        return abs(a.item() - b.item()) / abs(b.item())

    cfg = moe_config(on_card, n_layers=1, dtype="float32", capacity_factor=8.0)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (seq,), generator=gen, device=device)
    labels = next_token_labels(tokens, seq // 2)
    params = moe.init_moe_params(cfg, seed=0, device=device)
    names = moe.LAYOUT.names(params)
    key1, key4 = key_of(None), key_of(group)
    # overlap degree 2: the staged GroupCasts (async) and GroupReduces and
    # the MoE exchanges on one communicator. Chunks of 512 at 8192 tokens,
    # as ``cp4_overlap``'s (two stages): another dispatch, other aux shards
    key_o = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, cp_group=group, device=device,
                                   chunk_size=min(512, seq // 16), dist_attn_config=DistAttnConfig(
                                       overlap_config=OverlapConfig(degree=2)))
    rt = _mgr(key_o).runtime
    if not (rt.use_overlap and rt.num_stages >= 2):
        raise AssertionError(f"cp4 moe: the degree-2 key planned {rt.num_stages} stage(s)")
    # EP over "tp" of (cp 2, tp 2): EP rank t routes block t of the global
    # dispatched rows, the rows cp rank t holds
    mesh22 = ProcessMesh(np.arange(4).reshape(2, 2), ("cp", "tp"))
    key22 = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, mesh=mesh22, cp_axis="cp",
                                   device=device)
    with torch.no_grad():
        logits1, aux1 = moe.moe_forward(params, cfg, tokens, key1)
        logits1 = api.undispatch(logits1, key1)
    refs, ref_all, router_aux = moe_ep_reference(params, cfg, tokens, labels, key1,
                                                 (key4, key_o, key22))
    (loss_r, g_r, aux_r), (loss_ro, g_ro, _), ref22 = refs
    del refs  # each reference's gradients are freed once checked
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    sharded = moe.shard_moe_params(params, api.get_mesh(key4), ep_axis="cp")
    with torch.no_grad():
        logits4, aux4 = moe.moe_forward(sharded, cfg, tokens, key4, "cp")
        logits4 = api.undispatch(logits4, key4)
    loss4, g4 = moe.moe_value_and_grad(sharded, cfg, tokens, labels, key4, "cp")
    logits_rn = ((logits4.double() - logits1.double()).norm() / logits1.double().norm()).item()
    loss_rel, aux_rel = rel(loss4, loss_r), rel(aux4, aux_r)
    if not (loss_rel <= F32_LOSS_RTOL and aux_rel <= F32_LOSS_RTOL
            and logits_rn <= F32_GRAD_RNORM):
        raise AssertionError(
            f"cp4 moe: loss {loss4.item()} vs {loss_r.item()}, aux {aux4.item()} vs "
            f"{aux_r.item()} (rel gate {F32_LOSS_RTOL}), logits rel-norm {logits_rn:.3e}")
    worst, err = f32_check("", g4, g_r, sharded)
    del g4, g_r, logits1, logits4
    loss_o, g_o = moe.moe_value_and_grad(sharded, cfg, tokens, labels, key_o, "cp")
    if not rel(loss_o, loss_ro) <= F32_LOSS_RTOL:
        raise AssertionError(f"cp4 moe degree 2: loss {loss_o.item()} vs {loss_ro.item()}")
    worst_o, err_o = f32_check(" degree 2", g_o, g_ro, sharded)
    degree2 = dict(stages=rt.num_stages, overlapped=rt.use_overlap, loss=loss_o.item(),
                   loss_reference=loss_ro.item(), worst_grad=worst_o,
                   worst_grad_rel_norm_err=err_o[worst_o])
    del sharded, g_o, g_ro

    def sharded_check(what, tree, key, ep_axis, ref):
        loss_w, g_w, aux_w = ref
        with torch.no_grad():
            aux_s = moe.moe_forward(tree, cfg, tokens, key, ep_axis)[1]
        loss_s, g_s = moe.moe_value_and_grad(tree, cfg, tokens, labels, key, ep_axis)
        if not (rel(loss_s, loss_w) <= F32_LOSS_RTOL and rel(aux_s, aux_w) <= F32_LOSS_RTOL):
            raise AssertionError(f"cp4 moe {what}: loss {loss_s.item()} vs {loss_w.item()}, aux "
                                 f"{aux_s.item()} vs {aux_w.item()} (rel gate {F32_LOSS_RTOL})")
        w, e = f32_check(f" {what}", g_s, g_w, tree)
        return dict(loss=loss_s.item(), loss_reference=loss_w.item(),
                    loss_rel_err=rel(loss_s, loss_w), aux=aux_s.item(), aux_reference=aux_w.item(),
                    worst_grad=w, worst_grad_rel_norm_err=e[w])

    # the whole float32 tree goes before the no-EP run (cp 1's peak again)
    tree_tp = moe.shard_moe_params(params, mesh22, ep_axis="tp")
    tree_no_ep = moe.shard_moe_params(params, api.get_mesh(key4))
    del params
    if on_card:  # NCCL allocates the (cp 2, tp 2) lines' buffers at their first use
        torch.cuda.empty_cache()
    others = {"ep_over_tp_cp2_tp2": sharded_check("ep over tp", tree_tp, key22, "tp", ref22)}
    del tree_tp, ref22
    if on_card:
        torch.cuda.empty_cache()
    others["zero3_no_ep"] = sharded_check("zero3 no ep", tree_no_ep, key4, None, ref_all)
    del tree_no_ep, ref_all
    if on_card:
        torch.cuda.empty_cache()

    cfg_b = moe_config(on_card)
    params = moe.shard_moe_params(moe.init_moe_params(cfg_b, seed=0, device=device),
                                  api.get_mesh(key4), ep_axis="cp")
    losses, shares = [], []
    for _ in range(TRAIN_STEPS):
        with torch.no_grad():
            share = moe.moe_loss_fn(params, cfg_b, tokens, labels, key4, "cp").reshape(1)
        every = [torch.zeros_like(share) for _ in range(cp)]
        dist.all_gather(every, share)
        params, loss = moe.moe_train_step(params, cfg_b, tokens, labels, key4, "cp", lr=TRAIN_LR)
        total = sum(t.item() for t in every)
        if not np.isfinite(loss.item()) or abs(loss.item() - total) > 1e-5 * abs(total):
            raise AssertionError(f"cp4 moe: loss {loss.item()} is not the sum of the shares "
                                 f"{[t.item() for t in every]}")
        losses.append(loss.item())
        shares.append([t.item() for t in every])
    step_ms = _world_ms(
        lambda: moe.moe_train_step(params, cfg_b, tokens, labels, key4, "cp", lr=TRAIN_LR),
        on_card, warmup=1, samples=5)
    cap = int(np.ceil(cfg_b.top_k * (seq // cp) / cfg_b.n_experts * cfg_b.capacity_factor))
    slots = torch.randn((cfg_b.n_experts, cap, cfg_b.dim), generator=gen, device=device).to(
        cfg_b.tdtype)
    with torch.no_grad():
        exchange_ms = _world_ms(lambda: all_to_all(slots, group, 0, 0), on_card)
    res = dict(
        check=dict(dtype="float32", layers=cfg.n_layers, capacity_factor=cfg.capacity_factor,
                   tokens=seq, aux_loss_coef=cfg.aux_loss_coef, aux_cp4=aux4.item(),
                   aux_reference=aux_r.item(), aux_rel_err=aux_rel,
                   aux_cp1_whole_batch=aux1.item(),
                   router_grad_aux_share=router_aux, loss_cp4=loss4.item(),
                   loss_reference=loss_r.item(), loss_rel_err=loss_rel,
                   logits_rel_norm_err=logits_rn, worst_grad=worst, grad_rel_norm_errs=err,
                   cp1_peak_memory_gb=peak_gb,
                   gates=dict(loss_aux_rtol=F32_LOSS_RTOL, rel_norm=F32_GRAD_RNORM),
                   overlap_degree2=degree2, **others),
        train=dict(dtype="bfloat16", layers=cfg_b.n_layers, capacity_factor=cfg_b.capacity_factor,
                   tokens=seq, losses=losses, rank_shares=shares, step_ms=step_ms),
        exchange=dict(slots=[cfg_b.n_experts, cap, cfg_b.dim], bytes_a_rank=slots.numel() * 2,
                      exchanges_a_step=4 * cfg_b.n_layers, ms=exchange_ms),
    )
    del params, slots
    if on_card:
        torch.cuda.empty_cache()
    return res


def cp4_video_dit(device: str) -> dict:
    """``--cp4``'s video DiT at DiT-XL's widths (the ``video_dit`` phase's
    configuration) at cp 4: loss and gradients against a cp 1 run of the
    same weights on this card (bf16; loss rel 1e-2, gradients rel-norm
    2e-2, the train gates), then every rank's ms of an AdamW step
    (``make_optim_train_step``); then in float32 the ZeRO-3 tree
    (``shard_params``) at cp 4 against the replicated tree at cp 4
    (:func:`_f32_step_check`)."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models import video_dit

    on_card = device == "cuda"
    cfg = dit_config(on_card)
    params = video_dit.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    clean, noise = (torch.randn((cfg.seqlen, cfg.in_dim), generator=gen, device=device)
                    for _ in range(2))
    key1 = video_dit.make_video_attn_key(cfg, device=device)
    key4 = video_dit.make_video_attn_key(cfg, cp_group=dist.group.WORLD, device=device)
    loss1, g1 = video_dit.value_and_grad(params, cfg, clean, noise, DIT_TS[0], key1)
    loss4, g4 = video_dit.value_and_grad(params, cfg, clean, noise, DIT_TS[0], key4)
    loss_rel = abs(loss4.item() - loss1.item()) / abs(loss1.item())
    worst, worst_rn, _ = grads_rel_norm(video_dit.param_names(params), g4, g1)
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst_rn <= TRAIN_GRAD_RNORM):
        raise AssertionError(f"cp4 video_dit: loss rel {loss_rel:.3e}, worst gradient {worst} "
                             f"rel-norm {worst_rn:.3e} against cp 1")
    del g1, g4
    optim = torch.optim.AdamW(video_dit.param_list(params), lr=TRAIN_LR)
    step = video_dit.make_optim_train_step(cfg, key4, optim)
    step_ms = _world_ms(lambda: step(params, clean, noise, DIT_TS[1]), on_card, warmup=1,
                        samples=5)
    del params, optim
    cfg32 = dit_config(on_card, dtype="float32")
    whole = video_dit.init_params(cfg32, seed=0, device=device)
    zero3 = _f32_step_check(
        "cp4_video_dit zero3", whole, video_dit.shard_params(whole, api.get_mesh(key4)),
        lambda t, _: video_dit.value_and_grad(t, cfg32, clean, noise, DIT_TS[0], key4),
        video_dit.LAYOUT)
    del whole
    res = dict(tokens=cfg.seqlen, frames=cfg.num_frames, loss_cp4=loss4.item(),
               loss_cp1=loss1.item(), loss_rel_err=loss_rel, worst_grad=worst,
               worst_grad_rel_norm_err=worst_rn, loss_rtol=TRAIN_LOSS_RTOL,
               grad_rnorm=TRAIN_GRAD_RNORM, step_ms=step_ms, zero3_float32=zero3)
    if on_card:
        torch.cuda.empty_cache()
    return res


def _every_rank(x: float) -> list[float]:
    """``x`` of every rank, in rank order."""
    import torch
    import torch.distributed as dist

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mine = torch.tensor([float(x)], dtype=torch.float64, device=device)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return [t.item() for t in every]


def _peak_gb(on_card: bool) -> list[float] | None:
    import torch

    return _every_rank(torch.cuda.max_memory_allocated() / 1e9) if on_card else None


def world_train_steps(what: str, step, n: int, seq: int, n_layers: int, on_card: bool) -> dict:
    """``n`` calls of ``step()`` (a train step returning its loss), the
    ranks leaving a barrier together before each: every rank's ms (host
    clock around a synchronize), the slowest rank's, global tokens/s, the
    FFA launches of each step (on the card: one forward, one delta and one
    backward mode's kernels a layer, :func:`step_launches`) and the
    ``comm.functional`` collectives of each step."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch.comm.functional import (
        collective_counts, reset_collective_counts,
    )
    from magiattention_tpu_torch.kernels import launch_counts

    recs, total, mode = [], {}, None
    for i in range(n):
        before = launch_counts()
        reset_collective_counts()
        dist.barrier()
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = step().item()
        if on_card:
            torch.cuda.synchronize()
        ms = _every_rank((time.perf_counter() - t1) * 1e3)
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if not np.isfinite(loss):
            raise AssertionError(f"{what}: step {i} loss {loss} is not finite")
        if on_card:
            mode = step_launches(f"{what} step {i}", launches, n_layers)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        recs.append(dict(step=i, loss=loss, rank_ms=ms, slowest_ms=max(ms),
                         tokens_per_s=seq / (max(ms) * 1e-3), collectives=collective_counts()))
    return dict(steps=recs, losses=[r["loss"] for r in recs], launches=total, bwd_mode=mode,
                slowest_ms=statistics.median(r["slowest_ms"] for r in recs))


def cp4_zero3(device: str, seq: int) -> dict:
    """Llama-3.1-8B at its widths and all 32 layers (on the CPU rehearsal
    4 small layers) under ZeRO-3 at cp 4: bf16 compute over float32
    masters, ``seq`` tokens in two causal documents, the tree from
    :func:`sharded_llama_init` (``shard_params`` over the key's mesh, no
    rank ever holding the whole tree). One warm step, then TRAIN_STEPS
    timed ``train_step``s (:func:`world_train_steps`): finite losses that
    fall, the launches of B1, B7 and the backward once a layer, one
    all-gather and one reduce-scatter a sharded leaf a step (embed,
    lm_head, seven a layer); every rank's peak memory after the warm step
    against the card's total, and the replicated tree's float32 masters
    and gradients counted on the host (never allocated); then one step
    under ``torch.profiler`` (:func:`profile_run`)."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models.llama import param_list, train_step

    on_card = device == "cuda"
    cfg = llama_config(on_card, n_layers=LLAMA_LAYERS if on_card else 4)
    docs = _docs(seq, seq // 2)
    key = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, cp_group=dist.group.WORLD,
                                 device=device)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = sharded_llama_init(cfg, 0, api.get_mesh(key), device)
    init_s = time.perf_counter() - t0
    init_peak = _peak_gb(on_card)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (seq,), generator=gen, device=device)
    labels = next_token_labels(tokens, seq // 2)

    def step():
        nonlocal params
        params, loss = train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR)
        return loss

    t0 = time.perf_counter()
    warm = step().item()
    warm_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run = world_train_steps("cp4_zero3", step, TRAIN_STEPS, seq, cfg.n_layers, on_card)
    peak = _peak_gb(on_card)
    losses = [warm] + run["losses"]
    # one more step under the profiler on every rank (rank 0's is printed)
    prof = profile_run(step) if on_card else None
    if not losses[-1] < losses[0]:
        raise AssertionError(f"cp4_zero3: the loss does not fall: {losses}")
    sharded_leaves = 2 + 7 * cfg.n_layers
    for rec in run["steps"]:
        c = rec["collectives"]
        if (c.get("all_gather"), c.get("reduce_scatter")) != (sharded_leaves, sharded_leaves):
            raise AssertionError(f"cp4_zero3: step collectives {c}, want {sharded_leaves} "
                                 "all-gathers and reduce-scatters")
    n = llama_param_count(cfg)
    held = sum(p.numel() * p.element_size() for p in param_list(params))
    res = dict(
        model=(f"Llama-3.1-8B widths, {cfg.n_layers} of {LLAMA_LAYERS} layers, bf16 over "
               "float32 masters, seed 0" if on_card else f"small widths, {cfg.n_layers} layers"),
        tokens=seq, documents=2, cp=dist.get_world_size(), parameters=n,
        replicated_masters_and_grads_bytes=8 * n, rank_master_bytes=_every_rank(held),
        init_s=init_s, init_peak_gb=init_peak, warm_step_s=warm_s, warm_loss=warm,
        step_peak_gb=peak, profile_step=prof,
        card_total_gb=torch.cuda.get_device_properties(0).total_memory / 1e9 if on_card else None,
        gathers_a_step=sharded_leaves, reduce_scatters_a_step=sharded_leaves, **run,
    )
    del params
    if on_card:
        torch.cuda.empty_cache()
    return res


def _f32_step_check(what: str, whole: dict, sharded: dict, grads_of, layout) -> dict:
    """One step of the replicated tree ``whole`` and of ``sharded``
    (``grads_of(tree, sharded: bool)`` returns (loss, grads)): loss rel
    F32_LOSS_RTOL, every gradient (gathered) and every parameter after
    one SGD step at TRAIN_LR (gathered) rel-norm F32_GRAD_RNORM."""
    from magiattention_tpu_torch.models.llama import sgd_
    from magiattention_tpu_torch.models.shard import gather_leaves, gather_params

    loss_r, g_r = grads_of(whole, False)
    loss_s, g_s = grads_of(sharded, True)
    names = layout.names(whole)
    worst, worst_rn, _ = grads_rel_norm(names, gather_leaves(g_s, sharded, layout), g_r)
    loss_rel = abs(loss_s.item() - loss_r.item()) / abs(loss_r.item())
    sgd_(layout.leaves(whole), g_r, TRAIN_LR)
    sgd_(layout.leaves(sharded), g_s, TRAIN_LR)
    p_worst, p_rn, _ = grads_rel_norm(names, layout.leaves(gather_params(sharded)),
                                      layout.leaves(whole))
    if not (loss_rel <= F32_LOSS_RTOL and worst_rn <= F32_GRAD_RNORM and p_rn <= F32_GRAD_RNORM):
        raise AssertionError(
            f"{what}: loss rel {loss_rel:.3e} (gate {F32_LOSS_RTOL}), gradient {worst} "
            f"rel-norm {worst_rn:.3e}, parameter {p_worst} rel-norm {p_rn:.3e} (gate "
            f"{F32_GRAD_RNORM}) against the replicated tree")
    return dict(loss_sharded=loss_s.item(), loss_replicated=loss_r.item(), loss_rel_err=loss_rel,
                worst_grad=worst, worst_grad_rel_norm_err=worst_rn, worst_param=p_worst,
                worst_param_rel_norm_err=p_rn,
                gates=dict(loss_rtol=F32_LOSS_RTOL, rel_norm=F32_GRAD_RNORM))


def cp4_zero3_check(device: str, seq: int) -> dict:
    """The ZeRO-3 step in float32 at the same widths and 2 layers at cp 4
    against the replicated trainer's step on the same seed-0 weights and
    tokens (:func:`_f32_step_check`), after :func:`sharded_llama_init`'s
    shards are held equal to ``shard_params(init_params(...))``'s to the
    bit."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models.llama import (
        LAYOUT, init_params, param_list, shard_params, value_and_grad,
    )

    on_card = device == "cuda"
    cfg = llama_config(on_card, dtype="float32")
    docs = _docs(seq, seq // 2)
    key = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, cp_group=dist.group.WORLD,
                                 device=device)
    mesh = api.get_mesh(key)
    whole = init_params(cfg, seed=0, device=device)
    sharded = shard_params(whole, mesh)
    lean = sharded_llama_init(cfg, 0, mesh, device)
    if not all(torch.equal(a, b) for a, b in zip(param_list(lean), param_list(sharded))):
        raise AssertionError("cp4_zero3_check: sharded_llama_init's shards are not shard_params'")
    del lean
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (seq,), generator=gen, device=device)
    labels = next_token_labels(tokens, seq // 2)
    res = _f32_step_check("cp4_zero3_check", whole, sharded,
                          lambda t, _: value_and_grad(t, cfg, tokens, labels, key), LAYOUT)
    res.update(dtype="float32", layers=cfg.n_layers, tokens=seq, init_bitwise=True)
    del whole, sharded
    if on_card:
        torch.cuda.empty_cache()
    return res


def cp4_tp_train(device: str, seq: int) -> dict:
    """Megatron TP x ZeRO-3 at (cp 2, tp 2), the same widths and 2 layers:
    ``shard_params(..., tp_axis="tp")`` and a ``head_axis="tp"`` key.
    bf16: one warm step (each rank's q and kv heads in ``calc_attn``),
    then TRAIN_STEPS timed steps; the same model's ZeRO-3 step at cp 4
    timed the same way beside it. float32: one step against the
    replicated trainer on the same mesh's cp line under a key without
    ``head_axis`` (:func:`_f32_step_check`). Every rank's peak memory of
    the bf16 steps."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.models import llama
    from magiattention_tpu_torch.parallel import ProcessMesh

    on_card = device == "cuda"
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ("cp", "tp"))
    docs = _docs(seq, seq // 2)

    def key_of(**kw):
        return api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, mesh=mesh, cp_axis="cp",
                                      device=device, **kw)

    key_tp = key_of(head_axis="tp")
    cfg = llama_config(on_card)
    gen = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (seq,), generator=gen, device=device)
    labels = next_token_labels(tokens, seq // 2)
    runs = {}
    for name, shard_mesh, key, kw in (
        ("tp_cp2_tp2", mesh, key_tp, {"tp_axis": "tp"}),
        ("zero3_cp4", None, None, {}),
    ):
        if key is None:
            key = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq,
                                         cp_group=dist.group.WORLD, device=device)
            shard_mesh = api.get_mesh(key)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = sharded_llama_init(cfg, 0, shard_mesh, device, **kw)
        heads, calc = [], llama.calc_attn

        def recording(q, k, v, attn_key):
            heads.append([q.shape[1], k.shape[1]])
            return calc(q, k, v, attn_key)

        def step(key=key):
            nonlocal params
            params, loss = llama.train_step(params, cfg, tokens, labels, key, lr=TRAIN_LR)
            return loss

        llama.calc_attn = recording
        try:
            warm = step().item()
        finally:
            llama.calc_attn = calc
        run = world_train_steps(f"cp4_tp_train {name}", step, TRAIN_STEPS, seq, cfg.n_layers,
                                on_card)
        runs[name] = dict(warm_loss=warm, heads_a_layer=heads, peak_gb=_peak_gb(on_card), **run)
        del params
    want = [[cfg.n_heads // 2, cfg.n_kv_heads // 2]] * cfg.n_layers
    if runs["tp_cp2_tp2"]["heads_a_layer"] != want:
        raise AssertionError(f"cp4_tp_train: calc_attn saw heads {runs['tp_cp2_tp2']['heads_a_layer']}"
                             f", want {want}")
    cfg32 = llama_config(on_card, dtype="float32")
    whole = llama.init_params(cfg32, seed=0, device=device)
    sharded = llama.shard_params(whole, mesh, tp_axis="tp")
    key_cp = key_of()  # the cp line without head_axis: every head on every rank
    check = _f32_step_check(
        "cp4_tp_train", whole, sharded,
        lambda t, tp: llama.value_and_grad(t, cfg32, tokens, labels, key_tp if tp else key_cp),
        llama.LAYOUT)
    del whole, sharded
    if on_card:
        torch.cuda.empty_cache()
    return dict(mesh="(cp 2, tp 2)", tokens=seq, layers=cfg.n_layers, runs=runs,
                check=dict(dtype="float32", **check))


# ---------------------------------------------------------------------------
# the observability and resilience planes
# ---------------------------------------------------------------------------

# the resilience flags: set only inside the phases below (through _with_env)
RESILIENCE_FLAGS = (
    "MAGI_ATTENTION_FALLBACK", "MAGI_ATTENTION_FAULT_INJECT", "MAGI_ATTENTION_NUMERIC_GUARD",
    "MAGI_ATTENTION_STEP_RETRIES", "MAGI_ATTENTION_STRAGGLER_DETECT",
)
# the plan tiers' flags: set only inside their own phases, over a fresh
# temporary directory (a stale store directory must not feed any phase)
PLAN_FLAGS = (
    "MAGI_ATTENTION_VERIFY_PLANS", "MAGI_ATTENTION_PLAN_STORE", "MAGI_ATTENTION_PLAN_BROADCAST",
)


def resilience_flags_set() -> list[str]:
    """The resilience and plan-tier flags set in the environment: the
    script refuses to start with any, its phases set them themselves."""
    import os

    return [name for name in RESILIENCE_FLAGS + PLAN_FLAGS if os.environ.get(name)]


def resilience_counts() -> dict[str, int]:
    """The resilience actions since telemetry's last reset (the
    ``resilience.*`` counters, kept with telemetry off too)."""
    from magiattention_tpu_torch import telemetry

    return telemetry.counters("resilience.")


def _counts_delta(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def _cp_inputs(device: str = "cuda", seq: int = CP_SEQ, seed: int = 11):
    """bf16 q, k, v and dO at the train attention shape."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ((seq, CP_HQ, CP_D), (seq, CP_HK, CP_D), (seq, CP_HK, CP_D))
    inputs = [torch.randn(sh, generator=gen, device=device).to(torch.bfloat16) for sh in shapes]
    return inputs, (torch.randn(shapes[0], generator=gen, device=device) / 4).to(torch.bfloat16)


def _cp1_key(seq: int = CP_SEQ, device: str = "cuda"):
    from magiattention_tpu_torch import api

    docs = _docs(seq, seq // 2)
    return api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, device=device)


def _key_step(key, inputs, do, grads: bool = True):
    """out (natural order), then dq, dk, dv with ``grads``, of one step
    through ``key``'s API path."""
    import torch

    from magiattention_tpu_torch import api

    q, k, v = (t.detach().requires_grad_(grads) for t in inputs)
    with torch.set_grad_enabled(grads):
        out_d, _ = api.calc_attn(
            api.dispatch(q, key), api.dispatch(k, key, role="kv"), api.dispatch(v, key, role="kv"), key,
        )
        out = api.undispatch(out_d, key)
    if not grads:
        return (out,)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


def _fresh_planning() -> None:
    """Forget every planned runtime and solved plan (the next key plans)."""
    from magiattention_tpu_torch.api.magi_attn_interface import clear_cache
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _PLAN_CACHE
    from magiattention_tpu_torch.kernels.ffa_plan import _cached_plan

    clear_cache()
    _PLAN_CACHE.clear()
    _cached_plan.cache_clear()


def _records(directory: str) -> list[dict]:
    import glob
    import os

    rows = []
    for path in glob.glob(os.path.join(directory, "*.jsonl")):
        with open(path) as f:
            rows += [json.loads(line) for line in f]
    return sorted(rows, key=lambda r: r["seq"])


def _trace_events(path: str) -> list[dict]:
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _launches_in_scope(events: list[dict], kernel: str, scope: str) -> tuple[int, int]:
    """(kernels whose name holds ``kernel``, those launched inside a
    ``scope`` range): the launch (the CUDA runtime or driver call with the
    kernel's correlation id) within one of the scope's host ranges on its
    thread, or the kernel within one of the scope's device projections."""
    kernels = [e for e in events if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    launches = {
        e["args"]["correlation"]: e for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    host = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == scope]
    dev = [e for e in events if e.get("cat") == "gpu_user_annotation" and e.get("name") == scope]

    def within(e, ranges, same_tid: bool) -> bool:
        return any(
            r["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0) <= r["ts"] + r.get("dur", 0)
            and (not same_tid or r.get("tid") == e.get("tid"))
            for r in ranges
        )

    inside = 0
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if (launch is not None and within(launch, host, True)) or within(k, dev, False):
            inside += 1
    return len(kernels), inside


# steps in one profiler window, and windows tried
OBS_PROFILED_STEPS, OBS_PROFILE_ATTEMPTS = 3, 3
# steps a loop that runs ahead, and its rounds (off and on each)
OBS_AHEAD_STEPS, OBS_AHEAD_ROUNDS = 20, 4
# ~20 ms of device sleep on an H100 (1.98 GHz): longer than the host's
# part of a warm call
OBS_SLEEP_CYCLES = 40_000_000
# every scope the cp 1 path reaches (forward, backward, dispatch)
OBS_SCOPES = (
    "DistAttnRuntime.calc_attn", "ffa_fwd_stage0", "ffa_bwd_delta", "ffa_bwd",
    "dispatch_func", "undispatch_func",
)
# kernel name (a substring of the CUDA symbol) -> the scope its launches sit in
OBS_KERNEL_SCOPES = (
    ("B1", "ffa_fwd_tc_kernel", "ffa_fwd_stage0"),
    ("B7", "ffa_bwd_delta_kernel", "ffa_bwd_delta"),
    ("B8/B9", "ffa_bwd_kv_tc_kernel", "ffa_bwd"),
)


def observability_phase() -> dict:
    """Telemetry and profiling on the cp 1 API path at the train attention
    shape (``cp_api``'s): the step's cost with MAGI_ATTENTION_TELEMETRY on
    against off (``paired_ms``, which syncs every step, and a loop of
    ``OBS_AHEAD_STEPS`` steps that runs ahead); the JSONL of a freshly
    planned step (``plan_solve``, ``ffa_plan``, ``attn_step``; its
    host-exact fields against this phase's recomputation, ``device_ms``
    within 0.5-2x of the phase's own CUDA events around the same call,
    ``bwd_device_ms`` within 0.5-1x of the phase's pair around the whole
    backward, of which the attention's is the most); a step under
    MAGI_ATTENTION_PROFILE_MODE=1 and ``torch.profiler`` (every scope the
    path reaches, B1 launched inside ``ffa_fwd_stage0``, B7 inside
    ``ffa_bwd_delta``, B8/B9 inside ``ffa_bwd``); a registry decision
    persisted to a store, the in-process state reset, and resolved again
    from source ``policy`` with no heuristic run."""
    import os
    import tempfile

    import torch

    from magiattention_tpu_torch import telemetry
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.kernels import launch_counts, reset_launch_counts
    from magiattention_tpu_torch.kernels import registry as kreg
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode
    from magiattention_tpu_torch.kernels.ffa_plan import QE, QS
    from magiattention_tpu_torch.telemetry import store as tstore
    from magiattention_tpu_torch.utils.profiling import switch_profile

    inputs, do = _cp_inputs()
    res: dict = {"shape": f"bf16 q [{CP_SEQ}, {CP_HQ}, {CP_D}], k/v [{CP_SEQ}, {CP_HK}, {CP_D}], "
                          "two causal documents, cp 1"}
    torch.cuda.synchronize()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        tel = {"MAGI_ATTENTION_TELEMETRY": "1",
               "MAGI_ATTENTION_TELEMETRY_DIR": os.path.join(tmp, "overhead"),
               "MAGI_ATTENTION_STORE_DIR": os.path.join(tmp, "store")}
        telemetry.reset()
        key = _cp1_key()

        def step():
            return _key_step(key, inputs, do)

        times = paired_ms({"off": step, "on": lambda: _with_env(tel, step)}, rounds=7, samples=5)
        _with_env(tel, telemetry.flush)
        off, on = statistics.median(times["off"]), statistics.median(times["on"])
        res["fwd_bwd_ms"] = dict(telemetry_off=times["off"], telemetry_on=times["on"],
                                 median_off=off, median_on=on, overhead_ms=on - off,
                                 overhead_share=(on - off) / off)

        # the same step in a loop that runs ahead: OBS_AHEAD_STEPS steps
        # launched back to back under one event pair (no sync between
        # them), off and on alternating, their order turned each round
        def ahead():
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(OBS_AHEAD_STEPS):
                step()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / OBS_AHEAD_STEPS

        loops = {"off": [], "on": []}
        for r in range(OBS_AHEAD_ROUNDS):
            for name in (("off", "on") if r % 2 == 0 else ("on", "off")):
                loops[name].append(_with_env(tel, ahead) if name == "on" else ahead())
        _with_env(tel, telemetry.flush)
        off, on = statistics.median(loops["off"]), statistics.median(loops["on"])
        res["run_ahead_ms"] = dict(steps_a_loop=OBS_AHEAD_STEPS, telemetry_off=loops["off"],
                                   telemetry_on=loops["on"], median_off=off, median_on=on,
                                   overhead_ms=on - off, overhead_share=(on - off) / off)

        # (b) the records of a step planned with telemetry on
        _fresh_planning()
        telemetry.reset()
        rec_dir = os.path.join(tmp, "records")

        def recorded():
            from magiattention_tpu_torch import api

            k_ = _cp1_key()
            _key_step(k_, inputs, do)  # the cold step: planning's records
            q, kk, v = (t.detach().requires_grad_(True) for t in inputs)
            args = (api.dispatch(q, k_), api.dispatch(kk, k_, role="kv"), api.dispatch(v, k_, role="kv"))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            # a warm step (its plans on the card): the device sleeps while
            # the host runs the call (the record's payload too), so both
            # event pairs time the forward's kernels back to back, not the
            # host between them
            torch.cuda._sleep(OBS_SLEEP_CYCLES)
            start.record()
            out_d, _ = api.calc_attn(*args, k_)
            end.record()
            # the backward likewise, its pair around the whole autograd
            # pass (the record's pair holds the attention's part of it)
            out = api.undispatch(out_d, k_)
            b_start, b_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(OBS_SLEEP_CYCLES)
            b_start.record()
            torch.autograd.grad(out, (q, kk, v), do)
            b_end.record()
            telemetry.flush()
            b_end.synchronize()
            return k_, start.elapsed_time(end), b_start.elapsed_time(b_end)

        key2, own_ms, own_bwd_ms = _with_env({**tel, "MAGI_ATTENTION_TELEMETRY_DIR": rec_dir}, recorded)
        recs = _records(rec_dir)
        kinds = [r["kind"] for r in recs]
        for kind in ("plan_solve", "ffa_plan", "attn_step"):
            if kind not in kinds:
                raise AssertionError(f"observability: no {kind} record in {sorted(set(kinds))}")
        step_rec = [r for r in recs if r["kind"] == "attn_step"][-1]
        rt = _mgr(key2).runtime
        band = sum(n * (n + 1) // 2 for n in (CP_SEQ // 2, CP_SEQ // 2))  # two causal documents
        padded = sum(p.num_work * p.block_q * p.block_k for p in rt.plans)
        real = [int((p.meta[:, QE] > p.meta[:, QS]).sum()) * p.block_q * p.block_k for p in rt.plans]
        plan_recs = [r for r in recs if r["kind"] == "ffa_plan"]
        recompute = dict(band_elems=band, padded_elems=padded, payload_bytes_total=0,
                         wire_bytes_total=0, est_flops_fwd=4 * band * CP_D * CP_HQ)
        got = {f: step_rec[f] for f in recompute}
        if got != recompute or step_rec["stages"] != [] or not set(real) <= {
                r["padded_elems"] for r in plan_recs if r["band_elems"] == band}:
            raise AssertionError(f"observability: records {got} against {recompute}, plans "
                                 f"{[r['padded_elems'] for r in plan_recs]} against {real}")
        ratio = step_rec["device_ms"] / own_ms
        if not 0.5 <= ratio <= 2.0:
            raise AssertionError(f"observability: device_ms {step_rec['device_ms']:.4f} against the "
                                 f"phase's {own_ms:.4f} ms (ratio {ratio:.3f})")
        bwd_ratio = step_rec.get("bwd_device_ms", 0.0) / own_bwd_ms
        if not 0.5 <= bwd_ratio <= 1.0:
            raise AssertionError(f"observability: bwd_device_ms {step_rec.get('bwd_device_ms')} against "
                                 f"the phase's {own_bwd_ms:.4f} ms (ratio {bwd_ratio:.3f})")
        res["records"] = dict(kinds={k: kinds.count(k) for k in sorted(set(kinds))},
                              attn_step_fields=got, ffa_plan_padded=[r["padded_elems"] for r in plan_recs],
                              device_ms=step_rec["device_ms"], phase_event_ms=own_ms,
                              wall_ms=step_rec["wall_ms"], device_over_phase=ratio,
                              bwd_device_ms=step_rec["bwd_device_ms"], phase_bwd_event_ms=own_bwd_ms,
                              bwd_device_over_phase=bwd_ratio)

        # (c) the profiler's view
        prof_env = {"MAGI_ATTENTION_PROFILE_MODE": "1", "MAGI_ATTENTION_BACKEND_FFA_BWD": "fused"}

        def profiled(attempt: int):
            k_ = _cp1_key()
            _key_step(k_, inputs, do)  # warm
            torch.cuda.synchronize()
            with switch_profile(log_dir=os.path.join(tmp, f"trace{attempt}")) as sp:
                for _ in range(OBS_PROFILED_STEPS):
                    _key_step(k_, inputs, do)
                torch.cuda.synchronize()
            return sp.trace_path

        # late in a long process the profiler can drop a window's first
        # kernel records (PERF.md §6): a window of several steps, and a
        # new window where a kernel of the path shows no record at all
        for attempt in range(OBS_PROFILE_ATTEMPTS):
            events = _trace_events(_with_env(prof_env, lambda: profiled(attempt)))
            found = {label: _launches_in_scope(events, kernel, scope)
                     for label, kernel, scope in OBS_KERNEL_SCOPES}
            if all(n for n, _ in found.values()):
                break
        names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
        missing = [s_ for s_ in OBS_SCOPES if s_ not in names]
        if missing:
            raise AssertionError(f"observability: scopes {missing} not in the trace")
        inside = {}
        for label, kernel, scope in OBS_KERNEL_SCOPES:
            n, n_in = found[label]
            if n == 0 or n_in != n:
                kernels = sum(e.get("cat") == "kernel" for e in events)
                raise AssertionError(f"observability: {n_in} of {n} {label} launches inside {scope} "
                                     f"({kernels} kernel records in the trace, {attempt + 1} windows)")
            inside[label] = dict(scope=scope, kernel_records=n, inside=n_in)
        inside["windows"] = attempt + 1
        res["profile"] = dict(scopes=sorted(s for s in names if s), kernels_in_scopes=inside)

        # (d) a persisted registry decision comes back from the store
        def persist():
            rt_ = _mgr(key).runtime
            plan, params = rt_.plans[0], rt_._params(CP_D, 2)[0]
            kreg.reset_registry()
            tstore.reset()
            first = ffa_bwd_mode(plan, params, CP_D, CP_D, 2, CP_HQ, CP_HK)
            heuristic = kreg.stats()["heuristic_calls"]
            tstore.get_store().compact()
            kreg.reset_registry()
            tstore.reset()
            again = ffa_bwd_mode(plan, params, CP_D, CP_D, 2, CP_HQ, CP_HK)
            return first, heuristic, again, kreg.stats(), kreg.get_registry().last("ffa_bwd")

        first, heuristic, again, st, _ = _with_env(tel, persist)
        kreg.reset_registry()
        tstore.reset()
        telemetry.reset()
        if not (heuristic == 1 and again == first and st["store_hits"] == 1 and st["heuristic_calls"] == 0):
            raise AssertionError(f"observability: persisted {first!r}, resolved {again!r}, {st}")
        res["registry_policy"] = dict(decision="ffa_bwd", choice=first, first_heuristic_calls=heuristic,
                                      after_reset=st)
    torch.cuda.synchronize()
    res["launches"] = {k: n for k, n in launch_counts().items() if n}
    check_launches("observability", launch_counts(), ("ffa_fwd", "ffa_bwd_delta", "ffa_bwd_fused"))
    emit({"phase": "observability", **res})
    return res


FFA_128 = {"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "128"}
FFA_128x64 = {"MAGI_ATTENTION_FFA_BLOCK_Q": "128", "MAGI_ATTENTION_FFA_BLOCK_K": "64"}


def _same_bits(what: str, got, want) -> None:
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: not equal to the bit")


def resilience_phase(ctx: dict) -> dict:
    """The resilience plane on the card, on ``cp_api``'s shape, each case
    under its own flags: ``kernel_lowering:count=1`` without
    MAGI_ATTENTION_FALLBACK raises ``InjectedFault``; with it, tiles pinned
    128 x 128, exactly one ladder hop (to 128 x 64, recorded), out and
    gradients bitwise the run pinned there (deterministic mode both); at
    ``p=1.0`` the tile ladder is walked and the chain raises
    ``FallbackExhaustedError``, twice, nothing pinned, no plain version
    run (on the card the layer moves only from kernel to kernel); a fused
    backward that fails falls to split, bitwise the split pin;
    ``nan_output`` under MAGI_ATTENTION_NUMERIC_GUARD=raise raises naming
    the stage, under ``record`` only the counter moves;
    MAGI_ATTENTION_STEP_RETRIES=1 re-runs ``ffa`` (the last kernel rung,
    never quarantined) bitwise the unfaulted step, and a lasting fault
    re-raises; a ``serve_decode`` fault on the serve phase's engine (one
    token a tick, then spec_tokens 4) descends a rung to ``gather_ffa``,
    rows within the serve tolerance of the replay oracle; the guard's cost
    in ms a step."""
    import os
    import tempfile

    import torch

    from magiattention_tpu_torch import telemetry
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.kernels import PLAIN_NAMES, launch_counts, reset_launch_counts
    from magiattention_tpu_torch.resilience import inject, watchdog
    from magiattention_tpu_torch.resilience.errors import (
        FallbackExhaustedError, InjectedFault, NumericGuardError,
    )
    from magiattention_tpu_torch.serving import ServeEngine

    inputs, do = _cp_inputs()
    res: dict = {"shape": f"bf16 q [{CP_SEQ}, {CP_HQ}, {CP_D}], k/v [{CP_SEQ}, {CP_HK}, {CP_D}], "
                          "two causal documents, cp 1"}
    det = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    fault = "MAGI_ATTENTION_FAULT_INJECT"
    fb = {"MAGI_ATTENTION_FALLBACK": "1"}
    launches: dict = {}
    own: dict = {}  # the resilience actions of the phase's cases

    def case(env: dict, fn, tmp: str | None = None):
        """``fn()`` under ``env`` (and telemetry into ``tmp``), fresh
        injector and telemetry state; returns (result, telemetry summary,
        resilience counts of the case, launches of the case)."""
        inject.reset()
        telemetry.reset()
        if tmp is not None:
            env = {**env, "MAGI_ATTENTION_TELEMETRY": "1", "MAGI_ATTENTION_TELEMETRY_DIR": tmp}
        torch.cuda.synchronize()
        reset_launch_counts()
        before = resilience_counts()

        def run():
            out = fn()
            return out, telemetry.summary()

        out, summary = _with_env(env, run)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k_, n in counts.items():
            launches[k_] = launches.get(k_, 0) + n
        acted = _counts_delta(before, resilience_counts())
        for k_, n in acted.items():
            own[k_] = own.get(k_, 0) + n
        telemetry.reset()
        return out, summary, acted, counts

    def step():
        return _key_step(_cp1_key(), inputs, do)

    with tempfile.TemporaryDirectory() as tmp:
        # (a) no fallback: the fault propagates, typed
        try:
            case({fault: "kernel_lowering:count=1"}, step)
        except InjectedFault as e:
            res["no_fallback"] = dict(raised=type(e).__name__, site=e.site)
        else:
            raise AssertionError("resilience: kernel_lowering without fallback did not raise")

        # (b) one ladder hop from 128 x 128
        pinned, *_ = case({**det, **FFA_128x64}, step)

        def hop():
            k_ = _cp1_key()
            rt = _mgr(k_).runtime
            tiles = (rt._bq, rt._bk)
            return _key_step(k_, inputs, do), tiles, (rt._bq, rt._bk)

        (got, start, end), summ, counts, _ = case(
            {**det, **FFA_128, fault: "kernel_lowering:count=1", **fb}, hop, os.path.join(tmp, "hop"))
        last = summ["last"]["resilience"]
        if (start, end) != ((128, 128), (128, 64)) or counts.get("resilience.recovered") != 1 \
                or (last["action_detail"], last["blocks"]) != ("ladder_hop", [128, 64]):
            raise AssertionError(f"resilience: ladder {start} -> {end}, {counts}, {last}")
        _same_bits("resilience: the hop against the 128 x 64 pin", got, pinned)
        res["ladder_hop"] = dict(start=list(start), rung=list(end), counts=counts,
                                 recovered=dict(action_detail=last["action_detail"], blocks=last["blocks"]),
                                 bitwise_vs_pinned_rung=True)
        del got, pinned

        # (c) every FFA attempt fails: the tile ladder is walked, then the
        # chain raises (no plain rung in a kernel's place on the card), and
        # nothing is pinned: the next step fails the same way
        def exhausted():
            k_ = _cp1_key()
            causes = []
            for _ in range(2):
                try:
                    _key_step(k_, inputs, do, grads=False)
                except FallbackExhaustedError as e:
                    causes.append(type(e.__cause__).__name__)
            rt = _mgr(k_).runtime
            return causes, rt.backend, (rt._bq, rt._bk)

        (causes, backend, tiles), _, counts, lc = case(
            {**FFA_128, fault: "kernel_lowering:p=1.0", **fb}, exhausted)
        plain = {k_: lc[k_] for k_ in PLAIN_NAMES if lc[k_]}
        if causes != ["InjectedFault"] * 2 or backend != "ffa" or plain \
                or counts.get("resilience.recovered") or counts.get("resilience.injected") != 5:
            raise AssertionError(f"resilience: exhausted chain {causes}, {backend}, {counts}, plain {plain}")
        res["exhausted_chain"] = dict(raised="FallbackExhaustedError", causes=causes, backend=backend,
                                      tiles_after=list(tiles), counts=counts, plain_calls=plain)

        # (d) the fused backward fails: split, bitwise the split pin
        split, *_ = case({"MAGI_ATTENTION_BACKEND_FFA_BWD": "split"}, step)
        got, summ, counts, lc = case(
            {"MAGI_ATTENTION_BACKEND_FFA_BWD": "fused", fault: "kernel_lowering:step=2", **fb}, step,
            os.path.join(tmp, "fused"))
        if summ["last"]["resilience"]["action_detail"] != "fused_bwd_to_split" or lc["ffa_bwd_fused"]:
            raise AssertionError(f"resilience: fused fallback {summ['last']['resilience']}, {lc}")
        _same_bits("resilience: fused-to-split against the split pin", got, split)
        res["fused_to_split"] = dict(counts=counts, bitwise_vs_split_pin=True,
                                     launches={k: lc[k] for k in ("ffa_bwd_dq", "ffa_bwd_dkv", "ffa_bwd_fused")})
        del got, split

        # (e) the numeric guard
        try:
            case({fault: "nan_output", "MAGI_ATTENTION_NUMERIC_GUARD": "raise"}, step)
        except NumericGuardError as e:
            if e.stage != "DistAttnRuntime.calc_attn":
                raise AssertionError(f"resilience: guard names {e.stage}")
            raised = dict(stage=e.stage, detail=e.detail)
        else:
            raise AssertionError("resilience: nan_output under the raising guard passed")
        (out,), _, counts, _ = case(
            {fault: "nan_output:step=1", "MAGI_ATTENTION_NUMERIC_GUARD": "record"},
            lambda: _key_step(_cp1_key(), inputs, do, grads=False))
        if counts != {"resilience.injected": 1, "resilience.guard_trip": 1} or not torch.isnan(out).any():
            raise AssertionError(f"resilience: record policy {counts}")
        res["numeric_guard"] = dict(raise_policy=raised, record_policy_counts=counts)
        del out

        # (f) the step watchdog on the card: the retry re-runs ``ffa`` (the
        # last kernel rung, never quarantined), bitwise the unfaulted step;
        # a lasting fault re-raises; no plain rung
        ffa_ref, *_ = case(det, lambda: _key_step(_cp1_key(), inputs, do, grads=False))

        def watched():
            k_ = _cp1_key()
            out = _key_step(k_, inputs, do, grads=False)[0]
            rt = _mgr(k_).runtime
            return out, rt.backend, watchdog.is_quarantined(watchdog._decision_key(rt), "ffa")

        (out, backend, quarantined), summ, counts, lc = case(
            {**det, "MAGI_ATTENTION_STEP_RETRIES": "1", fault: "kernel_lowering:count=1"}, watched,
            os.path.join(tmp, "watchdog"))
        plain = {k_: lc[k_] for k_ in PLAIN_NAMES if lc[k_]}
        if backend != "ffa" or quarantined or plain or counts != {
                "resilience.injected": 1, "resilience.retry": 1, "resilience.recovered": 1}:
            raise AssertionError(f"resilience: watchdog {backend}, quarantined {quarantined}, {counts}, "
                                 f"plain {plain}")
        _same_bits("resilience: the watchdog's retry against the unfaulted step", (out,), ffa_ref)

        def lasting():
            try:
                _key_step(_cp1_key(), inputs, do, grads=False)
            except InjectedFault as e:
                return type(e).__name__
            return None

        raised, _, lasting_counts, lc = case(
            {"MAGI_ATTENTION_STEP_RETRIES": "1", fault: "kernel_lowering:p=1.0"}, lasting)
        plain = {k_: lc[k_] for k_ in PLAIN_NAMES if lc[k_]}
        if raised != "InjectedFault" or plain:
            raise AssertionError(f"resilience: a lasting fault under the watchdog {raised}, plain {plain}")
        res["watchdog"] = dict(rung=backend, quarantined_ffa=quarantined, counts=counts,
                               bitwise_vs_unfaulted=True, lasting_fault=dict(raised=raised,
                                                                            counts=lasting_counts))
        del out, ffa_ref
        torch.cuda.empty_cache()

        # (g) the serve ladder: one token a tick (B10), then spec verify (B11)
        model = ctx["model"]
        serve = {}
        for name, config, kernel in (
            ("decode", ctx["config"], "paged_decode"),
            ("spec4", dataclasses.replace(ctx["config"], spec_tokens=4), "paged_decode_spec"),
        ):
            reqs = ctx["requests"](model)
            _, summ, counts, lc = case({fault: "serve_decode:count=2", **fb},
                                       lambda: ServeEngine(model, config).run(reqs),
                                       os.path.join(tmp, f"serve_{name}"))
            worst = rows_err(f"resilience serve_decode {name}", reqs, ctx["reference"])
            detail = summ["last"]["resilience"]["action_detail"]
            if counts.get("resilience.fallback") != 2 or detail != f"{kernel}_to_gather_ffa" or not lc[kernel]:
                raise AssertionError(f"resilience: serve {name} {counts}, {detail}, {lc}")
            serve[name] = dict(counts=counts, hop=detail, launches={kernel: lc[kernel]},
                               oracle_max_abs_err=worst[0], oracle_rel_norm_err=worst[1])
        res["serve_decode"] = dict(serve, atol=SERVE_ATOL, rnorm=SERVE_RNORM)

        # (h) the guard's cost a step
        key = _cp1_key()

        def plain():
            return _key_step(key, inputs, do)

        times = paired_ms({"off": plain, "guard": lambda: _with_env(
            {"MAGI_ATTENTION_NUMERIC_GUARD": "raise"}, plain)}, rounds=7, samples=5)
        off, on = statistics.median(times["off"]), statistics.median(times["guard"])
        res["guard_cost"] = dict(off=times["off"], guard=times["guard"], median_off=off,
                                 median_guard=on, ms_per_step=on - off)
    res["launches"] = {k: n for k, n in launches.items() if n}
    res["counts"] = own
    if any(launches.get(k) for k in PLAIN_NAMES):
        raise AssertionError(f"resilience: a plain version ran on the card: {res['launches']}")
    # B1, B7, the fused-to-split rung's B3 and B5/B6, B10 and B11 (B8/B9:
    # the observability phase)
    for k in ("ffa_fwd", "ffa_bwd_delta", "ffa_bwd_dq", "ffa_bwd_dkv", "paged_decode",
              "paged_decode_spec"):
        if not launches.get(k):
            raise AssertionError(f"resilience: {k} never launched: {res['launches']}")
    emit({"phase": "resilience", **res})
    return res


def _cp4_key(device: str, seq: int, **kw):
    import torch.distributed as dist

    from magiattention_tpu_torch import api

    docs = _docs(seq, seq // 2)
    return api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, cp_group=dist.group.WORLD,
                                  device=device, chunk_size=min(512, seq // 8), **kw)


def _rank_step(key, inputs, do):
    """out, dq, dk, dv of this rank's dispatched rows through ``key``."""
    import torch

    from magiattention_tpu_torch import api

    ls = [api.dispatch(inputs[0], key), api.dispatch(inputs[1], key, role="kv"),
          api.dispatch(inputs[2], key, role="kv")]
    ls = [t.detach().requires_grad_(True) for t in ls]
    out, _ = api.calc_attn(*ls, key)
    return (out.detach(), *torch.autograd.grad(out, ls, api.dispatch(do, key)))


def cp4_resilience(device: str, seq: int) -> dict:
    """cp 4: every rank carries the same ``kernel_lowering:count=1`` spec
    with MAGI_ATTENTION_FALLBACK=1 at tiles 128 x 128 (deterministic
    mode): every rank takes the one hop to 128 x 64 at the same call, no
    rank hangs (the group's timeout bounds it), and every rank's out and
    gradients equal its run pinned at 128 x 64 to the bit. Then the agreed
    retry (ROADMAP C9): a NaN on rank 0 alone under
    MAGI_ATTENTION_STEP_RETRIES=1 and the guard, every rank hops once (on
    the card the rung is the ``ffa`` kernels again), each bitwise its
    unfaulted step; and the agreement's cost, a step with the watchdog on
    against off (alternating rounds) and the flag's all-reduce alone."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.resilience import inject

    inputs, do = _cp_inputs(device, seq, seed=31)
    det = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    pinned = _with_env({**det, **FFA_128x64}, lambda: _rank_step(_cp4_key(device, seq), inputs, do))
    inject.reset()
    before = resilience_counts()
    t0 = time.perf_counter()

    def faulted():
        key = _cp4_key(device, seq)
        got = _rank_step(key, inputs, do)
        rt = _mgr(key).runtime
        return got, (rt._bq, rt._bk), rt.num_stages

    got, tiles, stages = _with_env(
        {**det, **FFA_128, "MAGI_ATTENTION_FAULT_INJECT": "kernel_lowering:count=1",
         "MAGI_ATTENTION_FALLBACK": "1"}, faulted)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts_delta(before, resilience_counts())
    same = all(torch.equal(a, b) for a, b in zip(got, pinned))
    hops = torch.tensor([counts.get("resilience.recovered", 0), int(same)], device=device)
    every = [torch.zeros_like(hops) for _ in range(dist.get_world_size())]
    dist.all_gather(every, hops)
    every = [t.tolist() for t in every]
    if any(h != [1, 1] for h in every) or tiles != (128, 64):
        raise AssertionError(f"cp4_resilience: ranks' (hops, bitwise) {every}, tiles {tiles}")
    return dict(spec="kernel_lowering:count=1", start=[128, 128], rung=list(tiles), stages=stages,
                ranks_hops_bitwise=every, faulted_step_wall_s=_every_rank(wall), counts=counts,
                agreed_retry=cp4_agreed_retry(device, seq, inputs, do))


def cp4_agreed_retry(device: str, seq: int, inputs, do) -> dict:
    """The step watchdog's agreed retry at cp 4 (see :func:`cp4_resilience`)."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.resilience import inject, watchdog

    on_card = device == "cuda"
    det = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    on = {**det, "MAGI_ATTENTION_STEP_RETRIES": "1"}
    # the rung the hop lands on: the ffa kernels again on the card (no plain
    # rung there), sdpa in a rehearsal on the CPU
    rung = {"MAGI_ATTENTION_KERNEL_BACKEND": "ffa" if on_card else "sdpa"}
    base = _with_env({**det, **rung}, lambda: _rank_step(_cp4_key(device, seq), inputs, do))
    nan_env = {**on, "MAGI_ATTENTION_NUMERIC_GUARD": "raise"}
    if dist.get_rank() == 0:
        nan_env["MAGI_ATTENTION_FAULT_INJECT"] = "nan_output:count=1"
    inject.reset()
    watchdog.reset()
    before = resilience_counts()
    got = _with_env(nan_env, lambda: _rank_step(_cp4_key(device, seq), inputs, do))
    counts = _counts_delta(before, resilience_counts())
    inject.reset()
    watchdog.reset()
    same = all(torch.equal(a, b) for a, b in zip(got, base))
    mine = torch.tensor([counts.get("resilience.recovered", 0), counts.get("resilience.retry", 0),
                         int(same)], device=device)
    every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    every = [t.tolist() for t in every]
    if any(h != [1, 1, 1] for h in every):
        raise AssertionError(f"cp4_resilience agreed retry: ranks' (hops, retries, bitwise) {every}")
    # the agreement's cost: a step with the watchdog on (one flag reduced)
    # against off, in alternating rounds, and the flag's all-reduce alone
    keys = {"off": _with_env(det, lambda: _cp4_key(device, seq)),
            "on": _with_env(on, lambda: _cp4_key(device, seq))}
    rounds: dict = {"off": [], "on": []}
    for _ in range(2):
        for name, env in (("off", det), ("on", on)):
            rounds[name].append(_with_env(env, lambda: _world_ms(
                lambda: _rank_step(keys[name], inputs, do), on_card, samples=10)))
    runtime = _mgr(keys["on"]).runtime
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        runtime.agree_step_failure(False, torch.device(device))
    agree_ms = (time.perf_counter() - t0) * 1e3 / 20
    return dict(
        fault="nan_output:count=1 on rank 0 alone", rung=rung["MAGI_ATTENTION_KERNEL_BACKEND"],
        ranks_hops_retries_bitwise=every,
        counts=counts, step_ms_watchdog_off=rounds["off"], step_ms_watchdog_on=rounds["on"],
        agreement_ms_every_rank=_every_rank(agree_ms),
        median_slowest_off=statistics.median(max(r) for r in rounds["off"]),
        median_slowest_on=statistics.median(max(r) for r in rounds["on"]),
    )


# ---------------------------------------------------------------------------
# the plan control plane: the verifier, the disk tier, the broadcast tier
# ---------------------------------------------------------------------------

TIER_OUTPUTS = ("out", "lse", "dq", "dk", "dv")
PLAN_SOURCES = ("memory", "disk", "broadcast", "cold")


def _tier_step(key, inputs, do):
    """out, lse, dq, dk, dv of this rank's dispatched rows through ``key``."""
    import torch

    from magiattention_tpu_torch import api

    ls = [api.dispatch(inputs[0], key), api.dispatch(inputs[1], key, role="kv"),
          api.dispatch(inputs[2], key, role="kv")]
    ls = [t.detach().requires_grad_(True) for t in ls]
    out, meta = api.calc_attn(*ls, key)
    return (out.detach(), meta.lse, *torch.autograd.grad(out, ls, api.dispatch(do, key)))


def _differing(got, want) -> list[str]:
    """The outputs of two tier steps that are not equal to the bit."""
    import torch

    return [n for n, a, b in zip(TIER_OUTPUTS, got, want) if not torch.equal(a, b)]


def _best_s(fn, n: int = 5) -> float:
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def plan_tiers_phase(device: str = "cuda", seq: int = CP_SEQ) -> dict:
    """The plan control plane on one card at the train attention shape
    (bf16, q 8192 x 32 x 128, k/v 8192 x 8 x 128, two causal documents),
    through ``magi_attn_flex_key -> dispatch -> calc_attn`` and the
    backward, over a fresh store directory, three ways: (a) cold, under
    MAGI_ATTENTION_VERIFY_PLANS=1 (the hook verifies the fresh build);
    (b) the memory tiers dropped, loaded from the store (decoded, verified
    again); (c) the store file with one flipped byte: rejected, cold-solved,
    and the write-through heals the file. Each way runs one step unpinned
    (B1, B7 and the resolved backward, B8/B9 here) and one under
    deterministic mode (the split B3, B5/B6): (b) and (c) equal (a) to the
    bit in out, lse and every gradient, but for the unpinned dq, which the
    fused backward sums with float32 atomics in no fixed order (held to
    the bf16 gates, its bitwise agreement reported). Reports ``plan_s`` of
    each way's key, the load alone (decode + verify) and the verify alone,
    the blob's bytes, and each way's launches."""
    import os
    import tempfile

    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.analysis.verifier import verify_runtime_mgr
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.dist_attn_runtime_mgr import _plan_signature, _verify_loaded_entry
    from magiattention_tpu_torch.kernels.ffa import ffa_bwd_mode
    from magiattention_tpu_torch.meta import plan_io, plan_store

    on_card = device == "cuda"
    inputs, do = _cp_inputs(device, seq, seed=41)
    docs = _docs(seq, seq // 2)
    det = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        store_env = {"MAGI_ATTENTION_PLAN_STORE": "1", "MAGI_ATTENTION_PLAN_STORE_DIR": tmp}

        def way(extra: dict):
            def run():
                _fresh_planning()
                plan_store.reset()
                t0 = time.perf_counter()
                key = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, device=device)
                plan_s = time.perf_counter() - t0
                fast_n, fast = counted(lambda: _tier_step(key, inputs, do), on_card)
                det_n, pinned = _with_env(
                    det, lambda: counted(lambda: _tier_step(key, inputs, do), on_card))
                for counts in (fast_n, det_n):
                    for k_, n in counts.items():
                        launches[k_] = launches.get(k_, 0) + n
                info = dict(plan_source=_mgr(key).plan_source, plan_s=plan_s, launches=fast_n,
                            deterministic_launches=det_n)
                return key, info, fast, pinned
            return _with_env({**store_env, **extra}, run)

        key, cold, want, want_det = way({"MAGI_ATTENTION_VERIFY_PLANS": "1"})
        mgr = _mgr(key)
        rt = mgr.runtime
        mode = ffa_bwd_mode(rt.plans[0], rt._params(CP_D)[0], CP_D, CP_D, 2, CP_HQ, CP_HK)
        for what, counts, kernels in (("unpinned", cold["launches"], _bwd_kernels(mode)),
                                      ("deterministic", cold["deterministic_launches"],
                                       _bwd_kernels("split"))):
            expected = ("ffa_fwd", "ffa_bwd_delta", *kernels)
            if on_card and any(counts.get(k_) != 1 for k_ in expected):
                raise AssertionError(f"plan_tiers {what}: launched {counts}, want one of {expected}")
        digest = plan_io.plan_signature_digest(_plan_signature(key))
        path = os.path.join(tmp, f"plan-{digest}.bin")
        with open(path, "rb") as f:
            blob = f.read()
        verify_s = _best_s(lambda: verify_runtime_mgr(mgr))

        def load():
            entry = plan_io.decode_plan(blob, env_sig=key.env_snapshot, expect_digest=digest)
            if not _verify_loaded_entry(entry, key):
                raise AssertionError("plan_tiers: the stored plan does not verify")

        load_s = _best_s(load)
        ways = {"cold": cold}
        for name in ("disk", "corrupt"):
            if name == "corrupt":
                bad = bytearray(blob)
                bad[len(bad) // 2] ^= 0x01
                with open(path, "wb") as f:
                    f.write(bytes(bad))
            _, info, got, got_det = way({})
            want_source = "disk" if name == "disk" else "cold"
            if info["plan_source"] != want_source:
                raise AssertionError(f"plan_tiers {name}: plan from {info['plan_source']}, want {want_source}")
            fast_diff, det_diff = _differing(got, want), _differing(got_det, want_det)
            if det_diff or set(fast_diff) - {"dq"}:
                raise AssertionError(f"plan_tiers {name}: not bitwise the cold step: "
                                     f"unpinned {fast_diff}, deterministic {det_diff}")
            info["unpinned_dq_bitwise"] = "dq" not in fast_diff
            info["unpinned_dq"] = grad_check(f"plan_tiers {name} dq", got[2].float(), want[2].float(),
                                             "bfloat16")
            ways[name] = info
        with open(path, "rb") as f:
            healed = f.read() == blob
        if not healed:
            raise AssertionError("plan_tiers: the write-through did not heal the flipped store file")
    res = dict(
        shape=f"bf16 q [{seq}, {CP_HQ}, {CP_D}], k/v [{seq}, {CP_HK}, {CP_D}], two causal "
              "documents, cp 1",
        resolved_bwd_mode=mode, ways=ways, verify_alone_s=verify_s, load_decode_verify_s=load_s,
        blob_bytes=len(blob), store_healed=healed, launches=launches,
    )
    emit({"phase": "plan_tiers", **res})
    return res


def cp4_plan_tiers(device: str, seq: int) -> dict:
    """cp 4 over the API at the train attention shape (NCCL on the card),
    on a group of its own with a 60 s timeout (a broken pairing of the
    broadcast's collectives fails the phase instead of stalling it), under
    deterministic mode: a cold solve on every rank, then, the in-process
    tiers dropped, the broadcast tier (rank 0 solves and sends the blob by
    ``DistTransport``; ranks 1-3 receive, verify and run), then a
    ``plan_broadcast`` fault on every rank under MAGI_ATTENTION_FALLBACK=1
    (the followers solve locally). Every rank's shard of out, lse and the
    gradients equals its cold step to the bit; each rank's ``plan_s``, cold
    against received."""
    import datetime

    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.api.magi_attn_interface import get_most_recent_key as _last_key
    from magiattention_tpu_torch.dist_attn_runtime_mgr import (
        _PLAN_CACHE, _plan_signature, _verify_loaded_entry,
    )
    from magiattention_tpu_torch.meta import plan_io
    from magiattention_tpu_torch.resilience import inject

    on_card = device == "cuda"
    group = dist.new_group(list(range(dist.get_world_size())), timeout=datetime.timedelta(seconds=60))
    inputs, do = _cp_inputs(device, seq, seed=43)
    docs = _docs(seq, seq // 2)
    bcast = {"MAGI_ATTENTION_PLAN_BROADCAST": "1"}

    def resolve(env: dict):
        def run():
            _fresh_planning()
            dist.barrier(group)
            t0 = time.perf_counter()
            key = api.magi_attn_flex_key(docs, docs, [1, 1], seq, seq, cp_group=group, device=device,
                                         chunk_size=min(512, seq // 8))
            plan_s = time.perf_counter() - t0
            counts, got = counted(lambda: _tier_step(key, inputs, do), on_card)
            return _mgr(key).plan_source, plan_s, counts, got
        return _with_env({"MAGI_ATTENTION_DETERMINISTIC_MODE": "1", **env}, run)

    cold_src, cold_s, counts, want = resolve({})
    src, recv_s, bcast_counts, got = resolve(bcast)
    # what a follower's receive costs besides the wait: the blob's decode and
    # the verification of the plan it carries (each rank, its own entry)
    sig = _plan_signature(_last_key())
    blob = plan_io.encode_plan(
        {k: v for k, v in _PLAN_CACHE.lookup(sig).items() if k in ("dispatch", "static")})
    load_s = _best_s(lambda: _verify_loaded_entry(plan_io.decode_plan(blob), _last_key()))
    inject.reset()
    f_src, f_s, _, faulted = resolve({**bcast, "MAGI_ATTENTION_FAULT_INJECT": "plan_broadcast:count=1",
                                      "MAGI_ATTENTION_FALLBACK": "1"})
    inject.reset()
    sources = {name: [PLAN_SOURCES[int(c)] for c in _every_rank(PLAN_SOURCES.index(s_))]
               for name, s_ in (("cold", cold_src), ("broadcast", src), ("fault", f_src))}
    diffs = {"broadcast": _differing(got, want), "fault": _differing(faulted, want)}
    bitwise = _every_rank(float(not any(diffs.values())))
    want_sources = {"cold": ["cold"] * 4, "broadcast": ["cold"] + ["broadcast"] * 3, "fault": ["cold"] * 4}
    if sources != want_sources or bitwise != [1.0] * 4:
        raise AssertionError(f"cp4_plan_tiers: sources {sources}, bitwise a rank {bitwise}, this rank {diffs}")
    for what, n in (("cold", counts), ("broadcast", bcast_counts)):
        if on_card and not (n.get("ffa_fwd") and n.get("ffa_bwd_delta")):
            raise AssertionError(f"cp4_plan_tiers {what}: launched {n}")
    return dict(
        shape=f"bf16 q [{seq}, {CP_HQ}, {CP_D}], k/v [{seq}, {CP_HK}, {CP_D}], two causal documents, "
              "cp 4, deterministic mode",
        sources=sources, bitwise_every_rank=bitwise, launches_rank0=bcast_counts,
        plan_s_cold=_every_rank(cold_s), plan_s_received=_every_rank(recv_s),
        plan_s_fault=_every_rank(f_s), load_decode_verify_s=_every_rank(load_s),
        blob_bytes=len(blob),
    )


# rank 3's extra work a step (torch.cuda._sleep cycles, ~10 ms on an H100)
STRAGGLER_CYCLES = 20_000_000
STRAGGLER_STEPS = 14
STRAGGLER_ENV = {"MAGI_ATTENTION_STRAGGLER_DETECT": "1", "MAGI_ATTENTION_STRAGGLER_MIN_STEPS": "4"}


def cp4_straggler(device: str, seq: int) -> dict:
    """cp 4 under MAGI_ATTENTION_STRAGGLER_DETECT=1 with rank 3 slowed
    each step (``torch.cuda._sleep``): every rank all-gathers the step ms
    and feeds the four to its monitor (``observe_step``), so the capacity
    vectors are identical on every rank (checked, and by the key's own
    all-reduce); exactly one re-solve after MAGI_ATTENTION_STRAGGLER_MIN
    _STEPS, no flapping; the weighted plan's output within bf16 limits of
    the unweighted one; the slowest rank's ms before and after."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.telemetry import health

    rank, world = dist.get_rank(), dist.get_world_size()
    on_card = device == "cuda"
    inputs, do = _cp_inputs(device, seq, seed=37)
    health.reset()

    def run():
        keys, caps_seq, step_ms, outs = [], [], [], []
        _rank_step(_cp4_key(device, seq), inputs, do)  # warm, not observed
        for _ in range(STRAGGLER_STEPS):
            key = _cp4_key(device, seq)  # carries the monitor's current vector
            if not keys or key != keys[-1]:
                keys.append(key)
            caps_seq.append(key.capacities)
            dist.barrier()
            t0 = time.perf_counter()
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            out = _rank_step(key, inputs, do)[0]
            if rank == 3:  # the straggler's extra work
                if on_card:
                    torch.cuda._sleep(STRAGGLER_CYCLES)
                else:
                    time.sleep(0.02)
            if on_card:
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                ms = (time.perf_counter() - t0) * 1e3
            every = _every_rank(ms)
            step_ms.append(every)
            for r, m in enumerate(every):
                health.observe_step(r, m)
            outs.append(api.undispatch(out, key))
        return keys, caps_seq, step_ms, outs

    keys, caps_seq, step_ms, outs = _with_env(STRAGGLER_ENV, run)
    health.reset()
    # the vectors of every rank: equal (the key's all-reduce checked each)
    mine = torch.tensor([c for caps in caps_seq for c in (caps or (1.0,) * world)],
                        dtype=torch.float64, device=device)
    every = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    if any(not torch.equal(t, mine) for t in every):
        raise AssertionError("cp4_straggler: capacity vectors differ across ranks")
    changes = [i for i in range(1, len(caps_seq)) if caps_seq[i] != caps_seq[i - 1]]
    if len(keys) != 2 or len(changes) != 1 or caps_seq[0] is not None:
        raise AssertionError(f"cp4_straggler: re-solves at steps {changes}, vectors {caps_seq}")
    err = grad_check("cp4_straggler weighted vs unweighted", outs[-1].float(), outs[0].float(), "bfloat16")
    before = [max(ms) for ms in step_ms[:changes[0]]]
    after = [max(ms) for ms in step_ms[changes[0]:]]
    return dict(
        slowed_rank=3, sleep_cycles=STRAGGLER_CYCLES, steps=STRAGGLER_STEPS,
        min_steps=int(STRAGGLER_ENV["MAGI_ATTENTION_STRAGGLER_MIN_STEPS"]),
        resolve_at_step=changes[0], capacities=list(caps_seq[-1]),
        slowest_rank_ms_before=before, slowest_rank_ms_after=after,
        median_slowest_before=statistics.median(before), median_slowest_after=statistics.median(after),
        step_ms_every_rank=step_ms, weighted_vs_unweighted=err,
    )


# ---------------------------------------------------------------------------
# the host plan builder, the kernel checker, precompile (one card), and
# C9's forward half and the native dispatch solve at cp 4
# ---------------------------------------------------------------------------

# the headline shape (bench.py:5-6): bf16, causal, seq 8192, hq 16, hk 8, d 128
HEAD_SEQ, HEAD_HQ, HEAD_HK, HEAD_D = 8192, 16, 8, 128
NATIVE_ON = {"MAGI_ATTENTION_NATIVE_FFA_PLAN": "1", "MAGI_ATTENTION_CPP_BACKEND": "1"}
NATIVE_OFF = {"MAGI_ATTENTION_NATIVE_FFA_PLAN": "0", "MAGI_ATTENTION_CPP_BACKEND": "0"}
PLAN_ARRAYS = ("work_qt", "work_kt", "meta", "work_qt_t", "work_kt_t", "meta_t", "run_ptr", "run_ptr_t")


def _plan_fields(obj, name: str = "") -> dict:
    """A planner output (dataclasses, dicts, lists, ranges, arrays, enums)
    as a flat dict of field path -> numpy array or plain value."""
    import dataclasses
    import enum

    out: dict = {}
    if hasattr(obj, "to_naive_ranges"):
        out[name] = np.asarray(obj.to_naive_ranges(), np.int64).reshape(-1, 2)
    elif hasattr(obj, "start") and hasattr(obj, "end") and hasattr(obj, "seqlen"):
        out[name] = np.asarray([obj.start, obj.end], np.int64)
    elif isinstance(obj, enum.Enum):
        out[name] = obj.value
    elif isinstance(obj, np.ndarray):
        out[name] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if not f.name.startswith("_"):
                out.update(_plan_fields(getattr(obj, f.name), f"{name}.{f.name}"))
    elif isinstance(obj, dict):
        for k_, x in obj.items():
            out.update(_plan_fields(x, f"{name}.{k_}"))
    elif isinstance(obj, (list, tuple)):
        out[f"{name}#len"] = len(obj)
        for i, x in enumerate(obj):
            out.update(_plan_fields(x, f"{name}[{i}]"))
    else:
        out[name] = obj
    return out


def _differing_fields(a, b) -> list[str]:
    """The field paths where two planner outputs differ."""
    fa, fb = _plan_fields(a), _plan_fields(b)
    bad = sorted(set(fa) ^ set(fb))
    for k_ in set(fa) & set(fb):
        x, y = fa[k_], fb[k_]
        same = (isinstance(x, np.ndarray) and isinstance(y, np.ndarray) and x.dtype == y.dtype
                and np.array_equal(x, y)) if isinstance(x, np.ndarray) else x == y
        if not same:
            bad.append(k_)
    return sorted(bad)


def _runtime_plans(mgr) -> list:
    """Every FFA plan of a manager's runtime, as arrays."""
    rt = mgr.runtime
    plans = rt.plans if hasattr(rt, "plans") else [rt.ffa_plan]
    return [{f: getattr(p, f) for f in PLAN_ARRAYS} for p in plans]


def _headline_inputs(device: str, seq: int = HEAD_SEQ, seed: int = 51):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ((seq, HEAD_HQ, HEAD_D), (seq, HEAD_HK, HEAD_D), (seq, HEAD_HK, HEAD_D))
    inputs = [torch.randn(sh, generator=gen, device=device).to(torch.bfloat16) for sh in shapes]
    return inputs, (torch.randn(shapes[0], generator=gen, device=device) / 4).to(torch.bfloat16)


def native_host_phase(device: str = "cuda", seq: int = HEAD_SEQ) -> dict:
    """The native host plan builder on the main path at cp 1: the headline
    shape through ``magi_attn_flex_key -> dispatch -> calc_attn`` and the
    backward, planned with MAGI_ATTENTION_NATIVE_FFA_PLAN=1 and
    MAGI_ATTENTION_CPP_BACKEND=1 (the library built, its path taken: native
    calls counted) against 0/0 (none). The dispatch and attention plans
    and every FFA plan must be array-equal; each way runs one step unpinned
    (B1, B7, B8/B9) and one under deterministic mode (B3, B5/B6): the
    deterministic steps' out, lse, dq, dk, dv bitwise, the unpinned ones'
    too but for dq (the fused backward's float32 atomics sum in no fixed
    order; held to the bf16 gates). Reports ``plan_s`` of each way's key
    (best of 3, every plan cache dropped before each) and the launches."""
    import torch

    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.csrc_backend import build as host_build
    from magiattention_tpu_torch.csrc_backend import ops as host_ops

    if not host_build.available():
        raise AssertionError(f"native_host: the host library did not build: {host_build._LIB_ERR}")
    on_card = device == "cuda"
    inputs, do = _headline_inputs(device, seq)
    det = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    launches: dict = {}
    ways: dict = {}
    for name, env in (("python", NATIVE_OFF), ("native", NATIVE_ON)):
        def run():
            times, calls = [], {}
            for _ in range(3):
                _fresh_planning()
                host_ops.CALLS.clear()
                t0 = time.perf_counter()
                key = api.magi_attn_flex_key([[0, seq]], [[0, seq]], [1], seq, seq, device=device)
                times.append(time.perf_counter() - t0)
                calls = dict(host_ops.CALLS)
            mgr = _mgr(key)
            fast_n, fast = counted(lambda: _tier_step(key, inputs, do), on_card)
            det_n, pinned = _with_env(det, lambda: counted(lambda: _tier_step(key, inputs, do), on_card))
            for counts in (fast_n, det_n):
                for k_, n in counts.items():
                    launches[k_] = launches.get(k_, 0) + n
            meta = (mgr.dispatch_meta_q, mgr.dispatch_meta_kv, mgr.comm_meta, mgr.calc_meta)
            return dict(plan_s=min(times), plan_s_all=times, native_calls=calls, launches=fast_n,
                        deterministic_launches=det_n), meta, _runtime_plans(mgr), fast, pinned
        ways[name] = _with_env(env, run)
    (py, py_meta, py_plans, py_fast, py_det) = ways["python"]
    (nat, nat_meta, nat_plans, nat_fast, nat_det) = ways["native"]
    if not nat["native_calls"].get("ffa_plan_native") or py["native_calls"]:
        raise AssertionError(f"native_host: native calls {nat['native_calls']} (on), "
                             f"{py['native_calls']} (off)")
    meta_diff = _differing_fields(nat_meta, py_meta)
    plan_diff = _differing_fields(nat_plans, py_plans)
    if meta_diff or plan_diff:
        raise AssertionError(f"native_host: plans differ: {meta_diff[:5]} {plan_diff[:5]}")
    det_diff, fast_diff = _differing(nat_det, py_det), _differing(nat_fast, py_fast)
    if det_diff or set(fast_diff) - {"dq"}:
        raise AssertionError(f"native_host: not bitwise the Python-planned step: "
                             f"deterministic {det_diff}, unpinned {fast_diff}")
    dq = grad_check("native_host dq", nat_fast[2].float(), py_fast[2].float(), "bfloat16")
    for what, counts in (("unpinned", nat["launches"]), ("deterministic", nat["deterministic_launches"])):
        want = ("ffa_fwd", "ffa_bwd_delta", *_bwd_kernels("split" if what == "deterministic" else "fused"))
        if on_card and any(counts.get(k_) != 1 for k_ in want):
            raise AssertionError(f"native_host {what}: launched {counts}, want one of {want}")
    row = dict(shape=f"bf16 causal q [{seq}, {HEAD_HQ}, {HEAD_D}], k/v [{seq}, {HEAD_HK}, {HEAD_D}]",
               python=py, native=nat, plan_speedup=py["plan_s"] / nat["plan_s"],
               ffa_plans=len(nat_plans), plan_fields_equal=True, deterministic_bitwise=True,
               unpinned_bitwise="dq" not in fast_diff, unpinned_dq=dq, launches=launches)
    emit({"phase": "native_host", **row})
    return row


def precompile_phase(build_s: float) -> dict:
    """``testing/precompile.py``: the seconds ``precompile_kernels`` took to
    build every kernel library (all ``nvcc`` processes at once) and the
    host library at the start of the run; then, with every library built,
    a second call (nothing to build) and the warm-up of the headline
    configuration's FFA plans and forward (``precompile_ffa``)."""
    import torch

    from magiattention_tpu_torch.csrc_backend import build as host_build
    from magiattention_tpu_torch.kernels import _build
    from magiattention_tpu_torch.testing import precompile_ffa, precompile_kernels

    again_s = precompile_kernels(_build.SOURCES + ("tf32_probe",))
    cfg = dict(q_ranges=[[0, HEAD_SEQ]], k_ranges=[[0, HEAD_SEQ]], attn_type_map=[1],
               seqlen_q=HEAD_SEQ, seqlen_k=HEAD_SEQ, num_heads_q=HEAD_HQ, num_heads_kv=HEAD_HK,
               head_dim=HEAD_D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    precompile_ffa([cfg], torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    row = dict(build_s=build_s, libraries=len(_build.SOURCES) + 1, host_library=host_build.available(),
               rebuild_s=again_s, warm_headline_s=time.perf_counter() - t0)
    if not row["host_library"]:
        raise AssertionError(f"precompile: the host library did not build: {host_build._LIB_ERR}")
    emit({"phase": "precompile", **row})
    return row


def kernel_audit_phase(ffa_smem: dict) -> dict:
    """The kernel checker (``analysis/kernel_check.py``): K1 over the
    decode and block-sparse libraries against the card's per-CTA opt-in
    limit (the FFA ones were checked by ``tiles_smem_check``, whose row
    ``ffa_smem`` is carried here so the line covers every library), then
    K3 and K5 over the corpus (host)."""
    import torch

    from magiattention_tpu_torch.analysis import kernel_check
    from magiattention_tpu_torch.analysis.violation import VerifyReport

    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", None)
    report = VerifyReport()
    k1 = kernel_check.check_k1_libraries(
        report, libraries=(*kernel_check.DECODE_LIBRARIES, *kernel_check.BSP_LIBRARIES), limit=optin)
    t0 = time.perf_counter()
    kernel_check.run_kernel_audit(report=report)
    host_s = time.perf_counter() - t0
    report.raise_if_errors()
    row = dict(device_smem_per_block_optin=optin,
               k1_checked=k1["checked"] + ffa_smem["checked"],
               k1_compiled={**ffa_smem["compiled"], **k1["compiled"]},
               k1_largest={**ffa_smem["largest"], **k1["largest"]}, rules=report.rules_run,
               violations=len(report.violations), k3_k5_host_s=host_s)
    emit({"phase": "kernel_audit", **row})
    return row


C9_POINTS = ("before_casts", "before_max_logits", "qo_before_return_cast")


def _fail_once(owner, attr: str, err: BaseException, armed: list):
    """``owner.attr`` raising ``err`` at its first call while ``armed[0]``
    (then disarmed); returns the original, to put back."""
    orig = getattr(owner, attr)

    def wrapper(*args, **kwargs):
        if armed[0]:
            armed[0] = False
            raise err
        return orig(*args, **kwargs)

    setattr(owner, attr, wrapper)
    return orig


def _ml_step(key, inputs, do):
    """out, max-logits, dq, dk, dv of this rank's dispatched rows through
    ``key`` (max-logits asked for: its all-reduce is the last forward
    collective)."""
    import torch

    from magiattention_tpu_torch import api

    ls = [api.dispatch(inputs[0], key), api.dispatch(inputs[1], key, role="kv"),
          api.dispatch(inputs[2], key, role="kv")]
    ls = [t.detach().requires_grad_(True) for t in ls]
    out, meta = api.calc_attn(*ls, key, return_max_logits=True)
    return (out.detach(), meta.max_logits, *torch.autograd.grad(out, ls, api.dispatch(do, key)))


def cp4_c9(device: str, seq: int) -> dict:
    """C9's forward half at cp 4: rank 1 alone raises ``KernelLaunchError``
    once under MAGI_ATTENTION_STEP_RETRIES=1 (deterministic mode), before
    the static runtime's casts (its head check), between its casts and the
    max-logits all-reduce (the parts' forward), and in the qo-comm runtime
    before its return cast (its forward step). Rank 1 issues the forward
    collectives it did not reach with placeholders, every rank agrees and
    hops once (on the card to the ``ffa`` kernels again), and each rank's
    out, max-logits and gradients equal its unfaulted step to the bit (in
    a rehearsal on the CPU: its step pinned at ``sdpa``, the rung taken).
    The group's timeout bounds a hang."""
    import torch
    import torch.distributed as dist

    from magiattention_tpu_torch.functional import dist_attn, dynamic_dist_attn
    from magiattention_tpu_torch.kernels._build import KernelLaunchError
    from magiattention_tpu_torch.resilience import inject, watchdog

    on_card = device == "cuda"
    rung = {"MAGI_ATTENTION_KERNEL_BACKEND": "ffa" if on_card else "sdpa"}
    det = {"MAGI_ATTENTION_DETERMINISTIC_MODE": "1"}
    inputs, do = _cp_inputs(device, seq, seed=61)
    sites = {"before_casts": (dist_attn.DistAttnRuntime, "_check_heads"),
             "before_max_logits": (dist_attn, "_parts_fwd"),
             "qo_before_return_cast": (dynamic_dist_attn.DynamicDistAttnRuntime, "fwd_step")}
    out = {}
    for point in C9_POINTS:
        qo = {"MAGI_ATTENTION_QO_COMM": "1"} if point.startswith("qo") else {}
        base = _with_env({**det, **qo, **rung}, lambda: _ml_step(_cp4_key(device, seq), inputs, do))
        armed = [dist.get_rank() == 1]
        orig = _fail_once(*sites[point], KernelLaunchError("injected launch failure", 719), armed)
        _fresh_planning()  # no runtime a hop pinned at an earlier point
        inject.reset()
        watchdog.reset()
        before = resilience_counts()
        dist.barrier()
        t0 = time.perf_counter()
        try:
            got = _with_env({**det, **qo, "MAGI_ATTENTION_STEP_RETRIES": "1",
                             "MAGI_ATTENTION_KERNEL_BACKEND": "ffa"},
                            lambda: _ml_step(_cp4_key(device, seq), inputs, do))
        finally:
            setattr(*sites[point], orig)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts_delta(before, resilience_counts())
        watchdog.reset()
        same = all(torch.equal(a, b) for a, b in zip(got, base))
        mine = torch.tensor([counts.get("resilience.recovered", 0), counts.get("resilience.retry", 0),
                             counts.get("resilience.fwd_comm_completed", 0), int(same),
                             int(not armed[0])], device=device)
        every = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        every = [t.tolist() for t in every]
        want = [[1, 1, int(r == 1), 1, 1] for r in range(dist.get_world_size())]
        if every != want:
            raise AssertionError(f"cp4_c9 {point}: ranks' (hops, retries, completions, bitwise, "
                                 f"fired) {every}, want {want}")
        out[point] = dict(ranks_hops_retries_completions_bitwise_fired=every,
                          faulted_step_wall_s=_every_rank(wall))
    return dict(fault="KernelLaunchError on rank 1 alone", rung=rung["MAGI_ATTENTION_KERNEL_BACKEND"],
                points=out)


def cp4_native_solve(device: str, seq: int) -> dict:
    """The native host backend at cp 4: every rank plans the train
    attention key (two causal documents) with the native dispatch solve and
    FFA plans (MAGI_ATTENTION_CPP_BACKEND=1, MAGI_ATTENTION_NATIVE_FFA_PLAN=1)
    and in Python (0/0): field-equal dispatch, comm and attention meta and
    array-equal FFA plans on every rank; ``plan_s`` of each (best of 3,
    caches dropped before each)."""
    import torch.distributed as dist

    from magiattention_tpu_torch.api.magi_attn_interface import _mgr
    from magiattention_tpu_torch.csrc_backend import ops as host_ops

    ways = {}
    for name, env in (("python", NATIVE_OFF), ("native", NATIVE_ON)):
        def run():
            times = []
            for _ in range(3):
                _fresh_planning()
                host_ops.CALLS.clear()
                dist.barrier()
                t0 = time.perf_counter()
                key = _cp4_key(device, seq)
                times.append(time.perf_counter() - t0)
            mgr = _mgr(key)
            meta = (mgr.dispatch_meta_q, mgr.dispatch_meta_kv, mgr.comm_meta, mgr.calc_meta)
            return min(times), dict(host_ops.CALLS), meta, _runtime_plans(mgr)
        ways[name] = _with_env(env, run)
    diff = _differing_fields(ways["native"][2], ways["python"][2])
    diff += _differing_fields(ways["native"][3], ways["python"][3])
    if diff or not ways["native"][1] or ways["python"][1]:
        raise AssertionError(f"cp4_native_solve: fields differ {diff[:5]}, native calls "
                             f"{ways['native'][1]} (on) {ways['python'][1]} (off)")
    return dict(plan_s_python=_every_rank(ways["python"][0]), plan_s_native=_every_rank(ways["native"][0]),
                native_calls=ways["native"][1], fields_equal=True)


def cp4_worker(rank: int, port: int, device: str, seq: int) -> None:
    """One process of ``--cp4`` (NCCL on card ``rank``; gloo on the CPU in
    a rehearsal): rank 0 prints the results."""
    import datetime

    import torch
    import torch.distributed as dist

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if on_card else "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=CPB_WORLD, timeout=datetime.timedelta(seconds=300),
        **({"device_id": torch.device("cuda", rank)} if on_card else {}),
    )
    try:
        res = cp4_run(device, seq)
        if rank == 0:
            emit({"phase": "cp4", "world": CPB_WORLD, "backend": dist.get_backend(),
                  "shape": f"bf16 q [{seq}, {CP_HQ}, {CP_D}], k/v [{seq}, {CP_HK}, {CP_D}]",
                  **res, "atol": ATOL["bfloat16"], "rnorm": RNORM["bfloat16"]})
        del res
        # cp4_zero3 last: its profiled step slows every later step in the
        # process (on four H100s the DiT's cp 4 step went from 24.0 to 32.1
        # ms after one)
        for name, run in (("cp4_resilience", lambda: cp4_resilience(device, seq)),
                          ("cp4_c9", lambda: cp4_c9(device, seq)),
                          ("cp4_native_solve", lambda: cp4_native_solve(device, seq)),
                          ("cp4_plan_tiers", lambda: cp4_plan_tiers(device, seq)),
                          ("cp4_straggler", lambda: cp4_straggler(device, seq)),
                          ("cp4_moe_ep", lambda: cp4_moe_ep(device, seq)),
                          ("cp4_video_dit", lambda: cp4_video_dit(device)),
                          ("cp4_tp_train", lambda: cp4_tp_train(device, seq)),
                          ("cp4_zero3_check", lambda: cp4_zero3_check(device, seq)),
                          ("cp4_zero3", lambda: cp4_zero3(device, seq))):
            out = run()
            if rank == 0:
                emit({"phase": name, "world": CPB_WORLD, **out})
        dist.barrier()  # leave together
    finally:
        dist.destroy_process_group()


def cp4_main(device: str = "cuda", seq: int = CP_SEQ) -> int:
    """Spawn the four processes of ``--cp4`` on a free local port."""
    import socket

    import torch
    import torch.multiprocessing as mp

    if resilience_flags_set():
        print(f"chip_smoke --cp4: unset {resilience_flags_set()} (its phases set them themselves)",
              file=sys.stderr)
        return 1
    if device == "cuda":
        if torch.cuda.device_count() < CPB_WORLD:
            print(f"chip_smoke --cp4: needs {CPB_WORLD} cards", file=sys.stderr)
            return 1
        from magiattention_tpu_torch.kernels import _build

        _build.build_all(_build.SOURCES)  # once, before the ranks load them
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(cp4_worker, args=(port, device, seq), nprocs=CPB_WORLD,
                       start_method="spawn", join=True)
    if device == "cuda":
        emit({"phase": "cp4_sharded_engine", **cp4_sharded_engine()})
        for i in range(CPB_WORLD):
            print(subprocess.run(
                ["nvidia-smi", "-i", str(i), "--query-gpu=name,power.limit", "--format=csv,noheader"],
                check=True, capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0


# each tiled library's tensor-core body and the TPU kernel it replaces
TILE_ENTRY = {
    "ffa_fwd": ("ffa_fwd_tc.cuh", "magiattention_tpu/kernels/ffa.py:251"),
    "ffa_fwd_gqa": ("ffa_fwd_tc.cuh", "magiattention_tpu/kernels/ffa.py:490"),
    "ffa_bwd_dq": ("ffa_bwd_dq_tc.cuh", "magiattention_tpu/kernels/ffa.py:751"),
    "ffa_bwd_dq_gqa": ("ffa_bwd_dq_tc.cuh", "magiattention_tpu/kernels/ffa.py:944"),
    "ffa_bwd_dkv": ("bwd_kv_tc.cuh", "magiattention_tpu/kernels/ffa.py:1208"),
    "ffa_bwd_fused": ("bwd_kv_tc.cuh", "magiattention_tpu/kernels/ffa.py:1780"),
}


def tile_entries(tiles: dict) -> list[dict]:
    """The ``kernels`` line's rows of the tile instances other than 64 x 64
    (bf16 at the headline shape, the float32 forward at the serving
    prefill), launches from the tiles path (``tiles_path``)."""
    launches = tiles["path"]["tile_launches"]
    rows = []
    for case, dname in (("causal_8192_bf16", "bfloat16"), ("serving_prefill_f32", "float32")):
        for lib, by_tile in tiles["timing"][case].items():
            source, replaces = TILE_ENTRY[lib]
            if dname == "float32":
                source = "ffa_fwd_tf32.cuh"
            for tile, r in by_tile.items():
                if tile == "64x64":
                    continue
                rows.append(kernel_entry(
                    f"{lib} {dname} d128 {tile}", source, replaces,
                    launches[lib].get(f"{dname} {tile}", 0), r,
                ))
    return rows


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
    if resilience_flags_set():
        # a fallback flag in the environment could carry a phase onto the
        # plain path unseen: the resilience phases set them themselves
        print(f"chip_smoke: unset {resilience_flags_set()} (its phases set them themselves)",
              file=sys.stderr)
        return 1
    if "--cp4" in sys.argv[1:]:
        return cp4_main()
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
    from magiattention_tpu_torch.testing import precompile_kernels

    # every library at once (one nvcc a source) and the host library
    build_s = precompile_kernels(_build.SOURCES + ("tf32_probe",))
    for src in _build.SOURCES:
        for line in build_report(src):
            print(f"[{src}] {line}", file=sys.stderr)
    emit({
        "phase": "device", "name": name, "nvidia_smi": smi,
        "driver": nvidia_smi("driver_version"), "torch": torch.__version__,
        "cuda": torch.version.cuda, "peaks_for": peaks["form"],
        "peak_bf16_tflops": peaks["bfloat16"] / 1e12,
        "peak_f32_tflops": peaks["float32"] / 1e12,
        "peak_tf32_tflops": peaks["tfloat32"] / 1e12,
        "peak_tb_s": peaks["bytes_s"] / 1e12, "build_s": build_s,
    })
    precompile_phase(build_s)

    tensor_core_phase()
    tf32_probe_phase()
    ffa = ffa_phase(peaks)
    bwd = ffa_bwd_phase(peaks)
    fused = ffa_bwd_fused_phase(peaks, bwd)
    fwd_gqa = ffa_fwd_gqa_phase(peaks)
    dq_gqa = ffa_bwd_gqa_phase(peaks)
    max_logits_phase()
    bwd_mode_phase(bwd, fused, dq_gqa)
    tiles = tiles_phase(peaks)
    kernel_audit_phase(tiles["smem"])
    dec = decode_phase(peaks)
    spec = decode_spec_phase(peaks)
    int8 = decode_int8_phase(peaks)
    decode_split_phase()
    decode_long_phase(peaks, dec, spec, int8)
    decode_sass_phase()
    edge_phase()
    serve, serve_ctx = serve_phase()
    serve_spec = serve_spec_phase(serve_ctx)
    serve_int8 = serve_int8_phase(serve_ctx)
    serve_pinned_phase(serve_ctx)
    sharded = decode_sharded_phase(serve_ctx, peaks)
    # the resilience layer acts in its own phases only: nothing before them
    # (the counters start at zero), and, cleared after them, nothing after
    before_own = resilience_counts()
    obs = observability_phase()
    resil = resilience_phase(serve_ctx)
    from magiattention_tpu_torch import telemetry

    telemetry.reset()
    del serve_ctx
    cp_api = cp_api_phase()
    deterministic_phase()
    tiers = plan_tiers_phase()
    native = native_host_phase()
    cp_stages_phase()
    qo = qo_comm_phase(cp_api)["launches"]
    cpb = cp_baselines_phase()["launches"]
    ht = cp_hier_tp_phase()["launches"]
    train = train_phase()
    train_padded_phase(train)
    shard = shard_cp1_phase()["launches"]
    moe_launches = moe_phase()["launches"]
    dit_launches = video_dit_phase()["launches"]
    d256_phase(peaks)
    hybrid_d256_phase(peaks)
    bsp = block_sparse_phase(peaks)["slice_g4_d128_bf16_ds16"]
    nsa = nsa_phase()
    usp = usp_nsa_phase()["launches"]

    # the resilience layer acted in its own phases only (its counts are
    # kept with telemetry off too)
    after_own = resilience_counts()
    if before_own or after_own:
        raise AssertionError(f"resilience actions outside the resilience phases: before them "
                             f"{before_own}, after them {after_own}")
    emit({"phase": "resilience_elsewhere", "before_own_phases": before_own,
          "after_own_phases": after_own, "own_phases": resil["counts"]})

    t = bwd["d_train_docs_8192_bf16"]
    # the launches of each kernel on the main paths (serving, train, nsa)
    # plus those of the qo-comm path (qo_comm phase), the CP baselines'
    # rank bodies (cp_baselines), the two-level, TP and sink runs
    # (cp_hier_tp), usp_nsa_attn's (usp_nsa), the train phase's remat
    # step, the MoE and video DiT steps (moe, video_dit), the sharded
    # tree's step (shard_cp1), the plan tiers' steps (plan_tiers) and the
    # headline steps planned natively and in Python (native_host)
    paths = (qo, cpb, ht, usp, train["remat"]["launches"], moe_launches, dit_launches, shard,
             obs["launches"], resil["launches"], tiers["launches"], native["launches"])
    extra = {k_: sum(p.get(k_, 0) for p in paths) for k_ in set().union(*paths)}
    emit({"kernels": [
        kernel_entry(  # serve's shape: float32, the 3xTF32 body; int8 spec verify's too
            "ffa_fwd", "ffa_fwd_tf32.cuh", "magiattention_tpu/kernels/ffa.py:251",
            serve["kernel_launches"]["ffa_fwd"] + serve_int8["spec"]["kernel_launches"]["ffa_fwd"]
            + extra.get("ffa_fwd", 0), ffa[0],
        ),
        kernel_entry(  # serve's launches and the head-sharded step's
            "paged_decode", "paged_decode.cu",
            "magiattention_tpu/kernels/paged_decode.py:71",
            serve["kernel_launches"]["paged_decode"] + sharded["launches"], dec[0],
        ),
        kernel_entry(
            "ffa_bwd_delta", "ffa_bwd_delta.cu",
            "magiattention_tpu/kernels/ffa.py:1722",
            train["launches"]["ffa_bwd_delta"] + extra.get("ffa_bwd_delta", 0), t["ffa_bwd_delta"],
        ),
        # the train shape's rows are bf16: their sources are the
        # tensor-core bodies (entries ffa_bwd_dq.cu, ffa_bwd_dkv.cu,
        # ffa_bwd_fused.cu, ffa_fwd_gqa.cu, ffa_bwd_dq_gqa.cu)
        kernel_entry(
            "ffa_bwd_dq", "ffa_bwd_dq_tc.cuh", "magiattention_tpu/kernels/ffa.py:751",
            train["split_launches"]["ffa_bwd_dq"] + extra.get("ffa_bwd_dq", 0), t["ffa_bwd_dq"],
        ),
        kernel_entry(
            "ffa_bwd_dkv", "bwd_kv_tc.cuh", "magiattention_tpu/kernels/ffa.py:1208",
            train["split_launches"]["ffa_bwd_dkv"] + extra.get("ffa_bwd_dkv", 0), t["ffa_bwd_dkv"],
        ),
        kernel_entry(  # the same CUDA kernel loops the query group (B6)
            "ffa_bwd_dkv (gqa)", "bwd_kv_tc.cuh", "magiattention_tpu/kernels/ffa.py:1451",
            train["split_launches"]["ffa_bwd_dkv"] + extra.get("ffa_bwd_dkv", 0), t["ffa_bwd_dkv"],
        ),
        kernel_entry(
            "ffa_bwd_fused", "bwd_kv_tc.cuh", "magiattention_tpu/kernels/ffa.py:1780",
            train["launches"]["ffa_bwd_fused"] + extra.get("ffa_bwd_fused", 0),
            fused["d_train_docs_8192_bf16"],
        ),
        kernel_entry(  # the same CUDA kernel loops the query group (B9)
            "ffa_bwd_fused (gqa)", "bwd_kv_tc.cuh", "magiattention_tpu/kernels/ffa.py:2082",
            train["launches"]["ffa_bwd_fused"] + extra.get("ffa_bwd_fused", 0),
            fused["d_train_docs_8192_bf16"],
        ),
        kernel_entry(
            "ffa_fwd_gqa", "ffa_fwd_tc.cuh", "magiattention_tpu/kernels/ffa.py:490",
            train["packed_launches"]["ffa_fwd_gqa"] + extra.get("ffa_fwd_gqa", 0),
            fwd_gqa["a_docs_bf16_d128_g4"],
        ),
        kernel_entry(
            "ffa_bwd_dq_gqa", "ffa_bwd_dq_tc.cuh", "magiattention_tpu/kernels/ffa.py:944",
            train["packed_launches"]["ffa_bwd_dq_gqa"] + extra.get("ffa_bwd_dq_gqa", 0),
            dq_gqa["a_docs_bf16_d128_g4"],
        ),
        kernel_entry(  # serve_spec's shape: float32, 4 draft rows x g 4
            "paged_decode_spec", "paged_decode_spec.cu",
            "magiattention_tpu/kernels/paged_decode.py:352",
            serve_spec["kernel_launches"]["paged_decode_spec"], spec["spec4_hk8_float32"],
        ),
        kernel_entry(  # serve_int8's shape: float32 q over int8 pages
            "paged_decode_int8", "paged_decode_int8.cu",
            "magiattention_tpu/kernels/paged_decode.py:568",
            serve_int8["kernel_launches"]["paged_decode_int8"], int8["float32"],
        ),
        # the nsa phase's shape: bf16, g 4, d 128, 16 x 64 keys; the bf16
        # bodies of block_sparse_fwd.cu and block_sparse_bwd.cu
        kernel_entry(
            "block_sparse_fwd", "block_sparse_tc.cuh",
            "magiattention_tpu/kernels/block_sparse.py:76",
            nsa["launches"]["block_sparse_fwd"] + extra.get("block_sparse_fwd", 0), bsp["block_sparse_fwd"],
        ),
        kernel_entry(  # B14's two launches (dq walk, dk/dv walk), summed
            "block_sparse_bwd", "block_sparse_tc.cuh",
            "magiattention_tpu/kernels/block_sparse.py:210",
            nsa["launches"]["block_sparse_bwd_dq"] + nsa["launches"]["block_sparse_bwd_dkv"]
            + extra.get("block_sparse_bwd_dq", 0) + extra.get("block_sparse_bwd_dkv", 0),
            bsp["block_sparse_bwd"],
        ),
        *tile_entries(tiles),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
