"""The backward-mode cost model, derived for the port's Hopper kernels.

The JAX package's model (``magiattention_tpu/kernels/tile_policy.py``:
``bwd_mxu_elems``, ``bwd_hbm_bytes``, ``choose_bwd_mode``) prices
tensor-core tile products per work item plus HBM blocks per work item,
and charges the fused mode a float32 dq read-modify-write in HBM for
every (k-major item, head). None of that describes the port's kernels:
in float32 the split kernels (dq, dk/dv) and the fused kernel run float32
FMA on the CUDA cores, in bf16 all three run their products on the tensor
cores (csrc/ffa_bwd_dq_tc.cuh, csrc/bwd_kv_tc.cuh), all one CTA per run
of a tile's items (operands of the run's tile resident, the other side
streamed per item), and the fused kernel's dq atomics resolve in L2. So
this model prices what the card does:

- **compute**: each kernel's CTAs, in launch order, dealt to the SMs'
  slots as they free up (one CTA per SM for the CUDA-core kernels; per
  tensor-core kernel :data:`TC_CTAS_PER_SM`), each CTA taking (items in
  its run) x (heads it loops) x the kernel's measured time per
  (item, head); the kernel's time is the
  last CTA's finish. This is what separates the modes: both do the same
  items, but the fused mode runs all of them over the k-major runs, so a
  mask with one long k-major run (a column every q tile reaches, e.g.
  global tokens before a sliding window) leaves it waiting on that run,
  where split spreads the dq part over the short q-major runs;
- **atomics**: the float32 fused kernel's scalar float32 adds of dq (64 x
  d per item and head) at the rate the card sustains (the bf16 body's
  16-byte vector adds fit at no cost beside its products, so it has no
  such term);
- **DRAM**: the operand streams per run and per item, the outputs, and
  the fused dq workspace about once per pass (zeroed, written back from
  L2, read and written by the convert pass), at the data-sheet HBM rate.

The constants were measured by ``chip_smoke.py`` (phase ``bwd_mode``) on an
NVIDIA H100 80GB HBM3 at a 700 W power limit. CUDA-core kernels
(:func:`calibrate`): each kernel's time at the train phase's attention
shape over its modeled makespan in (item, head) units, at head_dim 128;
the atomic rate from the float32 fused kernel's time less 5/4 of the dk/dv
kernel's (that body is the dk/dv body plus one tile product, dS K, and the
atomics). The tensor-core bodies (:func:`calibrate_tc`): each kernel's
per-(item, head) time fitted by least squares to its times at the bf16
masks of the phase. Head dims up to 128 scale the per-item times by
d / 128. At 256 (:func:`width_scale`) every kernel splits the columns it
writes in two 128-column halves across the grid, so it runs twice the
CTAs, and each CTA does its 128-wide output products beside S and dP over
the full 256 (the recompute: :data:`TC_PRODUCTS`, :data:`FMA_PRODUCTS`);
the tensor-core bodies then run one CTA an SM (shared memory). Which
bodies a backward runs follows its dtype (``BwdShape.itemsize``: 2 is
bf16, the tensor-core bodies; :func:`dtype_body`).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from .head_dims import SPLIT_WIDTH, column_halves

# the card: NVIDIA H100 SXM data sheet
NUM_SMS = 132
HBM_BYTES_PER_S = 3.35e12

# The CUDA-core kernels (float32), measured on NVIDIA H100 80GB HBM3,
# 700.00 W (chip_smoke.py phase bwd_mode, in a run where bf16 took them
# too): microseconds one CTA spends per (work item, q head) at head_dim
# 128 in each kernel's loop (dq packed: per head of its block).
ITEM_US = {"dq": 11.50, "dq_gqa": 11.73, "dkv": 15.27}
# the fused kernel's per-(item, head) body, 5/4 of the dk/dv kernel's (one
# more 64 x 64 x d product of the same shape)
FUSED_BODY_OVER_DKV = 1.25
# float32 atomic adds per second the fused kernel's dq block sustains
ATOMIC_ADDS_PER_S = 4.45e11
# The tensor-core kernels (bf16: csrc/ffa_bwd_dq_tc.cuh for dq and
# dq_gqa, csrc/bwd_kv_tc.cuh for dkv and fused), measured on NVIDIA H100
# 80GB HBM3, 700.00 W (chip_smoke.py phase bwd_mode, calibrate_tc over the
# four bf16 masks; dq_gqa over the two that time it): microseconds one CTA
# spends per (work item, q head) at head_dim 128, the fused kernel's dq
# atomics included (dq_gqa: per head of its block of 2).
TC_ITEM_US = {"dq": 0.9092, "dq_gqa": 1.0122, "dkv": 2.8878, "fused": 5.121}
# CTAs of each tensor-core kernel one SM runs at once, from its shared
# memory at head_dim 128 (dq 99,328 bytes, dq_gqa 132,096, dkv 100,352,
# fused 108,544; 227 KB a CTA at most, 228 KB an SM): its per-item time is
# a CTA's while it shares the SM. A lone long run (the sink window's 516
# steps) is slower than that pace: the model is 4-23% under it there.
TC_CTAS_PER_SM = {"dq": 2, "dq_gqa": 1, "dkv": 2, "fused": 2}
# The 256-wide instances: per (item, head) each body's products over the
# full head dim (S, dP: recomputed by both column halves) and over its half
# (the outputs; the tensor-core dk/dv products are hi + lo pairs), for
# :func:`width_scale`.
TC_PRODUCTS = {"dq": (2, 1), "dq_gqa": (2, 1), "dkv": (2, 4), "fused": (2, 5)}
FMA_PRODUCTS = {"dq": (2, 1), "dq_gqa": (2, 1), "dkv": (2, 2), "fused": (2, 3)}


def width_scale(d: int, products: tuple[int, int]) -> float:
    """One CTA's per-(item, head) time at head dim d over its time at 128:
    d / 128 up to 128; above, its (full-width, half-width) ``products``
    at d and at the 128-column half, over all of them at 128."""
    if d <= SPLIT_WIDTH:
        return d / 128.0
    full, half = products
    return (full * d + half * SPLIT_WIDTH) / ((full + half) * 128.0)


@dataclass(frozen=True)
class BwdShape:
    """What the model reads of one backward: real (non-dummy) items per
    q-major and per k-major run, tile sizes, heads and head dims."""

    items_q: np.ndarray  # (num_q_tiles,) real items of each q-major run
    items_k: np.ndarray  # (num_k_tiles,) real items of each k-major run
    block_q: int
    block_k: int
    hq: int
    hk: int
    d: int
    dv: int
    itemsize: int


def makespan(cta_work: np.ndarray, slots: int = NUM_SMS) -> float:
    """Finish time of CTAs of the given work, dealt in launch order to
    ``slots`` slots, each CTA to the slot that frees first."""
    work = np.asarray(cta_work, dtype=np.float64)
    if len(work) <= slots:
        return float(work.max(initial=0.0))
    free = [0.0] * slots
    for w in work.tolist():
        heapq.heapreplace(free, free[0] + w)
    return max(free)


def _ctas(items: np.ndarray, heads: int, heads_per_cta: int, reverse: bool) -> np.ndarray:
    """Per-CTA (item, head) work in launch order: grid x over the runs
    (last first when ``reverse``, as the q-major kernels take them), y
    over the head blocks."""
    runs = items[::-1] if reverse else items
    return np.tile(runs * heads_per_cta, heads // heads_per_cta)


def _halves(s: "BwdShape") -> int:
    return column_halves(max(s.d, s.dv))


def kernel_units(
    s: BwdShape, dq_heads_per_cta: int = 1, kv_slots: int = NUM_SMS,
    dq_slots: int = NUM_SMS,
) -> dict[str, float]:
    """Makespans in (item, head) units: the dq kernel over the q-major runs
    (one CTA per (run, block of ``dq_heads_per_cta`` heads), last run
    first, on ``dq_slots`` slots) and the k-major kernels (dk/dv and fused:
    one CTA per (run, kv head) looping the group, first run first, on
    ``kv_slots`` slots)."""
    g, n = s.hq // s.hk, _halves(s)  # grid z: the column halves
    return {
        "dq": makespan(np.tile(_ctas(s.items_q, s.hq, dq_heads_per_cta, True), n), dq_slots),
        "kv": makespan(np.tile(_ctas(s.items_k, s.hk, 1, False) * g, n), kv_slots),
    }


def _dq_key(dq_heads_per_cta: int) -> str:
    return "dq_gqa" if dq_heads_per_cta > 1 else "dq"


def _tc_units(s: BwdShape, kernel: str, dq_heads_per_cta: int = 1) -> float:
    """A tensor-core kernel's makespan in (item, head) units ("dq",
    "dq_gqa", "dkv" or "fused"), its CTAs dealt to its
    :data:`TC_CTAS_PER_SM` slots per SM (one at 256)."""
    slots = NUM_SMS * (TC_CTAS_PER_SM[kernel] if _halves(s) == 1 else 1)
    if kernel in ("dq", "dq_gqa"):
        return kernel_units(s, dq_heads_per_cta, dq_slots=slots)["dq"]
    return kernel_units(s, kv_slots=slots)["kv"]


def dram_bytes(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Bytes each kernel streams from and to device memory: per CTA the
    run tile's resident operands and its outputs, per (item, head) the
    streamed operands (K/V for dq, once per head block; Q/dO with lse and
    delta for the k-major kernels), and the fused dq workspace about once
    per pass (zeroed, written back, read and written by the convert)."""
    isz, bq, bk, d, dv = s.itemsize, s.block_q, s.block_k, s.d, s.dv
    n_q, n_k, n = len(s.items_q), len(s.items_k), _halves(s)  # each half reads all
    kv = (
        n_k * s.hk * bk * (d + dv) * (n * isz + 4)  # K, V in; dk, dv out
        + n * float(s.items_k.sum()) * s.hq * bq * ((d + dv) * isz + 2 * 4)  # Q, dO, lse, delta
    )
    return {
        "dq": n_q * s.hq * bq * ((d + dv) * n * isz + 2 * 4 * n + d * 4)  # Q, dO, stats; dq
        + n * float(s.items_q.sum()) * (s.hq // dq_heads_per_cta) * bk * (d + dv) * isz,  # K, V
        "dkv": kv,
        "fused": kv + 4 * n_q * bq * s.hq * d * 4,
    }


def atomic_adds(s: BwdShape) -> float:
    """The fused kernel's float32 adds into the dq workspace: one 64 x d
    block per (real item, q head)."""
    return float(s.items_k.sum()) * s.hq * s.block_q * s.d


def dtype_body(s: BwdShape) -> str:
    """The backward kernels' body for the backward's dtype: "tc" (bf16, the
    tensor cores) or "fma" (float32, the CUDA cores)."""
    return "tc" if s.itemsize == 2 else "fma"


def _with_dram(s: BwdShape, dq_heads_per_cta: int, compute: dict[str, float]) -> dict[str, float]:
    nbytes = dram_bytes(s, dq_heads_per_cta)
    return {k: compute[k] + nbytes[k] / HBM_BYTES_PER_S * 1e3 for k in compute}


def fma_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of each backward kernel in its CUDA-core body
    (float32 FMA; the one float32 runs)."""
    units = kernel_units(s, dq_heads_per_cta)
    dq, d = _dq_key(dq_heads_per_cta), max(s.d, s.dv)
    return _with_dram(s, dq_heads_per_cta, {
        "dq": units["dq"] * ITEM_US[dq] * width_scale(d, FMA_PRODUCTS[dq]) * 1e-3,
        "dkv": units["kv"] * ITEM_US["dkv"] * width_scale(d, FMA_PRODUCTS["dkv"]) * 1e-3,
        "fused": units["kv"] * FUSED_BODY_OVER_DKV * ITEM_US["dkv"]
        * width_scale(d, FMA_PRODUCTS["fused"]) * 1e-3
        + atomic_adds(s) / ATOMIC_ADDS_PER_S * 1e3,
    })


def tc_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of each backward kernel in its tensor-core body
    (the one bf16 runs)."""
    dq, d = _dq_key(dq_heads_per_cta), max(s.d, s.dv)
    units = {
        "dq": _tc_units(s, dq, dq_heads_per_cta) * TC_ITEM_US[dq],
        "dkv": _tc_units(s, "dkv") * TC_ITEM_US["dkv"],
        "fused": _tc_units(s, "fused") * TC_ITEM_US["fused"],
    }
    kern = {"dq": dq, "dkv": "dkv", "fused": "fused"}
    return _with_dram(s, dq_heads_per_cta, {
        k: us * width_scale(d, TC_PRODUCTS[kern[k]]) * 1e-3 for k, us in units.items()
    })


def kernel_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of each backward kernel on one backward, in the
    dtype's body (:func:`dtype_body`)."""
    return (tc_ms if dtype_body(s) == "tc" else fma_ms)(s, dq_heads_per_cta)


def bwd_mode_ms(s: BwdShape, dq_heads_per_cta: int = 1) -> dict[str, float]:
    """Modeled milliseconds of the split pair (dq, then dk/dv) and of the
    fused kernel on one backward."""
    t = kernel_ms(s, dq_heads_per_cta)
    return {"split": t["dq"] + t["dkv"], "fused": t["fused"]}


def calibrate(s: BwdShape, ms: dict[str, float], dq_heads_per_cta: int = 1) -> dict[str, float]:
    """The constants that make the model reproduce measured kernel times
    ``ms`` ("dq", "dkv", "fused") at one shape: per-(item, head)
    microseconds at head_dim 128 after the DRAM time, and the atomic rate
    from the fused time less its body (5/4 of the dk/dv time) and DRAM."""
    units = kernel_units(s, dq_heads_per_cta)
    nbytes = dram_bytes(s, dq_heads_per_cta)
    per_128 = 128.0 / s.d

    def item_us(kernel, unit):
        return (ms[kernel] - nbytes[kernel] / HBM_BYTES_PER_S * 1e3) * 1e3 / units[unit] * per_128

    dkv_us = item_us("dkv", "kv")
    body_ms = units["kv"] * FUSED_BODY_OVER_DKV * dkv_us / per_128 * 1e-3
    rest_ms = ms["fused"] - body_ms - nbytes["fused"] / HBM_BYTES_PER_S * 1e3
    return {
        "dq_gqa" if dq_heads_per_cta > 1 else "dq": item_us("dq", "dq"),
        "dkv": dkv_us,
        "atomic_adds_per_s": atomic_adds(s) / (rest_ms * 1e-3) if rest_ms > 0 else float("inf"),
    }


def calibrate_tc(
    kernel: str, shapes: list[BwdShape], ms: list[float], dq_heads_per_cta: int = 1
) -> float:
    """A tensor-core kernel's ("dq", "dq_gqa", "dkv" or "fused")
    per-(item, head) microseconds at head_dim 128 from its measured times
    ``ms`` at several shapes: least squares of (time - DRAM time) over its
    makespan in (item, head) units on its :data:`TC_CTAS_PER_SM` slots per
    SM (dq_gqa: ``dq_heads_per_cta`` heads a CTA)."""
    heads = dq_heads_per_cta if kernel == "dq_gqa" else 1
    dram = "dq" if kernel == "dq_gqa" else kernel
    units = np.asarray([_tc_units(s, kernel, heads) * s.d / 128.0 * 1e-3 for s in shapes])
    rest = np.asarray([
        t - dram_bytes(s, heads)[dram] / HBM_BYTES_PER_S * 1e3 for s, t in zip(shapes, ms)
    ])
    return float(np.dot(units, rest) / np.dot(units, units))


def choose_bwd_mode(s: BwdShape, dq_heads_per_cta: int = 1) -> str:
    """"fused" or "split", whichever the model times faster (fused on a
    tie). Fused does 5 tile products per (item, head) where split does 7
    (tensor cores: 7 executed, with the lo products, against 9), so it
    wins whenever its k-major runs spread over the card about as well as
    the q-major ones; split wins when one k-major run is far longer than
    the rest and holds the fused kernel back (its dk/dv kernel, lighter
    per item, waits on that run less). Feasibility
    (shared memory and registers, plan meta columns) and the pins are the
    caller's job (kernels/ffa.ffa_bwd_mode)."""
    t = bwd_mode_ms(s, dq_heads_per_cta)
    return "fused" if t["fused"] <= t["split"] else "split"
