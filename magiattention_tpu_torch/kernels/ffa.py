"""Flex-flash-attention: the Hopper kernels behind a host plan.

The port's counterpart of the single-device surface of
``magiattention_tpu/kernels/ffa.py`` (``FFAParams``, ``default_blocks``,
``ffa_attn_with_plan``, ``ffa_attn``, the custom VJP ``_ffa_core`` and
``ffa_bwd_mode``). Slices are diagonal bands; the host plan
(:mod:`.ffa_plan`) lists the (q tile, k tile, slice) work items, q-major
for the forward and dq, k-major for dk/dv. Seven CUDA kernels walk them:

- ``csrc/ffa_fwd.cu``: out, lse and optionally the per-head max logit,
  one CTA per (q-tile run, q head);
- ``csrc/ffa_fwd_gqa.cu``: out and lse, one CTA per (q-tile run, block of
  the query heads of one kv head), each K/V tile loaded once per item for
  the block (``MAGI_ATTENTION_FFA_GQA_PACK=1``);
- ``csrc/ffa_bwd_delta.cu``: delta = rowsum(dO * O);
- ``csrc/ffa_bwd_dq.cu``: dq over the q-major runs;
- ``csrc/ffa_bwd_dq_gqa.cu``: the same, packed like the forward
  (``MAGI_ATTENTION_FFA_GQA_PACK_DQ=1``);
- ``csrc/ffa_bwd_dkv.cu``: dk, dv over the k-major runs, the GQA group
  looped inside the CTA (with dq, the split backward: atomic-free,
  deterministic);
- ``csrc/ffa_bwd_fused.cu``: dq, dk and dv in one pass over the k-major
  runs (the fused backward: dq by float32 atomics, then a scale pass).

Every bf16 entry of the FFA kernels above (all but delta) runs on the
tensor cores (wgmma, one warpgroup per head): ``csrc/ffa_fwd_tc.cuh``
(forward), ``csrc/ffa_bwd_dq_tc.cuh`` (split dq) and ``csrc/bwd_kv_tc.cuh``
(split dk/dv and the fused backward). The float32 forward runs on them too,
as 3xTF32 (``csrc/ffa_fwd_tf32.cuh``: each operand split into tf32 hi and
lo, three products a pair, within the float32 1e-5 gates); the float32
backward entries run float32 FMA on the CUDA cores. So the packed guards
(:func:`fwd_pack_heads`, :func:`dq_pack_heads`) and the cost model's
bodies (:mod:`.tile_policy`) depend on the dtype.

:func:`ffa_fwd_dispatch` and :func:`ffa_bwd_dq_dispatch` are the one entry
of every forward and split-dq caller; they pick the packed or unpacked
kernel as the JAX package's ``ffa_fwd_pallas_dispatch`` /
``ffa_bwd_dq_pallas_dispatch`` do, before the launch (flag, group > 1, no
max-logits for the forward, and the packed CTA's budget). The packed
kernels compute the same functions as the unpacked ones, bit for bit.
:func:`ffa_bwd_mode` picks split or fused for a plan: a deterministic
request (``deterministic=True`` or MAGI_ATTENTION_DETERMINISTIC_MODE=1)
resolves split; then, in the JAX package's order, a split pin, the plan
and kernel feasibility, a fused pin, and the cost model
(:func:`.tile_policy.choose_bwd_mode`, derived for these kernels and
measured on the H100).

Tiles. The forward and backward kernels are compiled for q and k tiles of
64 or 128 rows wherever a CTA fits (``utils/mem_budget.py:
compiled_tiles``; the float32 backward bodies 64 x 64 only); a launch
takes its plan's tiles and raises for a pair not compiled for its kernel,
dtype and head dim. :func:`ffa_attn` resolves them in the JAX package's
order: the mixed-granularity gate (no tile argument, no env tile pin, no
max-logits; :func:`.tile_policy.choose_mixed_dispatch`, on by default),
then under MAGI_ATTENTION_FFA_AUTO_TILE=1 the policy's per-pass picks
(:func:`.tile_policy.choose_blocks_per_pass`), then :func:`default_blocks`,
then the backward's per-pass overrides (:func:`resolve_bwd_overrides`:
env MAGI_ATTENTION_FFA_BLOCK_{Q,K}_{DQ,DKV}, else the policy's). The
backward builds its q-major (dq) and k-major (dk/dv, fused) plans at the
tiles :class:`FFAParams` carries. A mixed dispatch runs two plans and
merges them (:class:`_FFAMixed`).

Each kernel has a plain PyTorch version beside it (``sdpa_attn`` for the
forward, ``ffa_*_plain`` for the backward), which CPU tensors take. A CUDA
tensor launches the kernel or raises: a kernel that fails to build or
launch is an error, never a quiet switch to the plain version (nor from
fused to split).

:class:`_FFACore` pairs the forward with the backward kernels as a
``torch.autograd.Function``; ``ffa_attn``/``ffa_attn_with_plan`` go
through it on CUDA, and stay the autograd-differentiable ``sdpa_attn`` on
the CPU (a mixed dispatch runs :class:`_FFAMixed` on both, over the plain
versions on the CPU). As in the JAX package, lse carries no gradient on
either route (the backward ignores its cotangent; the CPU route detaches
it), nor does max-logits.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..env import backend as env_backend
from ..env import general as env_general
from ..env import kernel as env_kernel
from ..resilience.inject import maybe_inject
from ..utils import mem_budget
from ..utils.mem_budget import SMEM_PER_CTA, compiled_tiles
from . import _build
from . import registry as _registry
from .ffa_plan import KE, KS, QE, QS, QVL, FFAPlan, get_ffa_plan
from .head_dims import (
    KERNEL_HEAD_DIMS, SPLIT_WIDTH, cta_width, is_kernel_width, kernel_head_dim, pad_head_dim,
    pad_to_kernel_width,
)
from .mask_utils import build_dense_mask_band, types_to_bands
from .sdpa import dense_max_logits, sdpa_attn
from .tile_policy import BwdShape, choose_bwd_mode


@dataclass(frozen=True)
class FFAParams:
    """Static kernel parameters of one plan."""

    num_q_tiles: int
    num_k_tiles: int
    block_q: int
    block_k: int
    softmax_scale: float
    softcap: float
    # the backward must be bitwise reproducible (ffa_bwd_mode: split)
    deterministic: bool = False
    # the backward's per-pass tiles (0: the forward's): the dq kernel's
    # q-major plan and the dk/dv (and fused) kernels' k-major plan
    block_q_dq: int = 0
    block_k_dq: int = 0
    block_q_dkv: int = 0
    block_k_dkv: int = 0

    def dq_blocks(self) -> tuple[int, int]:
        return self.block_q_dq or self.block_q, self.block_k_dq or self.block_k

    def dkv_blocks(self) -> tuple[int, int]:
        return self.block_q_dkv or self.block_q, self.block_k_dkv or self.block_k


def default_blocks(sq: int, sk: int, block_q=None, block_k=None) -> tuple[int, int]:
    """Tile sizes of a plan: the caller's, else the env's (Hopper defaults
    64 x 64). The TPU package rounds small sequences down to 16/128-row
    tiles; the CUDA kernel's tiles are compile-time, so the port keeps the
    requested size and the kernel masks the ragged edge."""
    return block_q or env_kernel.ffa_block_q(), block_k or env_kernel.ffa_block_k()


def resolve_bwd_overrides(
    bq: int, bk: int, d: int, itemsize: int,
    policy_dq: tuple[int, int] | None = None,
    policy_dkv: tuple[int, int] | None = None,
) -> tuple[tuple[int, int] | None, tuple[int, int] | None]:
    """The backward's per-pass tiles against a forward at (bq, bk):
    ``(dq_blocks, dkv_blocks)``, an entry None when unset or when the pass's
    kernel is not compiled for the pair at this dtype (``itemsize``) and
    head dim ``d`` (it then inherits the forward's tiles, as the JAX
    package's gate does for a pair its kernels cannot index). Explicit env
    settings (MAGI_ATTENTION_FFA_BLOCK_{Q,K}_{DQ,DKV}) win over the
    auto-tile policy's picks (``policy_dq``/``policy_dkv``), component-wise.
    The JAX package also asks the pair to divide the forward's padded
    geometry; each pass here has its own plan and masks its ragged edge."""

    def gate(env_bq: int, env_bk: int, policy, kernel: str):
        pol_bq, pol_bk = policy or (0, 0)
        obq, obk = env_bq or pol_bq or bq, env_bk or pol_bk or bk
        if (obq, obk) == (bq, bk) or not mem_budget.is_compiled(kernel, itemsize, d, obq, obk):
            return None
        return obq, obk

    return (
        gate(env_kernel.ffa_block_q_dq(), env_kernel.ffa_block_k_dq(), policy_dq, "dq"),
        gate(env_kernel.ffa_block_q_dkv(), env_kernel.ffa_block_k_dkv(), policy_dkv, "dkv"),
    )


def assemble_bwd_overrides(
    bq: int, bk: int, d: int, itemsize: int,
    policy_dq: tuple[int, int] | None = None,
    policy_dkv: tuple[int, int] | None = None,
) -> dict:
    """The :class:`FFAParams` fields of the resolved per-pass tiles (one
    place for single-device and CP plans): empty when both passes inherit.
    The backward builds each pass's plan from the forward plan's slices
    (:func:`bwd_plans`)."""
    dq_blocks, dkv_blocks = resolve_bwd_overrides(bq, bk, d, itemsize, policy_dq, policy_dkv)
    overrides: dict = {}
    if dq_blocks:
        overrides.update(block_q_dq=dq_blocks[0], block_k_dq=dq_blocks[1])
    if dkv_blocks:
        overrides.update(block_q_dkv=dkv_blocks[0], block_k_dkv=dkv_blocks[1])
    return overrides


def apply_bwd_overrides(
    params: FFAParams, d: int, itemsize: int,
    policy_dq: tuple[int, int] | None = None,
    policy_dkv: tuple[int, int] | None = None,
) -> FFAParams:
    """``params`` with the resolved per-pass tiles (:func:`assemble_bwd_overrides`)."""
    overrides = assemble_bwd_overrides(
        params.block_q, params.block_k, d, itemsize, policy_dq, policy_dkv,
    )
    return dataclasses.replace(params, **overrides) if overrides else params


def bwd_plans(plan: FFAPlan, params: FFAParams, sq: int, sk: int) -> tuple[FFAPlan, FFAPlan]:
    """(dq plan, dk/dv plan): the forward plan re-tiled at the pass tiles
    of ``params`` (itself where a pass inherits the forward's)."""
    return (
        plan.retiled(*params.dq_blocks(), sq, sk),
        plan.retiled(*params.dkv_blocks(), sq, sk),
    )


def plan_params(
    q_ranges, k_ranges, attn_type_map, d_lo, d_hi, sq: int, sk: int, d: int,
    softmax_scale: float | None, softcap: float,
    block_q: int | None = None, block_k: int | None = None,
    deterministic: bool = False, bwd_overrides: dict | None = None,
) -> tuple[FFAPlan, FFAParams]:
    """The (cached) plan of host slice metadata, and its kernel params
    (with the backward's per-pass tiles ``bwd_overrides``, FFAParams
    fields). Slices are mask types (``attn_type_map``, None = all FULL)
    unless explicit bands ``d_lo``/``d_hi`` are given."""
    qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
    if d_lo is None or d_hi is None:
        tm = (
            np.zeros(len(qr), dtype=np.int32)
            if attn_type_map is None
            else np.asarray(attn_type_map, dtype=np.int32)
        )
        d_lo, d_hi = types_to_bands(qr, kr, tm)
    bq, bk = default_blocks(sq, sk, block_q, block_k)
    plan = get_ffa_plan(qr, kr, d_lo, d_hi, sq, sk, bq, bk)
    params = FFAParams(
        num_q_tiles=plan.num_q_tiles,
        num_k_tiles=plan.num_k_tiles,
        block_q=bq,
        block_k=bk,
        softmax_scale=float(d) ** -0.5 if softmax_scale is None else float(softmax_scale),
        softcap=float(softcap),
        deterministic=bool(deterministic),
        **(bwd_overrides or {}),
    )
    return plan, params


# ---------------------------------------------------------------------------
# the CUDA kernels (ctypes launchers)
# ---------------------------------------------------------------------------

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_ARGTYPES = {
    # q k v out lse max_logits | work_kt meta run_ptr | sq sk hq hk d bq bk
    # nqt | scale cap | stream
    "ffa_fwd": [_P] * 9 + [_I] * 8 + [_F, _F, _P],
    # q k v out lse | work_kt meta run_ptr | sq sk hq hk d heads bq bk nqt |
    # ...
    "ffa_fwd_gqa": [_P] * 8 + [_I] * 9 + [_F, _F, _P],
    # out do delta | rows d | stream
    "ffa_bwd_delta": [_P] * 3 + [_L, _I, _P],
    # q k v do lse delta dq | work_kt meta run_ptr | sq sk hq hk d bq bk nqt
    # | ...
    "ffa_bwd_dq": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
    # q k v do lse delta dq | work_kt meta run_ptr | ... d heads bq bk nqt |
    # ...
    "ffa_bwd_dq_gqa": [_P] * 10 + [_I] * 9 + [_F, _F, _P],
    # q k v do lse delta dk dv | work_qt_t meta_t run_ptr_t | ... bq bk nkt
    # | ...
    "ffa_bwd_dkv": [_P] * 11 + [_I] * 8 + [_F, _F, _P],
    # q k v do lse delta dq dk dv | work_qt_t meta_t run_ptr_t | ... nkt | ...
    "ffa_bwd_fused": [_P] * 12 + [_I] * 8 + [_F, _F, _P],
}

# the libraries that report one CTA's shared memory in bytes, with the int
# arguments of their <name>_smem_bytes: d, then heads_per_cta (packed),
# then the q and k tiles, then a bf16 flag (0 for an instance not compiled)
_SMEM_ARGS = {
    "ffa_fwd": 4, "ffa_fwd_gqa": 5, "ffa_bwd_dq": 4, "ffa_bwd_dq_gqa": 5,
    "ffa_bwd_dkv": 4, "ffa_bwd_fused": 4,
}
# library -> the kernel name of its compiled set (utils/mem_budget.py)
LIBRARY_KERNEL = {
    "ffa_fwd": "fwd", "ffa_fwd_gqa": "fwd_gqa", "ffa_bwd_dq": "dq",
    "ffa_bwd_dq_gqa": "dq_gqa", "ffa_bwd_dkv": "dkv", "ffa_bwd_fused": "fused",
}


@lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    if name == "ffa_bwd_fused":
        # dq n scale stream
        lib.ffa_bwd_fused_convert.argtypes = [_P, _L, _F, _P]
        lib.ffa_bwd_fused_convert.restype = ctypes.c_int
    if name in _SMEM_ARGS:
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [_I] * _SMEM_ARGS[name]
        smem.restype = ctypes.c_long
    return lib


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    lib = _lib(name)
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'bf16'}")
    code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, f"{name}_kernel")


def _require_cuda(name: str, q, *others) -> None:
    if not (q.is_cuda and all(t.device == q.device for t in others)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {q.dtype} not supported")


def _kernel_inputs(name, plan: FFAPlan, q, k, v, *rest, heads: int = 1) -> list[torch.Tensor]:
    """Check what the FFA kernels take and return ``[q, k, v, *rest]``
    contiguous in q's dtype (``rest``: tensors shaped like q, e.g. dO). The
    plan's tiles must be compiled for the kernel ``name``
    (:data:`LIBRARY_KERNEL`), the dtype and the head dim (``heads``: a
    packed kernel's heads a CTA): an uncompiled pair raises, nothing falls
    back."""
    sq, hq, d = q.shape
    sk, hk, dv = v.shape
    _require_cuda(name, q, k, v, *rest)
    if not is_kernel_width(d, dv) or hq % hk:
        raise ValueError(
            f"{name}: head dims d={d}, dv={dv} (need equal, one of "
            f"{KERNEL_HEAD_DIMS}: the dispatchers pad other dims) and "
            f"hq={hq} a multiple of hk={hk}"
        )
    kernel = LIBRARY_KERNEL[name.removesuffix("_kernel")]
    tiles = compiled_tiles(kernel, q.element_size(), d, heads)
    if (plan.block_q, plan.block_k) not in tiles:
        raise ValueError(
            f"{name} ({q.dtype}, d={d}) is compiled for tiles {tiles}, "
            f"plan has ({plan.block_q}, {plan.block_k})"
        )
    if plan.num_q_tiles * plan.block_q < sq or plan.num_k_tiles * plan.block_k < sk:
        raise ValueError("plan tiles do not cover the sequences")
    if any(t.shape != q.shape for t in rest):
        raise ValueError(f"{name}: dO must have q's shape {tuple(q.shape)}")
    out = [q.contiguous()] + [t.to(q.dtype).contiguous() for t in (k, v, *rest)]
    for t in out:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned tensors")
    return out


def _row_stats(q: torch.Tensor, *stats: torch.Tensor) -> list[torch.Tensor]:
    """lse/delta as contiguous float32 ``[sq, hq]`` on q's device."""
    want = tuple(q.shape[:2])
    if any(tuple(s.shape) != want or s.device != q.device for s in stats):
        raise ValueError(f"lse and delta must be [sq, hq] = {want} on {q.device}")
    return [s.float().contiguous() for s in stats]


def ffa_fwd_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: FFAPlan,
    params: FFAParams,
    return_max_logits: bool = False,
):
    """Launch ``csrc/ffa_fwd.cu`` on CUDA tensors ``q [sq, hq, d]``,
    ``k/v [sk, hk, d]`` of one dtype (float32 or bfloat16). Returns
    (out ``[sq, hq, d]`` in q's dtype, lse ``[sq, hq]`` float32), plus the
    per-head max logit ``[hq]`` float32 (scaled, softcapped, natural units;
    -inf for a head with no attended entry) when ``return_max_logits``: the
    kernel writes one per (q tile, head), reduced here. Runs at the plan's
    tiles. Adds one to ``ffa_fwd_kernel.launches`` per launch."""
    q, k, v = _kernel_inputs("ffa_fwd_kernel", plan, q, k, v)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((sq, hq), dtype=torch.float32, device=q.device)
    tiles_ml = (
        torch.empty((plan.num_q_tiles, hq), dtype=torch.float32, device=q.device)
        if return_max_logits else None
    )
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    _launch(
        "ffa_fwd", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), 0 if tiles_ml is None else tiles_ml.data_ptr(),
        work_kt.data_ptr(), meta.data_ptr(), run_ptr.data_ptr(),
        sq, sk, hq, hk, d, plan.block_q, plan.block_k, plan.num_q_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_fwd_kernel.launches += 1
    ffa_fwd_kernel.tile_launches[(q.dtype, plan.block_q, plan.block_k)] += 1
    if tiles_ml is None:
        return out, lse
    return out, lse, tiles_ml.amax(dim=0)


def ffa_fwd_gqa_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: FFAPlan,
    params: FFAParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ffa_fwd_gqa.cu``: :func:`ffa_fwd_kernel`'s (out, lse),
    bit for bit, with one CTA per (q-tile run, block of
    :func:`fwd_pack_heads` query heads of one kv head). Raises on a
    geometry the packed kernel does not take. Adds one to
    ``ffa_fwd_gqa_kernel.launches`` per launch."""
    _require_cuda("ffa_fwd_gqa_kernel", q, k, v)
    hq, hk, d = q.shape[1], k.shape[1], q.shape[-1]
    heads = fwd_pack_heads(hq // hk, d, v.shape[-1], q.element_size(), plan.block_q, plan.block_k)
    if heads < 2:
        raise ValueError(
            f"ffa_fwd_gqa_kernel: group {hq // hk} at d={d}, tiles "
            f"({plan.block_q}, {plan.block_k}) does not pack"
        )
    q, k, v = _kernel_inputs("ffa_fwd_gqa_kernel", plan, q, k, v, heads=heads)
    sq, sk = q.shape[0], k.shape[0]
    out = torch.empty_like(q)
    lse = torch.empty((sq, hq), dtype=torch.float32, device=q.device)
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    _launch(
        "ffa_fwd_gqa", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), work_kt.data_ptr(), meta.data_ptr(),
        run_ptr.data_ptr(), sq, sk, hq, hk, d, heads, plan.block_q,
        plan.block_k, plan.num_q_tiles, params.softmax_scale, params.softcap,
    )
    ffa_fwd_gqa_kernel.launches += 1
    ffa_fwd_gqa_kernel.tile_launches[(q.dtype, plan.block_q, plan.block_k)] += 1
    return out, lse


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` does (to
    nearest, ties away from zero): the low 13 mantissa bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 forward's operand split (csrc/tc.cuh ``split_tf32``):
    ``hi = tf32(x)`` and ``lo = x - hi``, exact in float32, so ``hi + lo ==
    x``."""
    hi = tf32_round(x)
    return hi, x.float() - hi


def scores_3xtf32(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The scores ``q k^T`` (``[hq, sq, sk]``, float64) as the float32
    forward's three tf32 products give them before any accumulation error:
    ``hi_q hi_k + hi_q lo_k + lo_q hi_k``, where wgmma reads ``lo``'s top
    19 bits (the low 13 truncated), every product and sum exact in
    float64. ``q [sq, hq, d]``, ``k [sk, hk, d]``."""
    g = q.shape[1] // k.shape[1]
    (qh, ql), (kh, kl) = (tf32_split(t) for t in (q, k.repeat_interleave(g, dim=1)))
    ql, kl = ((t.view(torch.int32) & ~0x1FFF).view(torch.float32) for t in (ql, kl))
    qh, ql, kh, kl = (t.double() for t in (qh, ql, kh, kl))
    prod = lambda a, b: torch.einsum("qhd,khd->hqk", a, b)  # noqa: E731
    return prod(qh, kh) + (prod(qh, kl) + prod(ql, kh))


def ffa_delta_kernel(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ffa_bwd_delta.cu``: delta ``[sq, hq]`` float32 =
    rowsum(dO * O) of CUDA tensors ``out/do [sq, hq, dv]`` (do is cast to
    out's dtype, float32 or bfloat16). Adds one to
    ``ffa_delta_kernel.launches`` per launch."""
    if not (out.is_cuda and do.device == out.device):
        raise ValueError("ffa_delta_kernel takes CUDA tensors on one device")
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffa_delta_kernel: dtype {out.dtype} not supported")
    if do.shape != out.shape or out.dim() != 3:
        raise ValueError("ffa_delta_kernel: out and do must be [sq, hq, dv]")
    out = out.contiguous()
    do = do.to(out.dtype).contiguous()
    sq, hq, dv = out.shape
    if (dv * out.element_size()) % 16 or out.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("ffa_delta_kernel needs 16-byte aligned rows")
    delta = torch.empty((sq, hq), dtype=torch.float32, device=out.device)
    _launch(
        "ffa_bwd_delta", out.dtype, out.device,
        out.data_ptr(), do.data_ptr(), delta.data_ptr(), sq * hq, dv,
    )
    ffa_delta_kernel.launches += 1
    return delta


def ffa_bwd_dq_kernel(
    q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams
) -> torch.Tensor:
    """Launch ``csrc/ffa_bwd_dq.cu`` over the plan's q-major runs. Takes the
    forward's inputs, dO ``[sq, hq, d]``, lse and delta ``[sq, hq]``;
    returns dq ``[sq, hq, d]`` float32. Adds one to
    ``ffa_bwd_dq_kernel.launches`` per launch. ``plan`` is the dq pass's
    (:func:`bwd_plans`): the kernel runs at its tiles."""
    q, k, v, do = _kernel_inputs("ffa_bwd_dq_kernel", plan, q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    _launch(
        "ffa_bwd_dq", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        work_kt.data_ptr(), meta.data_ptr(), run_ptr.data_ptr(),
        sq, sk, hq, hk, d, plan.block_q, plan.block_k, plan.num_q_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_bwd_dq_kernel.launches += 1
    ffa_bwd_dq_kernel.tile_launches[(q.dtype, plan.block_q, plan.block_k)] += 1
    return dq


def ffa_bwd_dq_gqa_kernel(
    q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams
) -> torch.Tensor:
    """Launch ``csrc/ffa_bwd_dq_gqa.cu``: :func:`ffa_bwd_dq_kernel`'s dq,
    bit for bit, with one CTA per (q-tile run, block of
    :func:`dq_pack_heads` query heads of one kv head). Raises on a
    geometry the packed kernel does not take. Adds one to
    ``ffa_bwd_dq_gqa_kernel.launches`` per launch."""
    _require_cuda("ffa_bwd_dq_gqa_kernel", q, k, v, do)
    hq, hk, d = q.shape[1], k.shape[1], q.shape[-1]
    heads = dq_pack_heads(hq // hk, d, v.shape[-1], q.element_size(), plan.block_q, plan.block_k)
    if heads < 2:
        raise ValueError(
            f"ffa_bwd_dq_gqa_kernel: group {hq // hk} at d={d}, tiles "
            f"({plan.block_q}, {plan.block_k}) does not pack"
        )
    q, k, v, do = _kernel_inputs("ffa_bwd_dq_gqa_kernel", plan, q, k, v, do, heads=heads)
    lse, delta = _row_stats(q, lse, delta)
    sq, sk = q.shape[0], k.shape[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    work_kt, meta, run_ptr = plan.device_arrays(q.device)
    _launch(
        "ffa_bwd_dq_gqa", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        work_kt.data_ptr(), meta.data_ptr(), run_ptr.data_ptr(),
        sq, sk, hq, hk, d, heads, plan.block_q, plan.block_k, plan.num_q_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_bwd_dq_gqa_kernel.launches += 1
    ffa_bwd_dq_gqa_kernel.tile_launches[(q.dtype, plan.block_q, plan.block_k)] += 1
    return dq


def ffa_bwd_dkv_kernel(
    q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ffa_bwd_dkv.cu`` over the plan's k-major runs, one CTA
    per (k tile, kv head) looping the GQA group. Returns (dk, dv)
    ``[sk, hk, d]`` float32, per kv head. Adds one to
    ``ffa_bwd_dkv_kernel.launches`` per launch. ``plan`` is the dk/dv
    pass's (:func:`bwd_plans`): the kernel runs at its tiles."""
    q, k, v, do = _kernel_inputs("ffa_bwd_dkv_kernel", plan, q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    work_qt_t, meta_t, run_ptr_t = plan.device_arrays_t(q.device)
    _launch(
        "ffa_bwd_dkv", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        work_qt_t.data_ptr(), meta_t.data_ptr(), run_ptr_t.data_ptr(),
        sq, sk, hq, hk, d, plan.block_q, plan.block_k, plan.num_k_tiles,
        params.softmax_scale, params.softcap,
    )
    ffa_bwd_dkv_kernel.launches += 1
    ffa_bwd_dkv_kernel.tile_launches[(q.dtype, plan.block_q, plan.block_k)] += 1
    return dk, dv


def ffa_bwd_fused_convert(dq: torch.Tensor, scale: float) -> None:
    """The fused backward's convert pass alone: ``dq *= scale`` in place on
    a contiguous float32 CUDA tensor (what :func:`ffa_bwd_fused_kernel`
    runs after the one-pass kernel)."""
    if not (dq.is_cuda and dq.dtype == torch.float32 and dq.is_contiguous()):
        raise ValueError("ffa_bwd_fused_convert takes a contiguous float32 CUDA tensor")
    if dq.numel() % 4 or dq.data_ptr() % 16:
        raise ValueError("ffa_bwd_fused_convert needs 16-byte aligned rows of 4 floats")
    lib = _lib("ffa_bwd_fused")
    code = lib.ffa_bwd_fused_convert(
        dq.data_ptr(), dq.numel(), float(scale),
        torch.cuda.current_stream(dq.device).cuda_stream,
    )
    _build.check(lib, code, "ffa_bwd_fused_convert")


def ffa_bwd_fused_kernel(
    q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ffa_bwd_fused.cu`` over the plan's k-major runs: one
    CTA per (k tile, kv head) looping the GQA group, dq added with float32
    atomics into a zeroed workspace, then the convert pass (scale).
    Returns (dq ``[sq, hq, d]``, dk, dv ``[sk, hk, d]``), float32. dq is
    not bitwise reproducible (atomics); dk and dv are. Adds one to
    ``ffa_bwd_fused_kernel.launches`` per launch. ``plan`` is the k-major
    pass's (:func:`bwd_plans`): the kernel runs at its tiles."""
    q, k, v, do = _kernel_inputs("ffa_bwd_fused_kernel", plan, q, k, v, do)
    lse, delta = _row_stats(q, lse, delta)
    sq, hq, d = q.shape
    sk, hk, _ = k.shape
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    work_qt_t, meta_t, run_ptr_t = plan.device_arrays_t(q.device)
    _launch(
        "ffa_bwd_fused", q.dtype, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), work_qt_t.data_ptr(), meta_t.data_ptr(),
        run_ptr_t.data_ptr(), sq, sk, hq, hk, d, plan.block_q, plan.block_k,
        plan.num_k_tiles, params.softmax_scale, params.softcap,
    )
    ffa_bwd_fused_convert(dq, params.softmax_scale)
    ffa_bwd_fused_kernel.launches += 1
    ffa_bwd_fused_kernel.tile_launches[(q.dtype, plan.block_q, plan.block_k)] += 1
    return dq, dk, dv


for _kernel in (
    ffa_fwd_kernel, ffa_fwd_gqa_kernel, ffa_delta_kernel, ffa_bwd_dq_kernel,
    ffa_bwd_dq_gqa_kernel, ffa_bwd_dkv_kernel, ffa_bwd_fused_kernel,
):
    _kernel.launches = 0
# the tiled kernels' launches split by (dtype, q tile, k tile) of the
# launch: the same launches as ``launches``, counted at the same place
TILED_KERNELS = (
    ffa_fwd_kernel, ffa_fwd_gqa_kernel, ffa_bwd_dq_kernel, ffa_bwd_dq_gqa_kernel,
    ffa_bwd_dkv_kernel, ffa_bwd_fused_kernel,
)
for _kernel in TILED_KERNELS:
    _kernel.tile_launches = Counter()


# ---------------------------------------------------------------------------
# plain versions of the backward kernels (dense, float32)
# ---------------------------------------------------------------------------


def ffa_delta_plain(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ffa_delta_kernel`."""
    ffa_delta_plain.calls += 1
    return (out.float() * do.float()).sum(-1)


def _bwd_dense(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """P and dS ``[hq, sq, sk]`` float32 of the plan's mask, with k
    repeated over the GQA group: the arithmetic of the dq and dkv kernels
    written densely (P = exp(s - lse), 0 off the mask and on rows with
    lse = -inf; dS = P * (dP - delta), times 1 - tanh^2 under a softcap)."""
    sq, hq, _ = q.shape
    sk, hk, _ = k.shape
    g = hq // hk
    qr, kr, lo, hi = plan.slices()
    mask = build_dense_mask_band(qr, kr, lo, hi, sq, sk, device=q.device)
    kf = k.float().repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), kf).mul_(params.softmax_scale)
    dcap = None
    if params.softcap > 0.0:
        t = torch.tanh(s / params.softcap)
        s = t * params.softcap
        dcap = 1.0 - t * t
        del t
    lse_t = lse.float().T[..., None]  # [hq, sq, 1]
    finite = torch.isfinite(lse_t)
    p = s.sub_(torch.where(finite, lse_t, 0.0)).exp_()
    p.masked_fill_(~(mask[None] & finite), 0.0)
    dp = torch.einsum("qhd,khd->hqk", do.float(), v.float().repeat_interleave(g, dim=1))
    ds = dp.sub_(delta.float().T[..., None]).mul_(p)
    if dcap is not None:
        ds.mul_(dcap)
    return p, ds, kf, g


def ffa_bwd_dq_plain(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """Plain version of :func:`ffa_bwd_dq_kernel`: dq ``[sq, hq, d]``
    float32."""
    ffa_bwd_dq_plain.calls += 1
    _, ds, kf, _ = _bwd_dense(q, k, v, do, lse, delta, plan, params)
    return torch.einsum("hqk,khd->qhd", ds, kf).mul_(params.softmax_scale)


def ffa_bwd_dkv_plain(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """Plain version of :func:`ffa_bwd_dkv_kernel`: (dk, dv)
    ``[sk, hk, d]`` float32, summed over each kv head's query group."""
    ffa_bwd_dkv_plain.calls += 1
    p, ds, _, g = _bwd_dense(q, k, v, do, lse, delta, plan, params)
    sk, hk, d = k.shape
    dk = torch.einsum("hqk,qhd->khd", ds, q.float()).mul_(params.softmax_scale)
    dv = torch.einsum("hqk,qhd->khd", p, do.float())
    return (
        dk.reshape(sk, hk, g, d).sum(2),
        dv.reshape(sk, hk, g, v.shape[-1]).sum(2),
    )


def ffa_bwd_fused_plain(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """Plain version of :func:`ffa_bwd_fused_kernel`: (dq ``[sq, hq, d]``,
    dk, dv ``[sk, hk, d]``) float32 from one dense recompute."""
    ffa_bwd_fused_plain.calls += 1
    p, ds, kf, g = _bwd_dense(q, k, v, do, lse, delta, plan, params)
    sk, hk, d = k.shape
    dq = torch.einsum("hqk,khd->qhd", ds, kf).mul_(params.softmax_scale)
    del kf
    dk = torch.einsum("hqk,qhd->khd", ds, q.float()).mul_(params.softmax_scale)
    dv = torch.einsum("hqk,qhd->khd", p, do.float())
    return (
        dq,
        dk.reshape(sk, hk, g, d).sum(2),
        dv.reshape(sk, hk, g, v.shape[-1]).sum(2),
    )


for _plain in (ffa_delta_plain, ffa_bwd_dq_plain, ffa_bwd_dkv_plain, ffa_bwd_fused_plain):
    _plain.calls = 0


# ---------------------------------------------------------------------------
# device routing: a CUDA tensor launches the kernel, a CPU tensor takes the
# plain version
# ---------------------------------------------------------------------------


def ffa_fwd(q, k, v, plan: FFAPlan, params: FFAParams, return_max_logits: bool = False):
    """(out, lse[, max_logits]) over a plan by the unpacked forward: the
    kernel on CUDA; on the CPU ``sdpa_attn`` (and ``dense_max_logits``)
    over the plan's slices."""
    if q.is_cuda:
        return ffa_fwd_kernel(q, k, v, plan, params, return_max_logits)
    qr, kr, lo, hi = plan.slices()
    kw = dict(softmax_scale=params.softmax_scale, softcap=params.softcap, d_lo=lo, d_hi=hi)
    out, lse = sdpa_attn(q, k, v, qr, kr, **kw)
    if not return_max_logits:
        return out, lse
    return out, lse, dense_max_logits(q, k, qr, kr, **kw)


def ffa_fwd_gqa(q, k, v, plan: FFAPlan, params: FFAParams):
    """(out, lse) by the packed forward: the kernel on CUDA; on the CPU
    the unpacked route's plain version (the same function)."""
    if q.is_cuda:
        return ffa_fwd_gqa_kernel(q, k, v, plan, params)
    return ffa_fwd(q, k, v, plan, params)


def ffa_delta(out, do):
    """delta = rowsum(dO * O): the kernel on CUDA (rows that are not a
    whole number of 16-byte chunks padded with zero columns first), the
    plain version on the CPU."""
    if not out.is_cuda:
        return ffa_delta_plain(out, do)
    if (out.shape[-1] * out.element_size()) % 16:
        width = kernel_head_dim(out.shape[-1])
        out, do = pad_head_dim(out, width), pad_head_dim(do, width)
    return ffa_delta_kernel(out, do)


def ffa_bwd_dq(q, k, v, do, lse, delta, plan, params):
    fn = ffa_bwd_dq_kernel if q.is_cuda else ffa_bwd_dq_plain
    return fn(q, k, v, do, lse, delta, plan, params)


def ffa_bwd_dq_gqa(q, k, v, do, lse, delta, plan, params):
    fn = ffa_bwd_dq_gqa_kernel if q.is_cuda else ffa_bwd_dq_plain
    return fn(q, k, v, do, lse, delta, plan, params)


def ffa_bwd_dkv(q, k, v, do, lse, delta, plan, params):
    fn = ffa_bwd_dkv_kernel if q.is_cuda else ffa_bwd_dkv_plain
    return fn(q, k, v, do, lse, delta, plan, params)


def ffa_bwd_fused(q, k, v, do, lse, delta, plan, params):
    fn = ffa_bwd_fused_kernel if q.is_cuda else ffa_bwd_fused_plain
    return fn(q, k, v, do, lse, delta, plan, params)


# the register budget of one CTA's thread on an H100 (sm_90); the shared
# memory figures are utils/mem_budget.py's (SMEM_PER_CTA: 227 KB)
REGS_PER_THREAD = 255
# head blocks the packed kernels are compiled for, largest first
PACK_HEADS = (4, 2)


def fwd_pack_smem_bytes(d: int, heads: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Shared memory of one forward CTA of ``heads`` heads at tiles (bq,
    bk) (:func:`..utils.mem_budget.fwd_smem_bytes`). float32
    (csrc/ffa_fwd_tf32.cuh ``Smem``): the heads' q tiles in tf32 hi and lo,
    the raw k and v chunk of 32 rows and the hi and lo tiles of K and of
    V^T split from it, two stages of those where they fit, else one.
    bfloat16 (csrc/ffa_fwd_tc.cuh ``Smem``): the heads' q tiles and two
    stages of k and v tiles in bf16. Both: 16 bytes a head for the
    max-logits reduction, and 1024 bytes to align the window for the
    swizzle. At d = 256 (the column split) the v tiles are the 128-column
    half, and float32 splits each chunk straight from global memory (no
    raw chunk)."""
    return mem_budget.fwd_smem_bytes(d, bq, bk, itemsize, heads)


def dq_pack_smem_bytes(d: int, heads: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Shared memory of one dq CTA of ``heads`` heads at tiles (bq, bk)
    (:func:`..utils.mem_budget.dq_smem_bytes`). float32
    (csrc/ffa_bwd_dq.cuh ``DqSmem``): the heads' q and dO tiles, the k and
    v tiles, the dS tile. bfloat16 (csrc/ffa_bwd_dq_tc.cuh ``Smem``): the
    heads' q and dO tiles and two stages of k and v tiles in bf16, and 1024
    bytes to align the window for the swizzle. At d = 256 the float32
    tiles are the contraction's 128-column chunks."""
    return mem_budget.dq_smem_bytes(d, bq, bk, itemsize, heads)


def _pack_heads(group: int, d: int, dv: int, smem_bytes, regs_per_head: int, regs_shared: int) -> int:
    if not is_kernel_width(d, dv):
        return 1
    for heads in PACK_HEADS:
        if (
            group % heads == 0
            and smem_bytes(d, heads) <= SMEM_PER_CTA
            and heads * regs_per_head + regs_shared + 64 <= REGS_PER_THREAD
        ):
            return heads
    return 1


# the register file of one SM; a packed tensor-core CTA runs one warpgroup
# (128 threads) per head
REGS_PER_SM = 65_536
# the float32 (3xTF32) forward's thread holds beside its O accumulator the
# chunk's P V (d / 2 floats more), P's tf32 hi and lo (32) and addresses,
# indices and the softmax state (40)
TF32_FWD_REGS_SHARED = 72
# what a thread of a tensor-core dq warpgroup holds beside its dQ
# accumulator (d / 2 floats): S and dP (32 each), dS in bf16 (16), and
# addresses, indices and the row statistics (40); a 128-row k tile is
# walked as two 64-key blocks, so the same
TC_DQ_REGS_SHARED = 120


def tc_fwd_regs_shared(bk: int = 64) -> int:
    """What a thread of a tensor-core forward warpgroup holds beside its O
    accumulator (d / 2 floats) at a k tile of ``bk`` rows: S (bk / 2), P
    in bf16 (bk / 4), and addresses, indices and the softmax state (40);
    88 at 64 rows."""
    return bk // 2 + bk // 4 + 40


def _tc_pack_heads(group: int, d: int, dv: int, smem_bytes, regs_needed: int,
                   itemsize: int = 2) -> int:
    """Heads per CTA of a tensor-core packed kernel: the largest of
    :data:`PACK_HEADS` dividing the group whose CTA fits the shared memory
    limit (``smem_bytes(d, heads, itemsize)``) and whose warpgroups (128
    threads a head) each find the registers a thread needs
    (``regs_needed``, from the accumulators of one CTA's columns: a
    128-column half at d = 256) in the SM's file."""
    if not is_kernel_width(d, dv):
        return 1
    for heads in PACK_HEADS:
        regs = min(REGS_PER_THREAD, REGS_PER_SM // (128 * heads))
        if (
            group % heads == 0
            and smem_bytes(d, heads, itemsize) <= SMEM_PER_CTA
            and regs_needed <= regs
        ):
            return heads
    return 1


def fwd_pack_heads(group: int, d: int, dv: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Query heads per CTA of the packed forward at this geometry and tile
    pair, 1 where it does not pack: the largest of :data:`PACK_HEADS` that
    divides the group and fits, by :func:`_tc_pack_heads` (both bodies run
    on the tensor cores, one warpgroup a head). bfloat16: d / 2 + 88
    registers a thread at a 64-row k tile (:func:`tc_fwd_regs_shared`), 2
    heads at head_dim 128 and 4 at 64; at a 128-row k tile 2. float32
    (3xTF32): d + 72 registers a thread and :func:`fwd_pack_smem_bytes`, 2
    heads at head_dim 64 and 128 (four warpgroups would leave 128 registers
    a thread). At d = 256 bf16 packs 2 heads (64-row k tiles) and float32
    none (one head's tiles take 225 KB). A 128-row q tile packs none (its
    two warpgroups are the tile's halves). A group larger than the block
    runs in several blocks per kv head."""
    if bq != 64:
        return 1
    smem = lambda d_, h, isz: fwd_pack_smem_bytes(d_, h, isz, bq, bk)  # noqa: E731
    if itemsize == 2:
        return _tc_pack_heads(group, d, dv, smem, cta_width(d) // 2 + tc_fwd_regs_shared(bk))
    return _tc_pack_heads(group, d, dv, smem, cta_width(d) + TF32_FWD_REGS_SHARED, 4)


def dq_pack_heads(group: int, d: int, dv: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Query heads per CTA of the packed dq kernel, as
    :func:`fwd_pack_heads`. float32 (64 x 64 only): shared memory
    :func:`dq_pack_smem_bytes` (two tiles per head, so 2 heads at head_dim
    128), registers per head 4 rows x d/16 dq columns and 4 lse and delta
    values, the 4 x 4 score and dP blocks. bfloat16 (the tensor-core body):
    :func:`_tc_pack_heads` with d / 2 + 120 registers a thread, so 2 heads
    at head_dim 64 and 128 (four warpgroups would leave 128 a thread), at
    64- and 128-row k tiles. At d = 256 neither packs: bf16's two heads
    take 263,168 bytes, and the float32 instance chunks its contraction for
    one head a CTA. A 128-row q tile packs none."""
    if bq != 64:
        return 1
    if itemsize == 2:
        smem = lambda d_, h, isz: dq_pack_smem_bytes(d_, h, isz, bq, bk)  # noqa: E731
        return _tc_pack_heads(group, d, dv, smem, cta_width(d) // 2 + TC_DQ_REGS_SHARED)
    if d > SPLIT_WIDTH or bk != 64:
        return 1
    return _pack_heads(group, d, dv, dq_pack_smem_bytes, d // 4 + 8, 32)


def gqa_pack_variant(kind: str) -> str:
    """'gqa_packed' | 'plain' for the fwd / dq / dkv kernels, resolved by
    the backend registry from the pack flags (always a pin:
    :func:`.registry.gqa_pack_variant`); the call site's budget guard
    applies on top. "dkv" reads its flag, but the port has one dk/dv
    kernel (packed semantics), which either value selects."""
    return _registry.gqa_pack_variant(kind)


def _use_gqa_pack(
    group: int, d: int, dv: int, return_max_logits: bool = False, itemsize: int = 4,
    bq: int = 64, bk: int = 64,
) -> int:
    """Heads per CTA of the forward (the JAX package's ``_use_gqa_pack``
    for Hopper): the packed kernel's (:func:`fwd_pack_heads` for the input
    dtype's ``itemsize`` and the plan's tiles) when the flag is on, the
    group is > 1 and no max-logits is asked for (the packed kernel emits
    none, as in the JAX package); 1, the unpacked kernel, otherwise.
    Decided before any launch: a failed launch raises."""
    if gqa_pack_variant("fwd") != "gqa_packed" or group <= 1 or return_max_logits:
        return 1
    return fwd_pack_heads(group, d, dv, itemsize, bq, bk)


def _use_gqa_pack_dq(group: int, d: int, dv: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Heads per CTA of the dq kernel (the JAX package's
    ``_use_gqa_pack_dq``): :func:`dq_pack_heads` for the input dtype's
    ``itemsize`` and the dq plan's tiles when the flag is on and the group
    is > 1, else 1."""
    if gqa_pack_variant("dq") != "gqa_packed" or group <= 1:
        return 1
    return dq_pack_heads(group, d, dv, itemsize, bq, bk)


def ffa_fwd_dispatch(q, k, v, plan: FFAPlan, params: FFAParams, return_max_logits: bool = False):
    """The forward with the GQA-packing dispatch applied (the JAX package's
    ``ffa_fwd_pallas_dispatch``): the one entry of every forward caller
    (``_FFACore``, the sink core, ``_MultiFFA``). Returns (out, lse), plus
    max_logits ``[hq]`` when asked for (always by the unpacked kernel). On
    CUDA, head dims other than d == dv in (64, 128, 256) run padded to the
    kernels' width (:func:`.head_dims.pad_to_kernel_width`), which the
    packing guard sees; out comes back at v's width. Arms the
    ``kernel_lowering`` injection site first."""
    maybe_inject("kernel_lowering")
    dv = v.shape[-1]
    if q.is_cuda:
        q, k, v = pad_to_kernel_width(q, k, v)
    group, itemsize = q.shape[1] // k.shape[1], q.element_size()
    heads = _use_gqa_pack(
        group, q.shape[-1], v.shape[-1], return_max_logits, itemsize, plan.block_q, plan.block_k,
    )
    if heads > 1:
        res = ffa_fwd_gqa(q, k, v, plan, params)
    else:
        res = ffa_fwd(q, k, v, plan, params, return_max_logits)
    if res[0].shape[-1] == dv:
        return res
    return (res[0][..., :dv].contiguous(), *res[1:])


def ffa_bwd_dq_dispatch(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """dq of the split backward with the GQA-packing dispatch applied (the
    JAX package's ``ffa_bwd_dq_pallas_dispatch``): the one entry of every
    split-dq caller. ``plan`` is the dq pass's."""
    group, itemsize = q.shape[1] // k.shape[1], q.element_size()
    packed = _use_gqa_pack_dq(
        group, q.shape[-1], v.shape[-1], itemsize, plan.block_q, plan.block_k,
    ) > 1
    fn = ffa_bwd_dq_gqa if packed else ffa_bwd_dq
    return fn(q, k, v, do, lse, delta, plan, params)


def dkv_smem_bytes(d: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Shared memory of one dk/dv CTA at tiles (bq, bk)
    (:func:`..utils.mem_budget.dkv_smem_bytes`). float32 (csrc/bwd_kv.cuh
    ``DkvSmem``): K, V, Q and dO tiles at row stride d + 4, the P^T and
    dS^T tiles at row stride 80, the q tile's lse and delta, float32.
    bfloat16 (csrc/bwd_kv_tc.cuh ``Smem``): K and V of each warpgroup and
    two stages of Q and dO in bf16, two stages of lse and delta, and 1024
    bytes to align the window for the swizzle. At d = 256 the float32 tiles
    are the contraction's 128-column chunks."""
    return mem_budget.dkv_smem_bytes(d, bq, bk, itemsize)


def fused_bwd_smem_bytes(d: int, itemsize: int = 4, bq: int = 64, bk: int = 64) -> int:
    """Shared memory of one fused-backward CTA: the dk/dv CTA's
    (:func:`dkv_smem_bytes`; float32 keeps its dS^T tile for dq already),
    plus in bf16 a 64 x 64 bf16 dS^T tile per warpgroup that dQ = dS K
    reads."""
    return mem_budget.dkv_smem_bytes(d, bq, bk, itemsize, fused=True)


def fused_bwd_feasible(d: int, dv: int) -> bool:
    """True when the fused kernel can run this head geometry: equal q/k and
    v head dims in 64-column groups (the thread layout), its shared memory
    within the opt-in limit, and the live accumulators of a thread (dk and
    dv, d / 2; the dq block, 16; the S and dP blocks, 32) with room for
    addresses and operands (64) within the register limit. These are the
    float32 body's figures (at d = 256 those of one 128-column half); the
    bf16 tensor-core body takes less shared memory at head dims 64 and 128
    (:func:`fused_bwd_smem_bytes`) and fits its registers at each width
    without a spill (chip_smoke.py's ``tensor_cores``
    phase reports both from the build). The JAX package's
    guard is its VMEM residency (``ffa.fused_bwd_feasible``)."""
    if d != dv or d % 64:
        return False
    accumulators = cta_width(d) // 2 + 16 + 32
    return (
        fused_bwd_smem_bytes(d) <= SMEM_PER_CTA
        and accumulators + 64 <= REGS_PER_THREAD
    )


def _run_items(meta: np.ndarray, run_ptr: np.ndarray) -> np.ndarray:
    """Real (non-dummy) work items of each run."""
    real = ((meta[:, QE] > meta[:, QS]) & (meta[:, KE] > meta[:, KS])).astype(np.int64)
    return np.add.reduceat(real, run_ptr[:-1])


def bwd_shape(
    plan: FFAPlan, hq: int, hk: int, d: int, dv: int, itemsize: int,
    plan_dkv: FFAPlan | None = None,
) -> BwdShape:
    """What the backward-mode model reads of a plan and its heads: the dq
    pass's q-major runs of ``plan`` and the k-major runs of ``plan_dkv``
    (default ``plan``), each at its own tiles."""
    kv = plan if plan_dkv is None else plan_dkv
    return BwdShape(
        items_q=_run_items(plan.meta, plan.run_ptr),
        items_k=_run_items(kv.meta_t, kv.run_ptr_t),
        block_q=plan.block_q, block_k=plan.block_k, hq=hq, hk=hk, d=d, dv=dv,
        itemsize=itemsize, block_q_dkv=kv.block_q, block_k_dkv=kv.block_k,
    )


def bwd_mode_key(
    plan_dq: FFAPlan, plan_dkv: FFAPlan, hq: int, hk: int, d: int, dv: int, itemsize: int,
    dq_heads: int,
) -> tuple:
    """The registry key of one backward-mode decision: the quantities the
    cost model reads (each pass's runs, as a digest, and tiles; heads, head
    dims, dtype, dq heads a CTA)."""
    return (
        plan_dq.runs_digest("q"), plan_dkv.runs_digest("k"),
        plan_dq.block_q, plan_dq.block_k, plan_dkv.block_q, plan_dkv.block_k,
        hq, hk, d, dv, itemsize, dq_heads,
    )


def ffa_bwd_mode(
    plan: FFAPlan, params: FFAParams, d: int, dv: int, itemsize: int, hq: int, hk: int,
    sq: int | None = None, sk: int | None = None,
) -> str:
    """The backward's execution mode for one plan, "split" or "fused".

    Split is the deterministic mode (no atomics), so a deterministic
    request (``params.deterministic``, from ``flex_flash_attn_func(
    deterministic=True)``, or MAGI_ATTENTION_DETERMINISTIC_MODE=1, which
    reaches the CP runtime and the trainer too) resolves split ahead of
    every other rule, a fused pin included. Then the JAX package's order
    (``kernels/ffa.py:ffa_bwd_mode``): a split pin
    (MAGI_ATTENTION_BACKEND_FFA_BWD=split, or the legacy
    MAGI_ATTENTION_FFA_FUSED_BWD=0) wins; a plan without the visit-flag
    columns, or a head geometry the fused kernel cannot hold
    (:func:`fused_bwd_feasible`), runs split; then a fused pin wins;
    otherwise the backend registry's ``ffa_bwd`` decision, whose heuristic
    is the cost model :func:`.tile_policy.choose_bwd_mode` over the pass
    plans at ``params``' tiles (:func:`bwd_plans`; ``sq``/``sk`` default to
    the plan's padded lengths), the heads and the dq kernel the split mode
    would run (memoized per key)."""
    if params.deterministic or env_general.is_deterministic_mode_enable():
        return "split"
    pin = env_backend.ffa_bwd_pin()
    if pin == "split":
        return _registry.resolve("ffa_bwd", (), lambda: "split", pin=pin).name
    if plan.meta.shape[1] <= QVL or not fused_bwd_feasible(d, dv):
        return "split"
    if pin == "fused":
        return _registry.resolve("ffa_bwd", (), lambda: "fused", pin=pin).name
    sq = plan.num_q_tiles * plan.block_q if sq is None else sq
    sk = plan.num_k_tiles * plan.block_k if sk is None else sk
    plan_dq, plan_dkv = bwd_plans(plan, params, sq, sk)
    dq_heads = _use_gqa_pack_dq(hq // hk, d, dv, itemsize, plan_dq.block_q, plan_dq.block_k)
    key = bwd_mode_key(plan_dq, plan_dkv, hq, hk, d, dv, itemsize, dq_heads)
    return _registry.resolve(
        "ffa_bwd", key,
        lambda: choose_bwd_mode(bwd_shape(plan_dq, hq, hk, d, dv, itemsize, plan_dkv), dq_heads),
    ).name


def ffa_bwd(q, k, v, do, lse, delta, plan: FFAPlan, params: FFAParams):
    """(dq, dk, dv) float32 of one plan under :func:`ffa_bwd_mode`: the
    fused kernel, or the dq (:func:`ffa_bwd_dq_dispatch`) then dk/dv
    kernels (their plain versions on the CPU), each over its pass plan at
    the tiles ``params`` carries (:func:`bwd_plans`: the fused kernel and
    dk/dv run the k-major plan, dq the q-major one). On CUDA, head dims other
    than d == dv in (64, 128, 256) run padded to the kernels' width
    (:func:`.head_dims.pad_to_kernel_width`), which the mode and packing
    guards see; the gradients come back at their inputs' widths.

    A fused-kernel failure (the ``kernel_lowering`` site, armed before it,
    or a failed launch) is one resilience rung above the split path: with
    MAGI_ATTENTION_FALLBACK=1 it degrades to split, recorded as a
    ``resilience`` event (local to the rank: the backward's collectives do
    not change, so an out-of-memory counts at any cp)."""
    d, d_v = q.shape[-1], v.shape[-1]
    if q.is_cuda:
        q, k, v, do = pad_to_kernel_width(q, k, v, do)
    sq, sk = q.shape[0], k.shape[0]
    mode = ffa_bwd_mode(
        plan, params, q.shape[-1], v.shape[-1], q.element_size(), q.shape[1], k.shape[1], sq, sk,
    )
    plan_dq, plan_dkv = bwd_plans(plan, params, sq, sk)
    if mode == "fused":
        from ..resilience import fallback as _fallback

        try:
            maybe_inject("kernel_lowering")
            dq, dk, dv = ffa_bwd_fused(q, k, v, do, lse, delta, plan_dkv, params)
        except _fallback.kernel_failure_types() as e:
            from ..env import resilience as env_resilience

            if not env_resilience.is_fallback_enable():
                raise
            _fallback.record_resilience_event(
                "fallback", "kernel_lowering",
                action_detail="fused_bwd_to_split", error=type(e).__name__,
            )
            mode = "split"
    if mode != "fused":
        dq = ffa_bwd_dq_dispatch(q, k, v, do, lse, delta, plan_dq, params)
        dk, dv = ffa_bwd_dkv(q, k, v, do, lse, delta, plan_dkv, params)
    if dq.shape[-1] == d and dv.shape[-1] == d_v:
        return dq, dk, dv
    return dq[..., :d].contiguous(), dk[..., :d].contiguous(), dv[..., :d_v].contiguous()


class _FFACore(torch.autograd.Function):
    """FFA forward + backward over one plan (the port's ``_ffa_core``).

    Saves q, k, v, out and lse. The backward runs delta, then
    :func:`ffa_bwd` (fused or split by :func:`ffa_bwd_mode`; kernels on
    CUDA, plain versions on the CPU), and returns gradients in the input
    dtypes (the kernels emit float32). lse and max_logits are auxiliary
    outputs: their cotangents are ignored, as in the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, plan: FFAPlan, params: FFAParams, return_max_logits: bool = False):
        res = ffa_fwd_dispatch(q, k, v, plan, params, return_max_logits)
        ctx.save_for_backward(q, k, v, res[0], res[1])
        ctx.plan, ctx.params = plan, params
        ctx.mark_non_differentiable(*res[1:])
        return res

    @staticmethod
    def backward(ctx, dout, *_aux):
        q, k, v, out, lse = ctx.saved_tensors
        plan, params = ctx.plan, ctx.params
        delta = ffa_delta(out, dout)
        dq, dk, dv = ffa_bwd(q, k, v, dout, lse, delta, plan, params)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ffa_attn_with_plan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: FFAPlan,
    params: FFAParams,
    return_max_logits: bool = False,
):
    """FFA over an explicit plan, differentiable.

    Args:
        q/k/v: ``[sq,hq,d] / [sk,hk,d] / [sk,hk,dv]``, seq-major.
        plan: the host work list (its device arrays are cached on it).
        params: static dims + scalars; sq/sk must fit the tile counts.

    Returns (out ``[sq,hq,dv]``, lse ``[sq,hq]`` float32), plus the per-head
    max logit ``[hq]`` float32 when ``return_max_logits``.
    """
    if q.is_cuda:
        return _FFACore.apply(q, k, v, plan, params, return_max_logits)
    out, *aux = ffa_fwd_dispatch(q, k, v, plan, params, return_max_logits)
    return (out, *(t.detach() for t in aux))


# ---------------------------------------------------------------------------
# mixed-granularity dispatch: a coarse-tile plan over the dense slices and a
# fine-tile plan over the fragmented ones, merged by lse
# (tile_policy.choose_mixed_dispatch decides when the split pays)
# ---------------------------------------------------------------------------


def _merge_out_lse(o1, l1, o2, l2):
    """Exact two-way online-softmax merge of (out, lse) pairs, seq-major
    (the JAX package's ``_merge_out_lse``): lse natural-log, -inf on
    uncovered rows. The two passes partition the slice set, so the merged
    out is sum_i exp(lse_i - lse) out_i and the merged lse log(sum_i
    exp(lse_i)): the single-pass results up to rounding."""
    m = torch.maximum(l1, l2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w1 = torch.where(torch.isneginf(l1), 0.0, torch.exp(l1 - m_safe))
    w2 = torch.where(torch.isneginf(l2), 0.0, torch.exp(l2 - m_safe))
    tot = w1 + w2
    covered = tot > 0.0
    lse = torch.where(covered, m_safe + torch.log(torch.where(covered, tot, 1.0)), float("-inf"))
    tot_safe = torch.where(covered, tot, 1.0)[..., None]
    out = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / tot_safe
    return out.to(o1.dtype), lse


def _mixed_branch_fwd(q, k, v, plan: FFAPlan, params: FFAParams):
    """One forward pass of the mixed dispatch: (out, lse) of its plan (the
    dispatcher, so the packed kernel where the flag and its guard admit)."""
    return ffa_fwd_dispatch(q, k.to(q.dtype), v.to(q.dtype), plan, params)


class _FFAMixed(torch.autograd.Function):
    """The mixed dispatch as one differentiable function (the JAX
    package's ``_ffa_mixed``, a custom VJP there). Autodiff through the
    merge would be wrong: each branch's backward ignores its lse
    cotangent, so the coupling between the branches' softmax normalizers
    would be dropped. Instead one delta = rowsum(dO * out) is computed on
    the MERGED out, each branch's backward runs against the MERGED lse and
    that delta (so P = exp(s - lse) is the global probability of every
    pair a branch covers), and the branch gradients, which partition the
    mask, are summed: the single-pass gradients exactly. lse's cotangent is
    ignored, as in :class:`_FFACore`. On the CPU the kernels' plain
    versions run under the same function."""

    @staticmethod
    def forward(ctx, q, k, v, plan_a: FFAPlan, plan_b: FFAPlan, params_a: FFAParams,
                params_b: FFAParams):
        o1, l1 = _mixed_branch_fwd(q, k, v, plan_a, params_a)
        o2, l2 = _mixed_branch_fwd(q, k, v, plan_b, params_b)
        out, lse = _merge_out_lse(o1, l1, o2, l2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plans, ctx.params = (plan_a, plan_b), (params_a, params_b)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        delta = ffa_delta(out, dout)  # once, on the merged out
        kc, vc = k.to(q.dtype), v.to(q.dtype)
        grads = [
            ffa_bwd(q, kc, vc, dout, lse, delta, plan, params)
            for plan, params in zip(ctx.plans, ctx.params)
        ]
        (dq1, dk1, dv1), (dq2, dk2, dv2) = grads
        return (
            (dq1 + dq2).to(q.dtype), (dk1 + dk2).to(k.dtype), (dv1 + dv2).to(v.dtype),
            None, None, None, None,
        )


def _mixed_params(plan: FFAPlan, softmax_scale: float, softcap: float,
                  deterministic: bool = False) -> FFAParams:
    """Branch params of the mixed dispatch: the branch plan's tiles, no
    backward overrides, no max-logits (the dispatch gate excludes it)."""
    return FFAParams(
        num_q_tiles=plan.num_q_tiles, num_k_tiles=plan.num_k_tiles,
        block_q=plan.block_q, block_k=plan.block_k,
        softmax_scale=softmax_scale, softcap=softcap, deterministic=deterministic,
    )


@dataclass(frozen=True)
class Dispatch:
    """How :func:`ffa_attn` runs one call: ``mixed`` (two plans and their
    params, merged) or one plan at ``blocks`` with the backward's per-pass
    ``overrides``."""

    mixed: "object | None"  # tile_policy.MixedDispatch
    blocks: tuple[int, int]
    overrides: dict


def resolve_dispatch(
    qr: np.ndarray, kr: np.ndarray, d_lo: np.ndarray, d_hi: np.ndarray, sq: int, sk: int,
    d: int, dv: int, itemsize: int, block_q: int | None = None, block_k: int | None = None,
    return_max_logits: bool = False,
) -> Dispatch:
    """:func:`ffa_attn`'s tile flow, the JAX package's order: with no tile
    argument, no env tile pin (:func:`.registry.tiles_pinned`) and no
    max-logits, the mixed gate (:func:`.tile_policy.choose_mixed_dispatch`
    at the default coarse tiles); then, with no tile argument or pin and
    MAGI_ATTENTION_FFA_AUTO_TILE=1, the policy's per-pass picks
    (:func:`.tile_policy.choose_blocks_per_pass`); then
    :func:`default_blocks`; then the backward's per-pass overrides (env,
    else the policy's; :func:`assemble_bwd_overrides`). ``d``/``dv`` are
    the logical head dims; the kernels' width decides what is compiled."""
    from . import tile_policy

    width = kernel_head_dim(d, dv)
    unpinned = block_q is None and block_k is None and not _registry.tiles_pinned()
    if unpinned and not return_max_logits:
        mix = tile_policy.choose_mixed_dispatch(
            qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize=itemsize,
            coarse_blocks=default_blocks(sq, sk),
        )
        if mix is not None:
            return Dispatch(mixed=mix, blocks=mix.coarse_blocks, overrides={})
    policy_dq = policy_dkv = None
    if unpinned and tile_policy.auto_tile_enabled():
        (block_q, block_k), policy_dq, policy_dkv = tile_policy.choose_blocks_per_pass(
            qr, kr, d_lo, d_hi, sq, sk, d, dv, itemsize=itemsize,
        )
    bq, bk = default_blocks(sq, sk, block_q, block_k)
    overrides = assemble_bwd_overrides(bq, bk, width, itemsize, policy_dq, policy_dkv)
    return Dispatch(mixed=None, blocks=(bq, bk), overrides=overrides)


def ffa_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_type_map=None,
    softmax_scale: float | None = None,
    softcap: float = 0.0,
    block_q: int | None = None,
    block_k: int | None = None,
    d_lo=None,
    d_hi=None,
    return_max_logits: bool = False,
    deterministic: bool = False,
):
    """FFA over slice metadata. Same contract as :func:`~.sdpa.sdpa_attn`,
    differentiable in q, k and v. ``deterministic`` makes the CUDA
    backward bitwise reproducible (:func:`ffa_bwd_mode` resolves split).

    Slices may be given as mask types (``attn_type_map``) or directly as
    diagonal bands (``d_lo``/``d_hi``). The metadata must be host values —
    it builds the plan. The tiles follow :func:`resolve_dispatch`: a mixed
    dispatch runs :class:`_FFAMixed` (on the CPU over the kernels' plain
    versions); otherwise CUDA tensors run the kernels through
    :class:`_FFACore` at the resolved tiles, and CPU tensors run
    :func:`~.sdpa.sdpa_attn` (autograd), which no tiling changes. lse
    carries no gradient on either route, as in the JAX package.

    Returns (out ``[sq,hq,dv]`` in q's dtype, lse ``[sq,hq]`` float32,
    natural log, ``-inf`` on rows no slice covers, whose out is 0), plus
    the per-head max of the scaled, softcapped logits ``[hq]`` float32
    (``-inf`` for a head with no attended entry) when
    ``return_max_logits``.
    """
    qr = np.asarray(q_ranges, dtype=np.int32).reshape(-1, 2)
    kr = np.asarray(k_ranges, dtype=np.int32).reshape(-1, 2)
    if d_lo is None or d_hi is None:
        tm = (
            np.zeros(len(qr), dtype=np.int32)
            if attn_type_map is None
            else np.asarray(attn_type_map, dtype=np.int32)
        )
        lo, hi = types_to_bands(qr, kr, tm)
    else:
        lo = np.asarray(d_lo, dtype=np.int32).reshape(-1)
        hi = np.asarray(d_hi, dtype=np.int32).reshape(-1)
    sq, sk, d, dv = q.shape[0], k.shape[0], q.shape[-1], v.shape[-1]
    scale = float(d) ** -0.5 if softmax_scale is None else float(softmax_scale)
    how = resolve_dispatch(
        qr, kr, lo, hi, sq, sk, d, dv, q.element_size(), block_q, block_k, return_max_logits,
    )
    if how.mixed is not None:
        mix = how.mixed
        di, fi = mix.dense_idx, mix.frag_idx
        plan_a = get_ffa_plan(qr[di], kr[di], lo[di], hi[di], sq, sk, *mix.coarse_blocks)
        plan_b = get_ffa_plan(qr[fi], kr[fi], lo[fi], hi[fi], sq, sk, *mix.fine_blocks)
        det = bool(deterministic)
        return _FFAMixed.apply(
            q, k, v, plan_a, plan_b,
            _mixed_params(plan_a, scale, float(softcap), det),
            _mixed_params(plan_b, scale, float(softcap), det),
        )
    if not q.is_cuda:
        kw = dict(softmax_scale=softmax_scale, softcap=softcap, d_lo=lo, d_hi=hi)
        out, lse = sdpa_attn(q, k, v, qr, kr, None, **kw)
        if not return_max_logits:
            return out, lse.detach()
        return out, lse.detach(), dense_max_logits(q, k, qr, kr, None, **kw).detach()
    plan, params = plan_params(
        qr, kr, None, lo, hi, sq, sk, d, softmax_scale, softcap, *how.blocks,
        deterministic, how.overrides,
    )
    return _FFACore.apply(q, k, v, plan, params, return_max_logits)
