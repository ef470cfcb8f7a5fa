"""Primary user API.

The port's counterpart of ``magiattention_tpu/api/magi_attn_interface.py``:
``magi_attn_flex_key`` / ``magi_attn_varlen_key`` plan a distributed mask
and return a hashable key; ``dispatch`` / ``calc_attn`` / ``undispatch``
run against the cached runtime. Where JAX takes a mesh and a cp axis name,
the port takes a ``torch.distributed`` process group (``cp_group``; None =
cp 1, no collectives) and a device (None = the current card; pass
``device="cpu"`` to run the kernels' plain versions on the CPU). Each
process holds its own rank: ``dispatch`` returns this rank's rows,
``calc_attn`` takes and returns them, ``undispatch`` gives every rank the
whole natural-order tensor; ``roll`` rolls the global sequence in the
dispatched layout. Under MAGI_ATTENTION_QO_COMM=1 the key plans the
dynamic (qo-comm) runtime instead of the static one. Tensor parallelism
over heads (``head_axis``) is not ported yet.

Hybrid-attention models (e.g. sliding-window layers beside global ones)
plan one mask for the dispatch and re-key the others onto its layout
(``make_flex_key_for_new_mask_after_dispatch`` /
``make_varlen_key_for_new_mask_after_dispatch``). A sequence that does not
divide into ``cp_size * chunk_size`` is padded first: ``compute_pad_size``
and ``apply_padding`` (``api/functools.py``), or ``pad_size`` of
``init_dist_attn_runtime_key``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common.enum import AttnMaskType
from ..common.forward_meta import AttnForwardMeta
from ..common.range import RangeError
from ..common.ranges import AttnRanges
from ..config import DistAttnConfig
from ..device import resolve_device
from ..dist_attn_runtime_mgr import (
    DistAttnRuntimeDict,
    DistAttnRuntimeKey,
    DistAttnRuntimeMgr,
)
from ..env import general as env_general
from ..kernels.mask_utils import types_to_bands
from .functools import apply_padding, infer_attn_mask_from_cu_seqlens


def _check_no_overlapping_slices(q_ranges, k_ranges, mask_ints) -> None:
    """Sanity invariant: slice coverage must be disjoint — overlapping
    (q, k) coverage is double-counted by the kernel's online softmax.
    Pairwise band geometry, gated behind MAGI_ATTENTION_SANITY_CHECK."""
    n = len(q_ranges)
    if n > 4096:  # keep the check O(n^2)-affordable
        return
    qr = np.array([[r.start, r.end] for r in q_ranges], np.int64)
    kr = np.array([[r.start, r.end] for r in k_ranges], np.int64)
    lo, hi = types_to_bands(
        qr.astype(np.int32), kr.astype(np.int32), np.asarray(mask_ints, np.int32)
    )
    lo = lo.astype(np.int64)
    hi = hi.astype(np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            q0 = max(qr[i, 0], qr[j, 0])
            q1 = min(qr[i, 1], qr[j, 1])
            k0 = max(kr[i, 0], kr[j, 0])
            k1 = min(kr[i, 1], kr[j, 1])
            if q0 >= q1 or k0 >= k1:
                continue
            d_lo = max(lo[i], lo[j], k0 - (q1 - 1))
            d_hi = min(hi[i], hi[j], (k1 - 1) - q0)
            if d_lo <= d_hi:
                raise ValueError(
                    f"slices {i} and {j} overlap on q[{q0},{q1}) x "
                    f"k[{k0},{k1}) (band [{d_lo},{d_hi}]): overlapping "
                    "coverage double-counts in the softmax — make the "
                    "slice set disjoint"
                )


_runtime_dict = DistAttnRuntimeDict()
_most_recent_key: DistAttnRuntimeKey | None = None


def _auto_chunk_size(total_seqlen: int, cp_size: int, uneven_shard: bool = False) -> int:
    """The largest chunk <= 512 giving every rank at least
    ``MAGI_ATTENTION_MIN_CHUNKS_PER_RANK`` chunks. Uneven shard only needs
    ``chunk_size | total_seqlen``; even shard also needs the chunk count
    divisible by cp_size."""
    shard = total_seqlen // cp_size
    min_chunks = max(1, env_general.min_chunks_per_rank())
    target = min(512, max(1, shard // min_chunks))
    for cs in range(target, 0, -1):
        if uneven_shard:
            if total_seqlen % cs == 0:
                return cs
        elif total_seqlen % (cs * cp_size) == 0:
            return cs
    return 1


def _validate_mask_inputs(
    q_ranges: AttnRanges,
    k_ranges: AttnRanges,
    mask_ints: tuple[int, ...],
    total_seqlen_q: int,
    total_seqlen_k: int,
) -> None:
    """Always-on key-entry validation: a count mismatch would otherwise
    zip-truncate silently downstream."""
    if not (len(q_ranges) == len(k_ranges) == len(mask_ints)):
        raise ValueError(
            f"q_ranges ({len(q_ranges)}), k_ranges ({len(k_ranges)}) and "
            f"attn_mask_type ({len(mask_ints)}) must have the same length"
        )
    if q_ranges.end > total_seqlen_q:
        bad = max(q_ranges, key=lambda r: r.end)
        raise RangeError(
            f"q range {bad} reaches {q_ranges.end} > total_seqlen_q {total_seqlen_q}"
        )
    if k_ranges.end > total_seqlen_k:
        bad = max(k_ranges, key=lambda r: r.end)
        raise RangeError(
            f"k range {bad} reaches {k_ranges.end} > total_seqlen_k {total_seqlen_k}"
        )


def magi_attn_flex_key(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_mask_type: Sequence[AttnMaskType | str | int],
    total_seqlen_q: int,
    total_seqlen_k: int,
    *,
    cp_group=None,
    device: torch.device | str | None = None,
    head_axis: str | None = None,
    chunk_size: int | None = None,
    dist_attn_config: DistAttnConfig | None = None,
) -> DistAttnRuntimeKey:
    """Plan a flexible-mask distributed attention; returns the runtime key.

    The mask is ``(q_ranges, k_ranges, attn_mask_type)`` slice metadata in
    global coordinates. ``cp_group`` is the context-parallel process group
    (None: cp 1); every rank of it calls this with the same mask.
    ``total_seqlen_q`` must divide into ``cp_size * chunk_size`` (pad the
    sequence first).
    """
    global _most_recent_key
    if head_axis is not None:
        raise NotImplementedError(
            "head_axis (tensor parallelism over heads) is not ported yet"
        )
    if not isinstance(q_ranges, AttnRanges):
        q_ranges = AttnRanges.from_ranges(q_ranges)
    if not isinstance(k_ranges, AttnRanges):
        k_ranges = AttnRanges.from_ranges(k_ranges)
    mask_ints = tuple(AttnMaskType.normalize(t).to_int_type() for t in attn_mask_type)
    _validate_mask_inputs(q_ranges, k_ranges, mask_ints, total_seqlen_q, total_seqlen_k)
    if env_general.is_sanity_check_enable():
        _check_no_overlapping_slices(q_ranges, k_ranges, mask_ints)
    device = resolve_device(device)
    if cp_group is None:
        cp_size, cp_rank = 1, 0
    else:
        cp_size, cp_rank = dist.get_world_size(cp_group), dist.get_rank(cp_group)
    if chunk_size is None:
        uneven = bool(dist_attn_config and dist_attn_config.dispatch_config.uneven_shard)
        chunk_size = (
            dist_attn_config.dispatch_config.chunk_size
            if dist_attn_config and dist_attn_config.dispatch_config.chunk_size
            else _auto_chunk_size(total_seqlen_q, cp_size, uneven)
        )
    key = DistAttnRuntimeKey(
        q_ranges=tuple(q_ranges.to_naive_ranges()),
        k_ranges=tuple(k_ranges.to_naive_ranges()),
        attn_mask_type=mask_ints,
        total_seqlen_q=total_seqlen_q,
        total_seqlen_k=total_seqlen_k,
        chunk_size=chunk_size,
        cp_size=cp_size,
        cp_rank=cp_rank,
        cp_group=cp_group,
        device=str(device),
        config=dist_attn_config or DistAttnConfig(),
        env_snapshot=env_general.snapshot_env(),
    )
    _runtime_dict.get_or_create(key)
    _most_recent_key = key
    return key


def magi_attn_varlen_key(
    cu_seqlens_q: Sequence[int],
    cu_seqlens_k: Sequence[int] | None = None,
    *,
    causal: bool = False,
    window_size: tuple[int, int] = (-1, -1),
    global_window_size: int = 0,
    cp_group=None,
    device: torch.device | str | None = None,
    head_axis: str | None = None,
    chunk_size: int | None = None,
    dist_attn_config: DistAttnConfig | None = None,
) -> DistAttnRuntimeKey:
    """Varlen (cu_seqlens) convenience wrapper; ``window_size`` /
    ``global_window_size`` compile per-segment sliding windows with global
    (sink) tokens."""
    q_ranges, k_ranges, types = infer_attn_mask_from_cu_seqlens(
        cu_seqlens_q, cu_seqlens_k, causal,
        window_size=window_size, global_window_size=global_window_size,
    )
    return magi_attn_flex_key(
        q_ranges, k_ranges, types,
        total_seqlen_q=q_ranges.end, total_seqlen_k=k_ranges.end,
        cp_group=cp_group, device=device, head_axis=head_axis,
        chunk_size=chunk_size, dist_attn_config=dist_attn_config,
    )


def make_flex_key_for_new_mask_after_dispatch(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_mask_type: Sequence[AttnMaskType | str | int],
    key_for_dispatch: DistAttnRuntimeKey,
    dist_attn_config: DistAttnConfig | None = None,
) -> DistAttnRuntimeKey:
    """A key for a new mask over the same dispatch (ref :1320).

    For hybrid-attention models applying several masks in one pass: one
    mask is planned for the dispatch (load balance and communication
    follow it); the others keep its chunk -> rank assignment (its
    ``fixed_partitions``, with its capacity vector) and get fresh
    communication and calc plans, so tensors dispatched by
    ``key_for_dispatch`` feed ``calc_attn`` under the new key as they are.
    No balance guarantee for the extra masks."""
    global _most_recent_key
    mgr0 = _mgr(key_for_dispatch)
    if not isinstance(q_ranges, AttnRanges):
        q_ranges = AttnRanges.from_ranges(q_ranges)
    if not isinstance(k_ranges, AttnRanges):
        k_ranges = AttnRanges.from_ranges(k_ranges)
    mask_ints = tuple(AttnMaskType.normalize(t).to_int_type() for t in attn_mask_type)
    old = key_for_dispatch
    # the same rules as magi_attn_flex_key: the new mask must fit the
    # layout planned by key_for_dispatch
    _validate_mask_inputs(q_ranges, k_ranges, mask_ints, old.total_seqlen_q, old.total_seqlen_k)
    key = DistAttnRuntimeKey(
        q_ranges=tuple(q_ranges.to_naive_ranges()),
        k_ranges=tuple(k_ranges.to_naive_ranges()),
        attn_mask_type=mask_ints,
        total_seqlen_q=old.total_seqlen_q,
        total_seqlen_k=old.total_seqlen_k,
        chunk_size=old.chunk_size,
        cp_size=old.cp_size,
        cp_rank=old.cp_rank,
        cp_group=old.cp_group,
        device=old.device,
        config=dist_attn_config or old.config,
        env_snapshot=env_general.snapshot_env(),
        fixed_partitions=tuple(tuple(p) for p in mgr0.dispatch_meta_q.partitions),
        capacities=old.capacities,
    )
    _runtime_dict.get_or_create(key)
    _most_recent_key = key
    return key


def make_varlen_key_for_new_mask_after_dispatch(
    cu_seqlens_q: Sequence[int],
    cu_seqlens_k: Sequence[int] | None,
    key_for_dispatch: DistAttnRuntimeKey,
    causal: bool = False,
    window_size: tuple[int, int] = (-1, -1),
    global_window_size: int = 0,
    dist_attn_config: DistAttnConfig | None = None,
) -> DistAttnRuntimeKey:
    """The varlen form of re-keying (ref :1172): the mask compiles as
    :func:`magi_attn_varlen_key` compiles it (windows, global tokens)."""
    q_ranges, k_ranges, types = infer_attn_mask_from_cu_seqlens(
        cu_seqlens_q, cu_seqlens_k, causal,
        window_size=window_size, global_window_size=global_window_size,
    )
    return make_flex_key_for_new_mask_after_dispatch(
        q_ranges, k_ranges, types, key_for_dispatch, dist_attn_config
    )


def _mgr(key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr:
    mgr = _runtime_dict.get(key)
    if mgr is None:
        raise KeyError(
            "unknown DistAttnRuntimeKey — create it with magi_attn_flex_key "
            "in this process first"
        )
    return mgr


def dispatch(x: torch.Tensor, key: DistAttnRuntimeKey, role: str = "qo") -> torch.Tensor:
    """Global natural-order tensor -> this rank's dispatched rows."""
    return _mgr(key).dispatch(x, "qo" if role == "qo" else "kv")


def undispatch(x: torch.Tensor, key: DistAttnRuntimeKey, role: str = "qo") -> torch.Tensor:
    """This rank's dispatched rows -> the global natural-order tensor."""
    return _mgr(key).undispatch(x, "qo" if role == "qo" else "kv")


def calc_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key: DistAttnRuntimeKey,
    return_max_logits: bool = False,
) -> tuple[torch.Tensor, AttnForwardMeta]:
    """Distributed attention over this rank's dispatched q/k/v:
    (out, AttnForwardMeta(lse)), this rank's rows. Differentiable in q, k
    and v; lse carries no gradient.

    With ``return_max_logits``, ``meta.max_logits`` is the per-head max of
    the scaled, softcapped logits ``[hq]`` float32, all-reduced (MAX) over
    the cp group (the same on every rank; -inf for a head with no attended
    entry)."""
    out, lse, *ml = _mgr(key).calc_attn(q, k, v, return_max_logits)
    return out, AttnForwardMeta(lse=lse, max_logits=ml[0] if ml else None)


def roll(x: torch.Tensor, key: DistAttnRuntimeKey, shifts: int = 1) -> torch.Tensor:
    """Global roll on dispatched tensors (for the label shift of
    multi-token prediction, ref :965): this rank's rows of the global
    sequence rolled by ``shifts``, in the same dispatch. Differentiable.
    The JAX package's argument order ``(x, key, shifts)``."""
    return _mgr(key).roll(x, shifts)


def roll_simple(x: torch.Tensor, key: DistAttnRuntimeKey, shifts: int = 1) -> torch.Tensor:
    """Alias of :func:`roll` under the reference's ``roll_simple`` name,
    with the JAX package's argument order ``(x, key, shifts)``."""
    return roll(x, key, shifts)


def get_position_ids(key: DistAttnRuntimeKey) -> torch.Tensor:
    """The global position of each of this rank's dispatched rows (for
    RoPE): ``[shard]`` int64 on the key's device."""
    return _mgr(key).get_position_ids()


def magi_attn_flex_dispatch(
    x: torch.Tensor,
    q_ranges,
    k_ranges,
    attn_mask_type,
    total_seqlen_q: int,
    total_seqlen_k: int,
    **key_kwargs,
) -> tuple[torch.Tensor, DistAttnRuntimeKey]:
    """Key + dispatch in one call: ``(this rank's rows of x, key)`` (ref
    :730; keyword arguments as :func:`magi_attn_flex_key` takes them)."""
    key = magi_attn_flex_key(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, total_seqlen_k, **key_kwargs
    )
    return dispatch(x, key), key


def magi_attn_varlen_dispatch(
    x: torch.Tensor, cu_seqlens_q, cu_seqlens_k=None, **key_kwargs
) -> tuple[torch.Tensor, DistAttnRuntimeKey]:
    """Key + dispatch for cu_seqlens masks: ``(this rank's rows of x,
    key)`` (ref :307; keyword arguments as :func:`magi_attn_varlen_key`)."""
    key = magi_attn_varlen_key(cu_seqlens_q, cu_seqlens_k, **key_kwargs)
    return dispatch(x, key), key


def get_most_recent_key() -> DistAttnRuntimeKey | None:
    """The key the last key call of this process planned (or re-keyed)."""
    return _most_recent_key


def init_dist_attn_runtime_key(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_mask_type: Sequence[AttnMaskType | str | int],
    total_seqlen_q: int,
    total_seqlen_k: int,
    chunk_size: int,
    *,
    cp_group=None,
    device: torch.device | str | None = None,
    head_axis: str | None = None,
    pad_size: int = 0,
    dist_attn_config: DistAttnConfig | None = None,
) -> DistAttnRuntimeKey:
    """Reference-named runtime-key init (ref dist_attn_runtime_mgr.py:486):
    :func:`magi_attn_flex_key` with ``pad_size > 0`` applying
    :func:`.functools.apply_padding` to the mask first (the pad rows
    attend nothing) and growing both totals by it. The reference's head
    counts and head dim are not needed: the kernels take them from the
    tensors."""
    if not isinstance(q_ranges, AttnRanges):
        q_ranges = AttnRanges.from_ranges(q_ranges)
    if not isinstance(k_ranges, AttnRanges):
        k_ranges = AttnRanges.from_ranges(k_ranges)
    mask_types = [AttnMaskType.normalize(t) for t in attn_mask_type]
    if pad_size > 0:
        q_ranges, k_ranges, mask_types = apply_padding(
            q_ranges, k_ranges, mask_types, total_seqlen_q, pad_size
        )
        total_seqlen_q += pad_size
        total_seqlen_k += pad_size
    return magi_attn_flex_key(
        q_ranges, k_ranges, mask_types, total_seqlen_q, total_seqlen_k,
        cp_group=cp_group, device=device, head_axis=head_axis,
        chunk_size=chunk_size, dist_attn_config=dist_attn_config,
    )


def init_dist_attn_runtime_mgr(
    q_ranges: AttnRanges | Sequence[Sequence[int]],
    k_ranges: AttnRanges | Sequence[Sequence[int]],
    attn_mask_type: Sequence[AttnMaskType | str | int],
    total_seqlen_q: int,
    total_seqlen_k: int,
    chunk_size: int,
    *,
    cp_group=None,
    device: torch.device | str | None = None,
    head_axis: str | None = None,
    pad_size: int = 0,
    dist_attn_config: DistAttnConfig | None = None,
) -> DistAttnRuntimeMgr:
    """Reference-named manager init (ref dist_attn_runtime_mgr.py:558):
    plans the mask as :func:`init_dist_attn_runtime_key` does and returns
    the manager itself (from the same cache as the key API)."""
    key = init_dist_attn_runtime_key(
        q_ranges, k_ranges, attn_mask_type, total_seqlen_q, total_seqlen_k, chunk_size,
        cp_group=cp_group, device=device, head_axis=head_axis, pad_size=pad_size,
        dist_attn_config=dist_attn_config,
    )
    return _mgr(key)


def clear_cache() -> None:
    _runtime_dict.clear()
