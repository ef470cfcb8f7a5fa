"""Runtime key + manager.

The port's counterpart of ``magiattention_tpu/dist_attn_runtime_mgr.py``:
``DistAttnRuntimeKey`` is a frozen, hashable key over (mask metadata, cp
group, device, chunking, config, env-flag snapshot); a
``DistAttnRuntimeMgr`` owns one rank's planning output (dispatch metas ->
comm and calc metas -> :class:`~.functional.dist_attn.DistAttnRuntime`)
and the dispatch/undispatch/calc_attn methods; ``DistAttnRuntimeDict`` is
the LRU of managers by key. Below it, ``_PlanCache`` keeps the solved host
plans by mask signature (the memory tier of the JAX plan cache), so a key
that differs only in its group or device reuses them without a solve.

The JAX mesh becomes a ``torch.distributed`` process group (``cp_group``;
None = cp 1, no collectives) plus a device. Not ported yet: the disk and
broadcast plan tiers and plan verification (ROADMAP queue A10), the
dynamic qo-comm runtime and two-level comm (A6), which raise here.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch

from .common.enum import AttnMaskType
from .common.ranges import AttnRanges
from .config import DistAttnConfig
from .env import comm as env_comm
from .env import general as env_general
from .functional.dispatch import dispatch_func, undispatch_func
from .functional.dist_attn import DistAttnRuntime
from .meta import make_attn_meta_from_dispatch_meta, make_dispatch_meta_from_qk_ranges


@dataclass(frozen=True)
class DistAttnRuntimeKey:
    """Hashable identity of one planned runtime."""

    q_ranges: tuple[tuple[int, int], ...]
    k_ranges: tuple[tuple[int, int], ...]
    attn_mask_type: tuple[int, ...]
    total_seqlen_q: int
    total_seqlen_k: int
    chunk_size: int
    cp_size: int
    cp_rank: int
    cp_group: object  # torch.distributed ProcessGroup, None at cp = 1
    device: str
    config: DistAttnConfig
    env_snapshot: tuple
    # pinned chunk->rank assignment (re-keying a new mask after dispatch)
    fixed_partitions: tuple[tuple[int, ...], ...] | None = None
    # per-rank capacity vector of the weighted dispatch; None = uniform
    capacities: tuple[float, ...] | None = None


def _plan_signature(key: DistAttnRuntimeKey) -> tuple:
    """Everything the solved host plan depends on: the key minus the
    process group, this process's rank and the device (every rank of a
    group solves the same plan). The capacity vector is appended only when
    set, as in the JAX package."""
    sig = (
        key.q_ranges,
        key.k_ranges,
        key.attn_mask_type,
        key.total_seqlen_q,
        key.total_seqlen_k,
        key.chunk_size,
        key.cp_size,
        key.config,
        key.env_snapshot,
        key.fixed_partitions,
    )
    if key.capacities is not None:
        sig = sig + (("capacities", key.capacities),)
    return sig


class _PlanCache:
    """Mask-signature-keyed LRU of solved plans (dispatch metas and the
    static comm/calc metas), one level below the runtime LRU. A hit
    returns the very objects a cold solve produced."""

    def __init__(self) -> None:
        self._d: OrderedDict[tuple, dict] = OrderedDict()

    def lookup(self, sig: tuple) -> dict | None:
        if sig in self._d:
            self._d.move_to_end(sig)
            return self._d[sig]
        return None

    def store(self, sig: tuple, entry: dict) -> None:
        self._d[sig] = entry
        self._d.move_to_end(sig)
        while len(self._d) > env_general.plan_cache_size():
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()


# plans outlive any one runtime dict
_PLAN_CACHE = _PlanCache()


def _check_ported() -> None:
    for on, name in (
        (env_comm.is_qo_comm_enable(), "MAGI_ATTENTION_QO_COMM=1 (the dynamic qo-comm runtime)"),
        (env_comm.is_hierarchical_comm_enable(), "MAGI_ATTENTION_HIERARCHICAL_COMM=1 (two-level comm)"),
    ):
        if on:
            raise NotImplementedError(f"{name} is not ported yet: ROADMAP queue A6")


class DistAttnRuntimeMgr:
    """Owns one rank's metas and runtime for one key."""

    def __init__(self, key: DistAttnRuntimeKey) -> None:
        _check_ported()
        self.key = key
        self.device = torch.device(key.device)
        cache_on = env_general.is_plan_cache_enable()
        sig = _plan_signature(key) if cache_on else None
        entry = _PLAN_CACHE.lookup(sig) if cache_on else None
        self.plan_source = "memory" if entry is not None else "cold"
        if entry is None:
            meta_q, meta_kv, bucket = make_dispatch_meta_from_qk_ranges(
                AttnRanges.from_ranges(key.q_ranges),
                AttnRanges.from_ranges(key.k_ranges),
                [AttnMaskType.from_int_type(t) for t in key.attn_mask_type],
                key.total_seqlen_q,
                key.total_seqlen_k,
                key.chunk_size,
                key.cp_size,
                key.config.dispatch_config,
                preset_partitions=(
                    [list(p) for p in key.fixed_partitions]
                    if key.fixed_partitions is not None
                    else None
                ),
                capacities=list(key.capacities) if key.capacities is not None else None,
            )
            comm_meta, calc_meta = make_attn_meta_from_dispatch_meta(
                bucket, meta_q, key.config, dispatch_meta_kv=meta_kv
            )
            entry = {"dispatch": (meta_q, meta_kv, bucket), "static": (comm_meta, calc_meta)}
            if cache_on:
                _PLAN_CACHE.store(sig, entry)
        self.dispatch_meta_q, self.dispatch_meta_kv, self.bucket = entry["dispatch"]
        self.comm_meta, self.calc_meta = entry["static"]
        overlap_cfg = key.config.overlap_config
        self.runtime = DistAttnRuntime(
            comm_meta=self.comm_meta,
            calc_meta=self.calc_meta,
            cp_rank=key.cp_rank,
            cp_group=key.cp_group,
            use_overlap=None if overlap_cfg.enable else False,
            # the key's env snapshot holds the backend flag, so a key is
            # built under the backend it runs
            backend=env_general.kernel_backend(),
        )
        self._index = {}

    def _indices(self, role: str) -> tuple[torch.Tensor, int, torch.Tensor]:
        """(this rank's global rows, its real row count, the unpermute
        index) of the q/o or k/v dispatch, as int64 tensors on the
        key's device (cached)."""
        if role not in self._index:
            meta = self.dispatch_meta_q if role == "qo" else self.dispatch_meta_kv
            r = self.key.cp_rank
            self._index[role] = (
                torch.as_tensor(meta.position_ids[r], dtype=torch.int64, device=self.device),
                meta.shard_lens[r],
                torch.as_tensor(meta.unpermute_index, dtype=torch.int64, device=self.device),
            )
        return self._index[role]

    def dispatch(self, x: torch.Tensor, role: str = "qo") -> torch.Tensor:
        rows, _, unpermute = self._indices(role)
        return dispatch_func(x, rows, unpermute, self.key.cp_group)

    def undispatch(self, x: torch.Tensor, role: str = "qo") -> torch.Tensor:
        rows, n_valid, unpermute = self._indices(role)
        return undispatch_func(x, rows, n_valid, unpermute, self.key.cp_group)

    def calc_attn(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
        if env_general.precision() == "bf16":
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        return self.runtime.calc_attn(q, k, v)

    def get_position_ids(self) -> torch.Tensor:
        """The global position of each of this rank's dispatched rows."""
        return self._indices("qo")[0]


class DistAttnRuntimeDict:
    """LRU cache of managers by key."""

    def __init__(self, maxsize: int | None = None) -> None:
        self.maxsize = maxsize or env_general.runtime_dict_size()
        self._d: OrderedDict[DistAttnRuntimeKey, DistAttnRuntimeMgr] = OrderedDict()

    def get_or_create(self, key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr:
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        mgr = DistAttnRuntimeMgr(key)
        self._d[key] = mgr
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        return mgr

    def get(self, key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr | None:
        return self._d.get(key)

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)
