"""Runtime key + manager.

The port's counterpart of ``magiattention_tpu/dist_attn_runtime_mgr.py``:
``DistAttnRuntimeKey`` is a frozen, hashable key over (mask metadata, cp
group, device, chunking, config, env-flag snapshot); a
``DistAttnRuntimeMgr`` owns one rank's planning output (dispatch metas ->
comm and calc metas -> :class:`~.functional.dist_attn.DistAttnRuntime`)
and the dispatch/undispatch/calc_attn/roll methods; under
MAGI_ATTENTION_QO_COMM=1 the planning output is a dynamic plan run by
:class:`~.functional.dynamic_dist_attn.DynamicDistAttnRuntime` instead.
``DistAttnRuntimeDict`` is the LRU of managers by key. Below it,
``_PlanCache`` keeps the solved host plans by mask signature (the memory
tier of the JAX plan cache), so a key that differs only in its group or
device reuses them without a solve, and each mask family's latest dynamic
solve state, which seeds the next dynamic solve of the family (the
incremental re-solve).

The JAX mesh becomes a ``torch.distributed`` process group (``cp_group``;
None = cp 1, no collectives) plus a device, or a
:class:`~.parallel._mesh.ProcessMesh` with JAX's ``cp_axis`` and
``head_axis``: the cp group is then this process's line along
``cp_axis`` (for a pair of axes, the flat group over both, outer-major),
two-level comm runs over the pair's two lines when
MAGI_ATTENTION_HIERARCHICAL_COMM=1, and ``head_axis`` names the TP line.

Observability and resilience, as in the JAX package: the plan cache and
the runtime LRU count their hits and misses (and mirror them into
telemetry), cache hits emit ``plan_solve`` records, every static build a
``plan_build`` record; under MAGI_ATTENTION_FALLBACK=1 a failed dynamic
solve falls back to the static plan (degradation chain 2) and a failed
build is retried once, a build that still fails never being cached
(chain 3). Not ported yet: the disk and broadcast plan tiers and plan
verification (ROADMAP queue A item 5b).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import torch

from . import telemetry
from .common.enum import AttnMaskType
from .common.ranges import AttnRanges
from .config import DistAttnConfig
from .env import comm as env_comm
from .env import general as env_general
from .env import resilience as env_resilience
from .functional.dispatch import dispatch_func, undispatch_func
from .functional.dist_attn import DistAttnRuntime, dist_attn_func
from .functional.dynamic_dist_attn import DynamicDistAttnRuntime
from .meta import make_attn_meta_from_dispatch_meta, make_dispatch_meta_from_qk_ranges
from .meta._make_attn_meta import make_dynamic_attn_plan


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
    # the process mesh (ProcessMesh) the groups come from; None: cp_group
    mesh: object = None
    cp_axis: str | tuple[str, str] = "cp"
    head_axis: str | None = None


def _mesh_shape_for(key: DistAttnRuntimeKey) -> tuple[int, int] | None:
    """(n_outer, n_inner) for two-level planning, or None: exactly when
    the runtime will run two-level comm (a pair ``cp_axis`` of a mesh and
    MAGI_ATTENTION_HIERARCHICAL_COMM=1)."""
    if (
        key.mesh is not None
        and isinstance(key.cp_axis, tuple)
        and env_comm.is_hierarchical_comm_enable()
    ):
        outer, inner = key.cp_axis
        return (key.mesh.shape[outer], key.mesh.shape[inner])
    return None


def _plan_signature(key: DistAttnRuntimeKey) -> tuple:
    """Everything the solved host plan depends on: the key minus the
    process group, this process's rank, the device and ``head_axis``
    (every rank of a group solves the same plan; TP shards the heads of
    an already-solved plan). The capacity vector and, under two-level
    planning, the mesh shape are appended only when set, as in the JAX
    package, so that a flat and a two-level plan never share an entry."""
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
    mesh_shape = _mesh_shape_for(key)
    if mesh_shape is not None:
        sig = sig + (("mesh_shape", mesh_shape),)
    return sig


def _mask_family(sig: tuple) -> tuple:
    """The signature minus the mask itself (q/k ranges and types): the
    dynamic-mask steps of one workload share a family, so a new signature
    seeds its incremental re-solve from the family's previous solve."""
    return sig[3:]


class _PlanCache:
    """Mask-signature-keyed LRU of solved plans (dispatch metas, and the
    static comm/calc metas or the dynamic plan), one level below the
    runtime LRU. A hit returns the very objects a cold solve produced. It
    also keeps each mask family's latest dynamic solve state."""

    def __init__(self) -> None:
        self._d: OrderedDict[tuple, dict] = OrderedDict()
        self._prev_dyn: dict[tuple, object] = {}
        self._hits = 0
        self._misses = 0

    def lookup(self, sig: tuple) -> dict | None:
        if sig in self._d:
            self._d.move_to_end(sig)
            self._hits += 1
            telemetry.inc("plan_solve.cache_hit")
            return self._d[sig]
        self._misses += 1
        telemetry.inc("plan_solve.cache_miss")
        return None

    def store(self, sig: tuple, entry: dict) -> None:
        self._d[sig] = entry
        self._d.move_to_end(sig)
        while len(self._d) > env_general.plan_cache_size():
            self._d.popitem(last=False)

    def prev_dyn_state(self, family: tuple):
        return self._prev_dyn.get(family)

    def set_dyn_state(self, family: tuple, state) -> None:
        if state is not None:
            self._prev_dyn[family] = state

    def get_stats(self) -> dict[str, int]:
        return {"hits": self._hits, "misses": self._misses, "size": len(self._d)}

    def clear(self) -> None:
        self._d.clear()
        self._prev_dyn.clear()
        self._hits = 0
        self._misses = 0


# plans outlive any one runtime dict
_PLAN_CACHE = _PlanCache()


def _check_supported(key: DistAttnRuntimeKey) -> None:
    """The JAX manager's refusals under qo-comm
    (``magiattention_tpu/dist_attn_runtime_mgr.py:512-521``), and a
    ``head_axis`` that names no axis of the key's mesh."""
    if env_comm.is_qo_comm_enable():
        if key.head_axis is not None:
            raise NotImplementedError(
                "MAGI_ATTENTION_QO_COMM=1 does not support head_axis "
                "(TP head sharding) yet; unset one of the two"
            )
        if env_comm.is_hierarchical_comm_enable():
            raise NotImplementedError(
                "MAGI_ATTENTION_QO_COMM=1 does not support "
                "MAGI_ATTENTION_HIERARCHICAL_COMM=1 yet; unset one"
            )
    if key.head_axis is not None and (key.mesh is None or key.head_axis not in key.mesh.shape):
        raise ValueError(
            f"head_axis={key.head_axis!r} names no axis of the key's mesh: "
            "pass mesh=ProcessMesh(...) with that axis"
        )


class DistAttnRuntimeMgr:
    """Owns one rank's metas and runtime for one key."""

    def __init__(self, key: DistAttnRuntimeKey) -> None:
        _check_supported(key)
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
            entry = {"dispatch": (meta_q, meta_kv, bucket)}
        self.dispatch_meta_q, self.dispatch_meta_kv, self.bucket = entry["dispatch"]
        self._index = {}
        self._mesh = None
        # the observatory's mesh signature (the JAX package's form)
        shape = key.mesh.shape if key.mesh is not None else {"cp": key.cp_size}
        mesh_sig = repr((tuple(sorted(shape.items())), key.cp_axis, key.head_axis))
        self.dynamic_plan = None
        if env_comm.is_qo_comm_enable():
            # the dynamic (qo-comm) planner: q/o rows move too, one stage
            if "dynamic" in entry:
                self._record_cache_hit("dynamic")
            else:
                try:
                    plan = make_dynamic_attn_plan(
                        AttnRanges.from_ranges(key.q_ranges),
                        AttnRanges.from_ranges(key.k_ranges),
                        [AttnMaskType.from_int_type(t) for t in key.attn_mask_type],
                        self.dispatch_meta_q, key.config,
                        dispatch_meta_kv=self.dispatch_meta_kv,
                        prev_state=_PLAN_CACHE.prev_dyn_state(_mask_family(sig)) if cache_on else None,
                    )
                except Exception as e:
                    # degradation chain 2: a failed dynamic solve falls back
                    # to the static solver plan (same mask, kv-comm execution)
                    if not env_resilience.is_fallback_enable():
                        raise
                    from .resilience.fallback import record_resilience_event

                    record_resilience_event(
                        "fallback", "dynamic_plan_solve",
                        action_detail="static_plan", error=type(e).__name__,
                    )
                else:
                    entry = {**entry, "dynamic": plan}
                    if cache_on:
                        _PLAN_CACHE.store(sig, entry)
                        _PLAN_CACHE.set_dyn_state(_mask_family(sig), plan.solver_state)
            if "dynamic" in entry:
                self.dynamic_plan = entry["dynamic"]
                self.comm_meta = self.calc_meta = None
                self.runtime = DynamicDistAttnRuntime(
                    self.dynamic_plan, cp_rank=key.cp_rank, cp_group=key.cp_group,
                    backend=None, mesh_sig=mesh_sig,
                )
                if telemetry.enabled():
                    p = self.dynamic_plan
                    telemetry.record_event(
                        "plan_build",
                        planner="dynamic",
                        cp_size=key.cp_size,
                        overlap_degree=1,
                        stages=[
                            {"name": name, **cast.telemetry_dict()}
                            for name, cast in (
                                ("q_cast", p.q_cast), ("kv_cast", p.kv_cast), ("ret", p.ret),
                            )
                        ],
                    )
                return
        if "static" in entry:
            self._record_cache_hit("static")
        else:
            entry = {
                **entry,
                "static": make_attn_meta_from_dispatch_meta(
                    self.bucket, self.dispatch_meta_q, key.config,
                    dispatch_meta_kv=self.dispatch_meta_kv,
                    mesh_shape=_mesh_shape_for(key),
                ),
            }
            if cache_on:
                _PLAN_CACHE.store(sig, entry)
        self.comm_meta, self.calc_meta = entry["static"]
        overlap_cfg = key.config.overlap_config
        mesh_shape = _mesh_shape_for(key)
        self.runtime = DistAttnRuntime(
            comm_meta=self.comm_meta,
            calc_meta=self.calc_meta,
            cp_rank=key.cp_rank,
            cp_group=key.cp_group,
            use_overlap=None if overlap_cfg.enable else False,
            # the registry's calc_attn decision under the runtime's policy
            # key (MAGI_ATTENTION_KERNEL_BACKEND pins it, else the store or ffa)
            backend=None,
            hier=None if mesh_shape is None else (
                mesh_shape, tuple(key.mesh.group(axis) for axis in key.cp_axis)
            ),
            tp=None if key.head_axis is None else (
                key.head_axis, key.mesh.group(key.head_axis), key.mesh.shape[key.head_axis]
            ),
            mesh_sig=mesh_sig,
        )
        self._record_comm_plan()

    def _record_cache_hit(self, planner: str) -> None:
        if telemetry.enabled():
            telemetry.record_event(
                "plan_solve", planner=planner, event="cache_hit",
                source=self.plan_source, incremental=False,
                wall_ms=0.0, rows_resolved=0,
            )

    def _record_comm_plan(self) -> None:
        """The static plan's ``plan_build`` record: per-stage payload rows,
        wire rows, padding, lowering (the JAX package's fields; the port's
        flat stages run one all-to-all, two-level stages the two phases)."""
        if not telemetry.enabled():
            return
        executed = "hier" if self.runtime.hier else "a2a"
        telemetry.record_event(
            "plan_build",
            planner="static",
            cp_size=self.key.cp_size,
            overlap_degree=self.comm_meta.overlap_degree,
            stages=[
                {
                    "stage": st,
                    "xprof_scope": f"group_cast_stage{st}",
                    **s.telemetry_dict(executed=executed),
                }
                for st, s in enumerate(self.comm_meta.kv_stages)
            ],
        )

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

    def calc_attn(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        return_max_logits: bool = False,
    ):
        return dist_attn_func(q, k, v, self.runtime, return_max_logits)

    @property
    def mesh(self):
        """The :class:`~.parallel._mesh.ProcessMesh` the key was planned
        on: the key's own, or, for a key built from a bare ``cp_group``
        (or none, at cp 1), a one-axis ``"cp"`` mesh over that group's
        ranks whose line is the group itself (made once, no new group)."""
        if self.key.mesh is not None:
            return self.key.mesh
        if self._mesh is None:
            from .parallel._mesh import ProcessMesh

            self._mesh = ProcessMesh.of_group(self.key.cp_group)
        return self._mesh

    def roll(self, x: torch.Tensor, shifts: int) -> torch.Tensor:
        """This rank's rows of the global sequence rolled by ``shifts``
        (:func:`~.functional.roll.roll_func`)."""
        from .functional.roll import roll_func

        return roll_func(x, self.dispatch_meta_q, shifts, self.key.cp_rank, self.key.cp_group)

    def get_position_ids(self) -> torch.Tensor:
        """The global position of each of this rank's dispatched rows."""
        return self._indices("qo")[0]

    def get_xattn_args(
        self, ref_xattn_q_ranges: AttnRanges, ref_xattn_k_ranges: AttnRanges, attn_mask_type=None
    ) -> list:
        """Cross-attention args for the dispatched q layout (ref :269-357):
        each global (q_range, k_range) pair of a FULL cross-attention over a
        new, undistributed kv tensor, in every rank's local dispatched q
        coordinates. Host-only: the list holds one :class:`AttnArg` per
        rank (this rank's is ``[self.key.cp_rank]``), as in the JAX
        package."""
        from .kernels.mask_utils import BAND_INF
        from .meta.collection.calc_meta import AttnArg

        if len(ref_xattn_q_ranges) != len(ref_xattn_k_ranges):
            raise ValueError(
                f"q/k range count mismatch: {len(ref_xattn_q_ranges)} vs "
                f"{len(ref_xattn_k_ranges)}"
            )
        if attn_mask_type is not None:
            types = (
                attn_mask_type if isinstance(attn_mask_type, list)
                else [attn_mask_type] * len(ref_xattn_q_ranges)
            )
            if any(AttnMaskType.normalize(t) != AttnMaskType.FULL for t in types):
                raise ValueError("only FULL cross-attention masks are supported (ref :293)")
        meta = self.dispatch_meta_q
        sk = ref_xattn_k_ranges.end
        args = []
        for rank in range(meta.cp_size):
            own = meta.host_ranges_per_rank[rank]
            slices = []
            for qr, kr in zip(ref_xattn_q_ranges, ref_xattn_k_ranges):
                for piece in AttnRanges([qr]).find_overlap_ranges(own):
                    q_loc = own.make_range_local(piece)
                    slices.append((q_loc.start, q_loc.end, kr.start, kr.end, -BAND_INF, BAND_INF))
            args.append(AttnArg.from_slices(slices, meta.shard_seqlen, sk))
        return args


class DistAttnRuntimeDict:
    """LRU cache of managers by key. Its hit/miss/eviction counts are plain
    ints, always kept (no clock, no file), mirrored into telemetry when it
    is on."""

    def __init__(self, maxsize: int | None = None) -> None:
        self.maxsize = maxsize or env_general.runtime_dict_size()
        self._d: OrderedDict[DistAttnRuntimeKey, DistAttnRuntimeMgr] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get_or_create(self, key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr:
        if key in self._d:
            self._d.move_to_end(key)
            self._hits += 1
            telemetry.inc("runtime_cache.hit")
            return self._d[key]
        self._misses += 1
        telemetry.inc("runtime_cache.miss")
        with telemetry.stage_timer("runtime_mgr_init"):
            # a build that raised never leaves an entry behind: the next
            # get_or_create rebuilds
            mgr = self._build_mgr(key)
        self._d[key] = mgr
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self._evictions += 1
            telemetry.inc("runtime_cache.evict")
        if telemetry.enabled():
            telemetry.record_event("runtime_cache", **self.get_stats())
        return mgr

    def _build_mgr(self, key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr:
        """One manager build, with the resilience layer's bounded retry
        (MAGI_ATTENTION_FALLBACK=1: one extra attempt, degradation chain
        3). A retry re-solves on the host only; every rank of a group
        builds the same plan, so at cp > 1 they retry alike."""
        from .resilience.fallback import PLAN_BUILD_RETRIES, record_resilience_event

        retries = PLAN_BUILD_RETRIES if env_resilience.is_fallback_enable() else 0
        for attempt in range(retries + 1):
            try:
                mgr = DistAttnRuntimeMgr(key)
            except Exception as e:
                if attempt >= retries:
                    raise
                record_resilience_event(
                    "retry", "plan_build", attempt=attempt + 1, error=type(e).__name__,
                )
                continue
            if attempt:
                record_resilience_event("recovered", "plan_build", attempt=attempt)
            return mgr

    def get(self, key: DistAttnRuntimeKey) -> DistAttnRuntimeMgr | None:
        return self._d.get(key)

    def get_stats(self) -> dict[str, int]:
        """Cache behavior counters (the cache is keyed on mask + group +
        config + env snapshot, so a surprise miss rate usually means env
        flags are churning between steps)."""
        return {
            "hits": self._hits,
            "misses": self._misses,
            "evictions": self._evictions,
            "size": len(self._d),
            "maxsize": self.maxsize,
        }

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)
