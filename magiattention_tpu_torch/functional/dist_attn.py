"""The CP runtime, per rank.

The port's counterpart of ``magiattention_tpu/functional/dist_attn.py``
(``_multi_ffa``, ``DistAttnRuntime``). The JAX runtime is one SPMD
program over the mesh: per-rank plans padded to one shape, GroupReduce as
XLA's transpose of GroupCast, and the stage overlap left to XLA's
scheduler. Here every process runs its own rank and builds its own plans
(no padding), and both are written out:

- the forward issues every stage's GroupCast up front (asynchronous
  ``all_to_all_single``; on CUDA, NCCL's own stream), runs the host part,
  then each stage's part after waiting for that stage's transfer only;
- the backward (:class:`_StagedAttn`) runs the remote parts' backward
  first, issuing each stage's GroupReduce of dk/dv (the reverse
  transfer) the moment that stage's partials exist, then the host part's
  under the last one, and finishes the reduces in stage order: JAX gets
  this overlap from XLA's scheduler, which runs each stage's collective
  beside the other stages' compute.

With overlap off, or a plan of one stage, the runtime waits for every
stage and runs one FFA over the merged buffer ``[kv shard | stage 0 |
...]`` instead (the JAX package's no-overlap path). K and V travel in one
transfer (v in k's dtype), as the JAX runtime fuses them.

``backend="sdpa"`` (MAGI_ATTENTION_KERNEL_BACKEND=sdpa) replays the merged
slices with the dense ``sdpa_attn`` instead of FFA, differentiated by
autograd: the plain path the kernels are checked against, on the card
too; ``"sdpa_online"`` replays them with the blockwise online-softmax
``sdpa_online_attn`` (a float32 test backend). With ``return_max_logits``
the per-head max logit is the max over the parts, then
``all_reduce(MAX)`` over the cp group (the JAX package's
``reduce_max_logits``). The qo-comm runtime is :mod:`.dynamic_dist_attn`.
:func:`dist_attn_func` is the functional entry over a runtime.

Two-level comm (``hier``: the cp group laid out as (n_outer, n_inner)
ranks, outer-major, under MAGI_ATTENTION_HIERARCHICAL_COMM=1) runs each
stage's GroupCast in two phases over the rank's outer and inner lines
(:mod:`..comm.hier`); the buffers are the flat cast's, bit for bit.
Tensor parallelism over heads (``tp_group``): each rank holds its own
``hq / tp`` and ``hk / tp`` heads, and attention runs on them; only
max-logits crosses the cp group. Tiles: under
MAGI_ATTENTION_FFA_AUTO_TILE=1 (no env tile pin) :class:`DeferredTilePolicy`
picks per-pass tiles over every rank's slice set at the first call, when
the head dims and dtype are known, and builds the plans then; the backward's
per-pass tiles (env, else the policy's) ride on each plan's
:class:`~..kernels.ffa.FFAParams`.

``calc_attn`` is JAX's entry: with a resilience flag set it runs through
``resilience/fallback.py:run_calc_attn`` (the tile ladder, the reference
rung, the guards, the watchdog), with MAGI_ATTENTION_TELEMETRY=1 it is
timed and recorded (``attn_step``: JAX's fields, plus ``device_ms`` from a
CUDA event pair on a card), and with neither it is one call of
``_calc_attn_impl``, the step itself. Under MAGI_ATTENTION_PROFILE_MODE=1
the parts carry JAX's profiler scopes (``ffa_fwd_stage{i}``,
``lse_merge``, ``ffa_bwd_delta``, ``ffa_bwd``, ``group_cast_stage{i}``,
``group_reduce_<lowering>``).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..comm.hier import HierCastPlan, make_hier_group_cast_plan
from ..comm.primitives import CastPlan, exchanges_issued, group_cast_all, issue_placeholders
from ..env import comm as env_comm
from ..env import general as env_general
from ..env import resilience as env_resilience
from ..kernels import registry as kernel_registry
from ..kernels.ffa import (
    FFAParams, apply_bwd_overrides, bwd_mode_key, bwd_plans, bwd_shape, default_blocks, ffa_bwd,
    ffa_bwd_mode, ffa_delta, ffa_fwd_dispatch, _use_gqa_pack_dq,
)
from ..kernels.ffa_plan import FFAPlan, get_ffa_plan
from ..kernels.head_dims import kernel_head_dim
from ..kernels.tile_policy import auto_tile_enabled, choose_blocks_per_pass_multi
from ..kernels.sdpa import dense_max_logits, sdpa_attn
from ..kernels.sdpa_online import sdpa_online_attn
from ..kernels.tile_policy import bwd_mode_ms
from ..meta.collection.calc_meta import AttnArg, CalcMeta
from ..meta.collection.comm_meta import CommMeta
from ..utils.profiling import instrument_scope, profile_scope
from .utils import lse_weighted_reduce


def _parts_fwd(q, ks, vs, plans, params, waits, return_max_logits):
    """(out, lse, max_logits or None) of q against the kv parts: part i
    after ``waits[i]`` (when not None), in q's dtype, lse-merged."""
    outs, lses, mls = [], [], []
    for i, (k, v) in enumerate(zip(ks, vs)):
        if waits[i] is not None:
            waits[i]()
        with profile_scope(f"ffa_fwd_stage{i}"):
            out_i, lse_i, *ml_i = ffa_fwd_dispatch(
                q, k.to(q.dtype), v.to(q.dtype), plans[i], params[i], return_max_logits,
            )
        outs.append(out_i)
        lses.append(lse_i)
        mls += ml_i
    if len(outs) == 1:
        out, lse = outs[0], lses[0]
    else:
        with profile_scope("lse_merge"):
            out, lse = lse_weighted_reduce(torch.stack(outs), torch.stack(lses))
    return out, lse, (torch.stack(mls).amax(dim=0) if return_max_logits else None)


def _fwd_outputs(ctx, out, lse, ml):
    """The forward's outputs, lse and max-logits marked auxiliary."""
    if ml is None:
        ctx.mark_non_differentiable(lse)
        return out, lse
    ctx.mark_non_differentiable(lse, ml)
    return out, lse, ml


class _MultiFFA(torch.autograd.Function):
    """Merged multi-part FFA: part i attends q against (k_i, v_i) with its
    own plan; the partials are lse-merged into one (out, lse).

    ``waits[i]``, when not None, is called before part i is read (its
    receive buffer may still be in flight). The backward is the
    distributed-flash identity: every part's backward runs against the
    MERGED lse and one shared delta = rowsum(dO * out), which makes each
    part's dq, dk, dv exact with no gradient through the merge weights;
    dq is summed over the parts, dk and dv are returned per part. Parts
    are computed in q's dtype (a float32 part comes from the high-precision
    reduce) and their gradients returned in the parts' dtypes. With
    ``return_max_logits`` a third output is the per-head max logit, the
    elementwise max over the parts. lse and max_logits are auxiliary
    outputs: their cotangents are ignored."""

    @staticmethod
    def forward(ctx, q, plans, params, waits, return_max_logits, *kvs):
        n = len(plans)
        out, lse, ml = _parts_fwd(q, kvs[:n], kvs[n:], plans, params, waits, return_max_logits)
        ctx.save_for_backward(q, out, lse, *kvs)
        ctx.plans, ctx.params = plans, params
        return _fwd_outputs(ctx, out, lse, ml)

    @staticmethod
    def backward(ctx, do, *_aux):
        q, out, lse, *kvs = ctx.saved_tensors
        n = len(ctx.plans)
        with profile_scope("ffa_bwd_delta"):
            delta = ffa_delta(out, do)
        dq, dks, dvs = None, [], []
        for i in range(n):
            k, v = kvs[i], kvs[n + i]
            with profile_scope("ffa_bwd"):
                dq_i, dk_i, dv_i = ffa_bwd(
                    q, k.to(q.dtype), v.to(q.dtype), do, lse, delta,
                    ctx.plans[i], ctx.params[i],
                )
            dq = dq_i if dq is None else dq.add_(dq_i)
            dks.append(dk_i.to(k.dtype))
            dvs.append(dv_i.to(v.dtype))
        return (dq.to(q.dtype), None, None, None, None, *dks, *dvs)


class _StagedAttn(torch.autograd.Function):
    """The overlapped path whole: every stage's GroupCast of ``kv`` (this
    rank's ``[k | v]`` rows), the multi-part FFA over ``[kv | stage 0 |
    ...]`` (:class:`_MultiFFA`'s forward), and a backward that overlaps
    each stage's GroupReduce with the next part's compute.

    The backward runs the remote parts first, in stage order, and issues
    stage i's GroupReduce (``reduce_start``) the moment its dk/dv exist;
    the host part runs last, under the last reduce; then the reduces are
    finished in stage order. The arithmetic is that of :class:`_MultiFFA`
    under :class:`~..comm.primitives._GroupCast`, in another time order
    only: dq summed over the parts in part order, the partials sent in
    kv's dtype (float32 under ``hp``, where the local part joins the
    float32 sum first), summed into the shard stage by stage. So the
    gradients are those of that pair to the bit (deterministic kernels
    assumed)."""

    @staticmethod
    def forward(ctx, q, kv, d, cast_plans, group, hp, plans, params, return_max_logits, issued):
        parts, waits = [kv.float() if hp else kv], [None]
        for i, plan in enumerate(cast_plans):
            with profile_scope(f"group_cast_stage{i}"):
                buf, wait = plan.cast_start(kv, group, parts[0].dtype)
            parts.append(buf)
            waits.append(wait)
        issued()
        out, lse, ml = _parts_fwd(
            q, [p[..., :d] for p in parts], [p[..., d:] for p in parts], plans, params, waits,
            return_max_logits,
        )
        ctx.save_for_backward(q, out, lse, *parts)
        ctx.d, ctx.cast_plans, ctx.group, ctx.hp = d, cast_plans, group, hp
        ctx.plans, ctx.params, ctx.kv_dtype = plans, params, kv.dtype
        return _fwd_outputs(ctx, out, lse, ml)

    @staticmethod
    def backward(ctx, do, *_aux):
        q, out, lse, *parts = ctx.saved_tensors
        d, group = ctx.d, ctx.group
        with profile_scope("ffa_bwd_delta"):
            delta = ffa_delta(out, do)

        def part_bwd(i):
            p = parts[i]
            with profile_scope("ffa_bwd"):
                dq_i, dk_i, dv_i = ffa_bwd(
                    q, p[..., :d].to(q.dtype), p[..., d:].to(q.dtype), do, lse, delta,
                    ctx.plans[i], ctx.params[i],
                )
            return dq_i, torch.cat([dk_i.to(p.dtype), dv_i.to(p.dtype)], dim=-1)

        wire = torch.float32 if ctx.hp else ctx.kv_dtype
        dqs, pending = [None] * len(parts), []
        for i, plan in enumerate(ctx.cast_plans, start=1):
            dqs[i], g = part_bwd(i)
            with profile_scope(f"group_reduce_{plan.lowering}"):
                pending.append((plan, plan.reduce_start(g, group, wire)))
        dqs[0], local = part_bwd(0)
        dq = dqs[0]
        for dq_i in dqs[1:]:
            dq = dq.add_(dq_i)
        total = local if ctx.hp else None
        for plan, handle in pending:
            with profile_scope(f"group_reduce_{plan.lowering}"):
                total = plan.reduce_finish(total, handle, group, local.shape[0])
        dkv = total.to(ctx.kv_dtype)
        if not ctx.hp:
            dkv = local + dkv
        return dq.to(q.dtype), dkv, None, None, None, None, None, None, None, None


def multi_ffa(q, ks, vs, plans, params, waits=None, return_max_logits=False):
    """(out, lse[, max_logits]) of q against the kv parts ``ks``/``vs``
    (see :class:`_MultiFFA`), differentiable in q and every part."""
    waits = waits or [None] * len(plans)
    return _MultiFFA.apply(
        q, tuple(plans), tuple(params), tuple(waits), return_max_logits, *ks, *vs
    )


def _plan(arg: AttnArg, sq: int, sk: int, block_q: int | None = None,
          block_k: int | None = None) -> FFAPlan:
    bq, bk = default_blocks(sq, sk, block_q, block_k)
    return get_ffa_plan(arg.q_ranges, arg.k_ranges, arg.d_lo, arg.d_hi, sq, sk, bq, bk)


class DeferredTilePolicy:
    """Deferred auto-tile state shared by the CP runtimes (the JAX
    package's ``DeferredTilePolicy``), with the observatory's signatures
    and the backend the runtime runs.

    The policy scores its shared-memory guard (the compiled set) at the
    real head dims and dtype, known only at the first ``calc_attn``, so
    under MAGI_ATTENTION_FFA_AUTO_TILE=1 (no tile argument, no env tile
    pin) plan building waits for it: :meth:`_ensure_auto_plans` picks
    per-pass tiles over every rank's slice set
    (:func:`~..kernels.tile_policy.choose_blocks_per_pass_multi`; each
    rank runs its own plans, and the pick is the one for the slowest
    rank) and rebuilds when the signature changes. Subclasses provide
    ``_build_plans(block_q, block_k)`` and ``_tile_geoms() -> (geoms, sq,
    sk)``; :meth:`_bwd_params` adds the backward's per-pass tiles to a
    plan's params.

    :attr:`backend` is the constructor's backend when one was given, else
    the registry's ``calc_attn`` decision under :meth:`_policy_key` (a pin,
    the memo, the store's policy or measured best, or 'ffa') at
    construction; a resilience override (``_backend_override``, sticky
    degradation to the reference path) wins over it."""

    def _init_tile_policy(self, block_q: int | None = None, block_k: int | None = None) -> None:
        self._plan_sig = None
        # the policy's per-pass picks (dq, dk/dv); env settings win over them
        self._policy_bwd: tuple = (None, None)
        self._auto_tile_pending = (
            block_q is None and block_k is None
            and not kernel_registry.tiles_pinned() and auto_tile_enabled()
        )
        if not self._auto_tile_pending:
            self._build_plans(block_q, block_k)

    def _ensure_auto_plans(self, d: int, dv: int, itemsize: int) -> None:
        """Choose tiles with the real data signature; rebuild on change."""
        if not self._auto_tile_pending:
            return
        sig = (d, dv, itemsize)
        if self._plan_sig == sig:
            return
        geoms, sq, sk = self._tile_geoms()
        try:
            (blk_q, blk_k), pol_dq, pol_dkv = choose_blocks_per_pass_multi(
                geoms, sq, sk, d, dv, itemsize,
            )
        except Exception as e:
            # a failed shared-memory scoring pass must not kill the step:
            # the default tiles are compiled for every kernel and dtype
            if not env_resilience.is_fallback_enable():
                raise
            from ..resilience.fallback import record_resilience_event

            record_resilience_event(
                "recovered", "vmem_check",
                action_detail="default_blocks", error=type(e).__name__,
            )
            (blk_q, blk_k), pol_dq, pol_dkv = (None, None), None, None
        self._policy_bwd = (pol_dq, pol_dkv)
        self._build_plans(blk_q, blk_k)
        self._plan_sig = sig

    # -- the step watchdog's agreement at cp > 1 (resilience/watchdog.py) --

    # True once this step's last forward collective is issued on this rank:
    # a failure after it leaves no peer waiting inside a collective
    _fwd_comm_done = True
    _ml_reduce_pending = False
    _fwd_mark = 0

    def _fwd_comm_begin(self, return_max_logits: bool) -> None:
        """A step's forward starts: at cp > 1 its collectives are still to
        be issued; the last is the casts, or the max-logits all-reduce."""
        self._ml_reduce_pending = return_max_logits and self.cp_size > 1
        self._fwd_comm_done = self.cp_size == 1
        self._fwd_mark = exchanges_issued()

    def _fwd_casts_issued(self) -> None:
        """Every forward cast of the step is issued on this rank."""
        self._fwd_comm_done = not self._ml_reduce_pending

    def _fwd_exchanges(self, q, k, v) -> list[tuple]:
        """The step's forward exchanges in issue order, each ``(exchange,
        row shape, wire dtype)`` (:func:`~..comm.primitives.issue_placeholders`)."""
        raise NotImplementedError

    def _fwd_pending_checks(self, q, k) -> None:
        """Issue a first call's collective checks not yet issued (none here)."""

    def complete_fwd_comm(self, q, k, v) -> None:
        """After a failed attempt on this rank: issue every forward
        collective of the step it did not reach, in the step's order, with
        placeholder buffers of the plan's sizes in the step's wire dtypes
        (the exchanges past :func:`~..comm.primitives.exchanges_issued`'s
        mark, then the max-logits all-reduce), so that no peer is left
        waiting inside one. The sends read ``q``, ``k`` or ``v``'s bytes
        where they suffice. The step watchdog then agrees on the failure
        (ROADMAP C9)."""
        if self._fwd_comm_done:
            return
        self._fwd_pending_checks(q, k)
        done = exchanges_issued() - self._fwd_mark
        issue_placeholders(self._fwd_exchanges(q, k, v)[done:], q.device, (k, v, q))
        if self._ml_reduce_pending:
            ml = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
            dist.all_reduce(ml, op=dist.ReduceOp.MAX, group=self.cp_group)
        self._fwd_comm_done = True

    def agree_step_failure(self, failed: bool, device: torch.device) -> bool:
        """Whether the step failed on any rank of the cp group: one
        ``all_reduce(MAX)`` of a one-element flag (on the step's card under
        NCCL, on the CPU otherwise)."""
        nccl = dist.get_backend(self.cp_group) == "nccl"
        flag = torch.tensor([int(failed)], dtype=torch.int32, device=device if nccl else "cpu")
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.cp_group)
        return bool(flag.item())

    def _bwd_params(self, params: FFAParams, d: int, dv: int, itemsize: int) -> FFAParams:
        """``params`` with the backward's per-pass tiles (env, else the
        policy's), gated by what is compiled at the kernels' width."""
        return apply_bwd_overrides(params, kernel_head_dim(d, dv), itemsize, *self._policy_bwd)

    # -- observatory signatures (telemetry/store.py join keys) ----------

    def _policy_key(self) -> dict:
        """The calc_attn registry/measurement key: mask-class signature x
        mesh x env snapshot, keyed exactly like the store's calc_attn
        measurement rows, so the registry's measured-history lookup joins
        against this runtime's own recorded steps."""
        return {
            "mask_sig": self._mask_signature(),
            "mesh_sig": self._mesh_signature(),
            "env_sig": self._env_signature(),
        }

    def _mask_signature(self) -> str:
        """Digest of the mask-class geometry (every rank's slice arrays and
        the buffer lengths, the JAX package's digest); plan-stable, so
        computed once per runtime."""
        sig = self._tel_mask_sig
        if sig is None:
            geoms, sq, sk = self._tile_geoms()
            h = hashlib.md5(repr((sq, sk, len(geoms))).encode())
            for g in geoms:
                for a in g:
                    h.update(np.ascontiguousarray(a).tobytes())
            sig = h.hexdigest()[:16]
            self._tel_mask_sig = sig
        return sig

    def _mesh_signature(self) -> str:
        """repr((mesh axes and sizes, cp_axis, head_axis)), the JAX
        package's form; the manager sets ``mesh_sig`` from the key's mesh,
        a bare runtime is a one-axis "cp" mesh."""
        if self.mesh_sig is not None:
            return self.mesh_sig
        return repr(((("cp", self.cp_size),), "cp", None))

    def _env_signature(self) -> str:
        """Digest of the behavior-affecting env snapshot (memoized per
        snapshot value — flips mid-life re-key the policy lookups)."""
        snap = env_general.snapshot_env()
        cached = self._tel_env_sig
        if cached is not None and cached[0] == snap:
            return cached[1]
        sig = hashlib.md5(repr(snap).encode()).hexdigest()[:16]
        self._tel_env_sig = (snap, sig)
        return sig

    def _resolve_backend(self, backend: str | None) -> None:
        """Fix the runtime's backend at construction: ``backend``, or (None)
        the registry's ``calc_attn`` decision under :meth:`_policy_key`."""
        self._backend_override = None
        self._tel_mask_sig = self._tel_env_sig = None
        self._tel_bwd_cost: dict = {}
        if backend is None:
            backend = kernel_registry.calc_attn_backend(self._policy_key())
        self._backend = backend

    @property
    def backend(self) -> str:
        if self._backend_override is not None:
            return self._backend_override
        return self._backend

    def _guarded_calc_attn(self, q, k, v, return_max_logits: bool):
        """``calc_attn``'s entry for both runtimes: the plain
        ``_calc_attn_impl``, or, with a resilience flag set, the guarded
        path (``resilience/fallback.py:run_calc_attn``); with telemetry on,
        timed (host wall and, on a card, a CUDA event pair around the
        forward and one around its backward, resolved later) and recorded
        as an ``attn_step``. With every flag off this is one call of
        ``_calc_attn_impl``: no clock, no file, no CUDA event."""
        impl = self._calc_attn_impl
        if env_resilience.is_resilience_active():
            from ..resilience.fallback import run_calc_attn

            def impl(q, k, v, return_max_logits):
                return run_calc_attn(self, q, k, v, return_max_logits)

        if not telemetry.enabled():
            return impl(q, k, v, return_max_logits)
        timer = telemetry.device_timer_start(q.device)
        bwd = telemetry.backward_timer(q, k, v)
        if bwd is not None:
            q, k, v = bwd.mark_end(q, k, v)
        with telemetry.stage_timer("calc_attn"):
            result = impl(q, k, v, return_max_logits)
        telemetry.device_timer_stop(timer)
        if bwd is not None:
            result = (bwd.mark_start(result[0]), *result[1:])
        wall_ms = telemetry.get_collector().gauges.get("time.calc_attn.last_ms")
        telemetry.record_timed_event(
            "attn_step", timer, bwd,
            xprof_scope=f"{type(self).__name__}.calc_attn",
            wall_ms=wall_ms,
            **self._step_payload(q, k, v),
        )
        return result

    def _step_payload(self, q, k, v) -> dict:
        """:meth:`_attn_step_payload`, built once per plan build and step
        signature (backend, env, shapes, dtypes): every field of it is
        fixed while the plans are, so a step only stamps its times."""
        sig = (self.backend, self._env_signature(), q.shape, k.shape, v.shape,
               q.dtype, k.dtype, v.dtype)
        cached = getattr(self, "_tel_payload", None)
        if cached is None or cached[0] != sig:
            cached = self._tel_payload = (sig, self._attn_step_payload(q, k, v))
        return cached[1]

    def _bwd_mode_fields(self, plan: FFAPlan, params: FFAParams, q, k, v) -> dict:
        """The backward mode the dispatch picks for a plan, its registry
        key and the cost model's modeled ms for that mode (the drift
        layer's ``bwd_cost`` observation). The modeled ms is kept per
        (key, mode): the model's CTA-scheduling simulation takes ~7 ms of
        host time at the train attention shape, and a plan's key does not
        change between steps."""
        d, dv, itemsize = q.shape[-1], v.shape[-1], q.element_size()
        hq, hk = q.shape[1], k.shape[1]
        mode = ffa_bwd_mode(plan, params, d, dv, itemsize, hq, hk)
        sq, sk = plan.num_q_tiles * plan.block_q, plan.num_k_tiles * plan.block_k
        plan_dq, plan_dkv = bwd_plans(plan, params, sq, sk)
        dq_heads = _use_gqa_pack_dq(hq // hk, d, dv, itemsize, plan_dq.block_q, plan_dq.block_k)
        key = bwd_mode_key(plan_dq, plan_dkv, hq, hk, d, dv, itemsize, dq_heads)
        costs = self._tel_bwd_cost
        if (key, mode) not in costs:
            shape = bwd_shape(plan_dq, hq, hk, d, dv, itemsize, plan_dkv)
            costs[(key, mode)] = bwd_mode_ms(shape, dq_heads)[mode]
        return dict(bwd_mode=mode, bwd_key=list(key), bwd_cost=costs[(key, mode)])


class DistAttnRuntime(DeferredTilePolicy):
    """One rank's runtime for one (mask, cp group, config): its FFA plans
    and GroupCast plans, built once from the solver's CommMeta and
    CalcMeta.

    ``hier`` is ``((n_outer, n_inner), (outer_group, inner_group))`` for
    two-level comm: each stage takes the solver's ``hier_plan``, re-planned
    from its transfer table where the solver planned another shape (or
    none). ``tp`` is ``(head_axis, tp_group, tp_size)`` under tensor
    parallelism over heads. ``backend`` None resolves through the
    registry (see :class:`DeferredTilePolicy`); ``mesh_sig`` is the
    observatory's mesh signature (the manager's, from the key's mesh)."""

    def __init__(
        self,
        comm_meta: CommMeta,
        calc_meta: CalcMeta,
        cp_rank: int,
        cp_group=None,
        softmax_scale: float | None = None,
        softcap: float = 0.0,
        use_overlap: bool | None = None,
        backend: str | None = "ffa",
        hier=None,
        tp=None,
        mesh_sig: str | None = None,
    ) -> None:
        if backend not in (None, "ffa", "sdpa", "sdpa_online"):
            raise ValueError(f"unknown kernel backend {backend!r} (ffa | sdpa | sdpa_online)")
        self.comm_meta, self.calc_meta = comm_meta, calc_meta
        self.cp_size = len(calc_meta.host_args)
        self.cp_rank, self.cp_group = cp_rank, cp_group
        self.softmax_scale, self.softcap = softmax_scale, softcap
        self.mesh_sig = mesh_sig
        self._resolve_backend(backend)
        self.num_stages = len(comm_meta.kv_stages)
        # overlap iff the solver produced more than one stage, unless off;
        # the dense backends replay the merged slices
        self.use_overlap = (
            self.num_stages > 1 if use_overlap is None else use_overlap
        ) and self.backend == "ffa"
        self.hier = hier is not None and comm_meta.kv_host_ranges is not None
        if self.hier:
            (n_outer, n_inner), self.cast_group = hier
            self.cast_plans = [
                HierCastPlan.from_plan(self._hier_plan(s, n_outer, n_inner), cp_rank)
                for s in comm_meta.kv_stages
            ]
        else:
            self.cast_group = cp_group
            self.cast_plans = [CastPlan.from_stage(s, cp_rank) for s in comm_meta.kv_stages]
        self.head_axis, self.tp_group, self.tp_size = tp if tp is not None else (None, None, 1)
        self._heads_checked = False
        # the overlapped path's backward issues each stage's GroupReduce
        # under the next part's compute (_StagedAttn); False runs the same
        # parts with every reduce after every part's backward (_MultiFFA
        # under _GroupCast), the order the staged one is tested against
        self.staged_backward = True
        self._init_tile_policy()

    def _hier_plan(self, stage, n_outer: int, n_inner: int):
        """The stage's two-level plan: the solver's, or (where it planned
        none or another shape) one built here from the transfer table, as
        the JAX runtime does."""
        plan = stage.hier_plan
        if plan is None or (plan.n_outer, plan.n_inner) != (n_outer, n_inner):
            plan = make_hier_group_cast_plan(
                stage.transfer_table, self.comm_meta.kv_host_ranges, n_outer, n_inner,
                alignment=128, r_max=stage.r_max, shard_len=self.calc_meta.kv_shard_len,
            )
        return plan

    def _check_heads(self, hq: int, hk: int, device) -> None:
        """Under TP, at the first call: the heads of the whole TP group
        (the sum of its ranks' local heads, one all-reduce) must split
        evenly over it, as the JAX runtime requires of the global heads.
        Every rank of the group checks at the same call, so none waits in
        the all-reduce while another has gone on."""
        if self.tp_size == 1 or self._heads_checked:
            return
        counts = torch.tensor([hq, hk], dtype=torch.int64, device=device)
        dist.all_reduce(counts, group=self.tp_group)
        self._heads_checked = True
        hq_all, hk_all = counts.tolist()
        tp = self.tp_size
        if hq_all % tp or hk_all % tp:
            raise ValueError(
                f"head_axis={self.head_axis!r} (size {tp}) must divide "
                f"both num_heads_q ({hq_all}) and num_heads_kv ({hk_all}) — "
                f"GQA kv heads shard over TP too"
            )
        if (hq * tp, hk * tp) != (hq_all, hk_all):
            raise ValueError(
                f"head_axis={self.head_axis!r} (size {tp}): this rank holds "
                f"{hq} q and {hk} kv heads of {hq_all} and {hk_all}; each "
                "rank takes num_heads / tp of both"
            )

    def _fwd_pending_checks(self, q, k) -> None:
        """The first call's head check under TP, with this rank's true
        head counts (its peers read them), where it was not reached."""
        self._check_heads(q.shape[1], k.shape[1], q.device)

    def _fwd_exchanges(self, q, k, v) -> list[tuple]:
        """Every stage's GroupCast of ``[k | v]`` rows, in k's dtype."""
        row = (k.shape[1], k.shape[-1] + v.shape[-1])
        return [(e, row, k.dtype) for p in self.cast_plans for e in p.exchanges(self.cast_group)]

    def _build_plans(self, block_q: int | None = None, block_k: int | None = None) -> None:
        with telemetry.stage_timer("build_plans"):
            self._build_plans_impl(block_q, block_k)

    def _build_plans_impl(self, block_q: int | None, block_k: int | None) -> None:
        km, r = self.calc_meta, self.cp_rank
        shard, kv_shard = km.shard_len, km.kv_shard_len
        if self.use_overlap:
            self.plans = [_plan(km.host_args[r], shard, kv_shard, block_q, block_k)] + [
                _plan(km.remote_args_per_stage[st][r], shard, rl, block_q, block_k)
                for st, rl in enumerate(km.recv_len_per_stage)
            ]
        else:
            total = kv_shard + sum(km.recv_len_per_stage)
            self.plans = [_plan(km.merged_args[r], shard, total, block_q, block_k)]
        # the tiles the ladder descends from (the first plan's: every part
        # takes the same request)
        self._bq, self._bk = self.plans[0].block_q, self.plans[0].block_k
        self._tel_plan_groups = self._tel_payload = None  # recomputed per plan build
        if telemetry.enabled():
            self._plan_group_stats()

    def _plan_group_stats(self) -> list[dict]:
        """Padded-grid work per executed kernel group, cached for the
        attn_step record (the JAX package's groups: "host" and "stage<i>"
        with overlap, else "merged"). Each rank runs its own plans (no
        padding to a common count), so the figures are this rank's, and
        the band this rank's merged slices'; at cp 1 they are the JAX
        package's."""
        names = ["host", *(f"stage{i}" for i in range(len(self.plans) - 1))] \
            if self.use_overlap else ["merged"]
        self._tel_plan_groups = [
            {
                "name": name, "block_q": p.block_q, "block_k": p.block_k,
                "num_work": p.num_work, "padded_elems": p.num_work * p.block_q * p.block_k,
            }
            for name, p in zip(names, self.plans)
        ]
        a = self.calc_meta.merged_args[self.cp_rank]
        self._tel_band_elems = telemetry.band_area(a.q_ranges, a.k_ranges, a.d_lo, a.d_hi)
        return self._tel_plan_groups

    def _attn_step_payload(self, q, k, v) -> dict:
        """One attention step's telemetry payload (the JAX package's
        fields; callers gate on ``telemetry.enabled()``). Shapes, heads and
        bytes are the step's whole (JAX's arrays are global): rows times
        cp, this rank's heads times tp. Comm rows were planned dtype-blind;
        bytes resolve here — k and v rows ride one fused transfer, so a
        wire row carries both."""
        sq, hq, dh = q.shape
        _, hk, dv = v.shape
        sq, hq, hk = sq * self.cp_size, hq * self.tp_size, hk * self.tp_size
        row_bytes = hk * dh * k.element_size() + hk * dv * v.element_size()
        executed = "hier" if self.hier else "a2a"
        stages = []
        payload_total = wire_total = 0
        for st, s in enumerate(self.comm_meta.kv_stages):
            d = s.telemetry_dict(executed=executed)
            d["stage"] = st
            d["xprof_scope"] = f"group_cast_stage{st}"
            d["payload_bytes"] = d["payload_rows"] * row_bytes
            d["wire_bytes"] = d["wire_rows"] * row_bytes
            d["padding_bytes"] = d["padding_rows"] * row_bytes
            payload_total += d["payload_bytes"]
            wire_total += d["wire_bytes"]
            stages.append(d)
        payload = {
            "backend": self.backend,
            # observatory join keys (telemetry/store.py _ATTN_KEY_FIELDS)
            "mask_sig": self._mask_signature(),
            "mesh_sig": self._mesh_signature(),
            "env_sig": self._env_signature(),
            "q_shape": [sq, hq, dh],
            "kv_shape": [v.shape[0] * self.cp_size, hk, dv],
            "cp_size": self.cp_size,
            "overlap_degree": self.num_stages,
            "use_overlap": self.use_overlap,
            "seqlen_q_shard": sq,
            "heads_q": hq, "head_dim": dh, "heads_kv": hk, "head_dim_v": dv,
            "dtype": str(q.dtype).removeprefix("torch."),
            "row_bytes": row_bytes,
            "stages": stages,
            "payload_bytes_total": payload_total,
            "wire_bytes_total": wire_total,
            "padding_bytes_total": wire_total - payload_total,
        }
        if self.backend == "ffa":
            if self._tel_plan_groups is None:
                self._plan_group_stats()  # telemetry enabled after build
            band = self._tel_band_elems
            padded = sum(g["padded_elems"] for g in self._tel_plan_groups)
            params = self._params(q.shape[-1], q.element_size(), v.shape[-1])
            payload.update(
                block_q=self._bq, block_k=self._bk,
                plan_groups=self._tel_plan_groups,
                band_elems=band,
                padded_elems=padded,
                # fwd FLOPs, FlashAttention-2 convention
                est_flops_fwd=4 * band * dh * hq,
                padded_flops_fwd=4 * padded * dh * hq,
                **self._bwd_mode_fields(self.plans[0], params[0], q, k, v),
            )
        return payload

    def _tile_geoms(self):
        """Every rank's merged slice set and the merged buffer's lengths:
        what the tile policy scores (its pick is the slowest rank's)."""
        km = self.calc_meta
        geoms = [(a.q_ranges, a.k_ranges, a.d_lo, a.d_hi) for a in km.merged_args]
        return geoms, km.shard_len, km.kv_shard_len + sum(km.recv_len_per_stage)

    def _params(self, d: int, itemsize: int = 2, dv: int | None = None) -> list[FFAParams]:
        """Each plan's params at head dims ``d`` (``dv``, default ``d``) and
        dtype ``itemsize``, with the backward's per-pass tiles."""
        dv = d if dv is None else dv
        self._ensure_auto_plans(d, dv, itemsize)
        scale = float(d) ** -0.5 if self.softmax_scale is None else self.softmax_scale
        return [
            self._bwd_params(FFAParams(
                num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles,
                block_q=p.block_q, block_k=p.block_k,
                softmax_scale=scale, softcap=float(self.softcap),
            ), d, dv, itemsize)
            for p in self.plans
        ]

    @instrument_scope(name="DistAttnRuntime.calc_attn")
    def calc_attn(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        return_max_logits: bool = False,
    ):
        """Attention of this rank's dispatched rows (through the guarded
        and recorded entry when a resilience or telemetry flag is set).

        Args:
            q: ``[shard, hq, d]``, k/v ``[kv_shard, hk, d|dv]``: this rank's
                dispatched rows (under TP, of its own heads).
            return_max_logits: also return the per-head max logit ``[hq]``
                float32, the max over this rank's parts all-reduced (MAX)
                over the cp group, so every rank holds the global one.

        Returns:
            (out ``[shard, hq, dv]`` in q's dtype, lse ``[shard, hq]``
            float32, natural log, -inf on rows no slice covers), plus
            max_logits when asked for.
        """
        if k.shape[:2] != v.shape[:2]:
            raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ in rows or heads")
        return self._guarded_calc_attn(q, k, v, return_max_logits)

    def _calc_attn_impl(self, q, k, v, return_max_logits: bool = False):
        """One step, unguarded (the resilience layer's retry unit)."""
        self._fwd_comm_begin(return_max_logits)
        self._check_heads(q.shape[1], k.shape[1], q.device)
        hp = env_comm.is_bwd_high_precision_reduce_enable()
        backend = self.backend
        overlap = self.use_overlap and backend == "ffa"
        if overlap and self.cast_plans and self.staged_backward:
            d = k.shape[-1]
            params = self._params(d, q.element_size(), v.shape[-1])
            res = _StagedAttn.apply(
                q, torch.cat([k, v.to(k.dtype)], dim=-1), d, tuple(self.cast_plans),
                self.cast_group, hp, tuple(self.plans), tuple(params), return_max_logits,
                self._fwd_casts_issued,
            )
            return self._reduce_max_logits(res, return_max_logits)
        k_parts, v_parts, waits = [k], [v], []
        if self.cast_plans:  # cp > 1: the remote kv of every stage
            d = k.shape[-1]
            kv_parts, waits = group_cast_all(
                torch.cat([k, v.to(k.dtype)], dim=-1), self.cast_plans, self.cast_group, hp
            )
            k_parts = [p[..., :d] for p in kv_parts]
            v_parts = [p[..., d:] for p in kv_parts]
        self._fwd_casts_issued()
        if not overlap and len(k_parts) > 1:
            for wait in waits:
                wait()
            k_parts, v_parts = [torch.cat(k_parts)], [torch.cat(v_parts)]
            waits = []
        if backend != "ffa":
            arg = self.calc_meta.merged_args[self.cp_rank]
            kv = (k_parts[0].to(q.dtype), v_parts[0].to(q.dtype))
            kw = dict(
                softmax_scale=self.softmax_scale, softcap=self.softcap,
                d_lo=arg.d_lo, d_hi=arg.d_hi,
            )
            dense = sdpa_attn if backend == "sdpa" else sdpa_online_attn
            out, lse = dense(q, *kv, arg.q_ranges, arg.k_ranges, **kw)
            res = (out, lse.detach())  # lse carries no gradient, as on ffa
            if return_max_logits:
                res += (dense_max_logits(q, kv[0], arg.q_ranges, arg.k_ranges, **kw).detach(),)
        else:
            params = self._params(q.shape[-1], q.element_size(), v.shape[-1])
            res = multi_ffa(
                q, k_parts, v_parts, self.plans, params, [None, *waits], return_max_logits,
            )
        return self._reduce_max_logits(res, return_max_logits)

    def _reduce_max_logits(self, res, return_max_logits: bool):
        """``res`` with its max-logits all-reduced (MAX) over the cp group."""
        if return_max_logits and self.cp_size > 1:
            dist.all_reduce(res[2], op=dist.ReduceOp.MAX, group=self.cp_group)
            self._fwd_comm_done = True
        return res


def dist_attn_func(q, k, v, runtime, return_max_logits: bool = False):
    """The functional entry (the JAX package's ``dist_attn_func``):
    (out, lse[, max_logits]) of this rank's dispatched rows through
    ``runtime`` (a :class:`DistAttnRuntime` or the qo-comm runtime).
    Under MAGI_ATTENTION_PRECISION=bf16, q, k and v are cast to bfloat16
    first."""
    if env_general.precision() == "bf16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    return runtime.calc_attn(q, k, v, return_max_logits=return_max_logits)
