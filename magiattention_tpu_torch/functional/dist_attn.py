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
- the backward of the parts is :class:`_MultiFFA`'s, and the GroupReduce
  of the remote parts' dk/dv is the backward of the GroupCast
  (:mod:`..comm.primitives`).

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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..comm.hier import HierCastPlan, make_hier_group_cast_plan
from ..comm.primitives import CastPlan, group_cast_all
from ..env import comm as env_comm
from ..kernels import registry as kernel_registry
from ..kernels.ffa import (
    FFAParams, apply_bwd_overrides, default_blocks, ffa_bwd, ffa_delta, ffa_fwd_dispatch,
)
from ..kernels.ffa_plan import FFAPlan, get_ffa_plan
from ..kernels.head_dims import kernel_head_dim
from ..kernels.tile_policy import auto_tile_enabled, choose_blocks_per_pass_multi
from ..kernels.sdpa import dense_max_logits, sdpa_attn
from ..kernels.sdpa_online import sdpa_online_attn
from ..meta.collection.calc_meta import AttnArg, CalcMeta
from ..meta.collection.comm_meta import CommMeta
from .utils import lse_weighted_reduce


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
        outs, lses, mls = [], [], []
        for i in range(n):
            if waits[i] is not None:
                waits[i]()
            out_i, lse_i, *ml_i = ffa_fwd_dispatch(
                q, kvs[i].to(q.dtype), kvs[n + i].to(q.dtype), plans[i], params[i],
                return_max_logits,
            )
            outs.append(out_i)
            lses.append(lse_i)
            mls += ml_i
        if n == 1:
            out, lse = outs[0], lses[0]
        else:
            out, lse = lse_weighted_reduce(torch.stack(outs), torch.stack(lses))
        ctx.save_for_backward(q, out, lse, *kvs)
        ctx.plans, ctx.params = plans, params
        if not return_max_logits:
            ctx.mark_non_differentiable(lse)
            return out, lse
        ml = torch.stack(mls).amax(dim=0)
        ctx.mark_non_differentiable(lse, ml)
        return out, lse, ml

    @staticmethod
    def backward(ctx, do, *_aux):
        q, out, lse, *kvs = ctx.saved_tensors
        n = len(ctx.plans)
        delta = ffa_delta(out, do)
        dq, dks, dvs = None, [], []
        for i in range(n):
            k, v = kvs[i], kvs[n + i]
            dq_i, dk_i, dv_i = ffa_bwd(
                q, k.to(q.dtype), v.to(q.dtype), do, lse, delta,
                ctx.plans[i], ctx.params[i],
            )
            dq = dq_i if dq is None else dq.add_(dq_i)
            dks.append(dk_i.to(k.dtype))
            dvs.append(dv_i.to(v.dtype))
        return (dq.to(q.dtype), None, None, None, None, *dks, *dvs)


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
    package's ``DeferredTilePolicy``).

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
    plan's params."""

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
        (blk_q, blk_k), pol_dq, pol_dkv = choose_blocks_per_pass_multi(
            geoms, sq, sk, d, dv, itemsize,
        )
        self._policy_bwd = (pol_dq, pol_dkv)
        self._build_plans(blk_q, blk_k)
        self._plan_sig = sig

    def _bwd_params(self, params: FFAParams, d: int, dv: int, itemsize: int) -> FFAParams:
        """``params`` with the backward's per-pass tiles (env, else the
        policy's), gated by what is compiled at the kernels' width."""
        return apply_bwd_overrides(params, kernel_head_dim(d, dv), itemsize, *self._policy_bwd)


class DistAttnRuntime(DeferredTilePolicy):
    """One rank's runtime for one (mask, cp group, config): its FFA plans
    and GroupCast plans, built once from the solver's CommMeta and
    CalcMeta.

    ``hier`` is ``((n_outer, n_inner), (outer_group, inner_group))`` for
    two-level comm: each stage takes the solver's ``hier_plan``, re-planned
    from its transfer table where the solver planned another shape (or
    none). ``tp`` is ``(head_axis, tp_group, tp_size)`` under tensor
    parallelism over heads."""

    def __init__(
        self,
        comm_meta: CommMeta,
        calc_meta: CalcMeta,
        cp_rank: int,
        cp_group=None,
        softmax_scale: float | None = None,
        softcap: float = 0.0,
        use_overlap: bool | None = None,
        backend: str = "ffa",
        hier=None,
        tp=None,
    ) -> None:
        if backend not in ("ffa", "sdpa", "sdpa_online"):
            raise ValueError(f"unknown kernel backend {backend!r} (ffa | sdpa | sdpa_online)")
        self.backend = backend
        self.comm_meta, self.calc_meta = comm_meta, calc_meta
        self.cp_size = len(calc_meta.host_args)
        self.cp_rank, self.cp_group = cp_rank, cp_group
        self.softmax_scale, self.softcap = softmax_scale, softcap
        self.num_stages = len(comm_meta.kv_stages)
        # overlap iff the solver produced more than one stage, unless off;
        # the dense backends replay the merged slices
        self.use_overlap = (
            self.num_stages > 1 if use_overlap is None else use_overlap
        ) and backend == "ffa"
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
        self._heads_checked = True
        counts = torch.tensor([hq, hk], dtype=torch.int64, device=device)
        dist.all_reduce(counts, group=self.tp_group)
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

    def _build_plans(self, block_q: int | None = None, block_k: int | None = None) -> None:
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

    def calc_attn(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        return_max_logits: bool = False,
    ):
        """Attention of this rank's dispatched rows.

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
        self._check_heads(q.shape[1], k.shape[1], q.device)
        k_parts, v_parts, waits = [k], [v], []
        if self.cast_plans:  # cp > 1: the remote kv of every stage
            d = k.shape[-1]
            hp = env_comm.is_bwd_high_precision_reduce_enable()
            kv_parts, waits = group_cast_all(
                torch.cat([k, v.to(k.dtype)], dim=-1), self.cast_plans, self.cast_group, hp
            )
            k_parts = [p[..., :d] for p in kv_parts]
            v_parts = [p[..., d:] for p in kv_parts]
        if not self.use_overlap and len(k_parts) > 1:
            for wait in waits:
                wait()
            k_parts, v_parts = [torch.cat(k_parts)], [torch.cat(v_parts)]
            waits = []
        if self.backend != "ffa":
            arg = self.calc_meta.merged_args[self.cp_rank]
            kv = (k_parts[0].to(q.dtype), v_parts[0].to(q.dtype))
            kw = dict(
                softmax_scale=self.softmax_scale, softcap=self.softcap,
                d_lo=arg.d_lo, d_hi=arg.d_hi,
            )
            dense = sdpa_attn if self.backend == "sdpa" else sdpa_online_attn
            out, lse = dense(q, *kv, arg.q_ranges, arg.k_ranges, **kw)
            res = (out, lse.detach())  # lse carries no gradient, as on ffa
            if return_max_logits:
                res += (dense_max_logits(q, kv[0], arg.q_ranges, arg.k_ranges, **kw).detach(),)
        else:
            params = self._params(q.shape[-1], q.element_size(), v.shape[-1])
            res = multi_ffa(
                q, k_parts, v_parts, self.plans, params, [None, *waits], return_max_logits,
            )
        if return_max_logits and self.cp_size > 1:
            dist.all_reduce(res[2], op=dist.ReduceOp.MAX, group=self.cp_group)
        return res
