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
too. With ``return_max_logits`` the per-head max logit is the max over
the parts, then ``all_reduce(MAX)`` over the cp group (the JAX package's
``reduce_max_logits``). The qo-comm runtime is
:mod:`.dynamic_dist_attn`. The ``sdpa_online`` backend, auto-tile, TP
head sharding and two-level comm are not ported yet (ROADMAP queues
A5-A6).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..comm.primitives import CastPlan, group_cast_all
from ..env import comm as env_comm
from ..kernels.ffa import FFAParams, default_blocks, ffa_bwd, ffa_delta, ffa_fwd_dispatch
from ..kernels.ffa_plan import FFAPlan, get_ffa_plan
from ..kernels.sdpa import dense_max_logits, sdpa_attn
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


def _plan(arg: AttnArg, sq: int, sk: int) -> FFAPlan:
    bq, bk = default_blocks(sq, sk)
    return get_ffa_plan(arg.q_ranges, arg.k_ranges, arg.d_lo, arg.d_hi, sq, sk, bq, bk)


class DistAttnRuntime:
    """One rank's runtime for one (mask, cp group, config): its FFA plans
    and GroupCast plans, built once from the solver's CommMeta and
    CalcMeta."""

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
    ) -> None:
        if backend not in ("ffa", "sdpa"):
            raise NotImplementedError(
                f"kernel backend {backend!r} of the CP runtime is not ported "
                "yet (ROADMAP queue A5)"
            )
        self.backend = backend
        self.comm_meta, self.calc_meta = comm_meta, calc_meta
        self.cp_size = len(calc_meta.host_args)
        self.cp_rank, self.cp_group = cp_rank, cp_group
        self.softmax_scale, self.softcap = softmax_scale, softcap
        self.num_stages = len(comm_meta.kv_stages)
        # overlap iff the solver produced more than one stage, unless off;
        # the dense backend replays the merged slices
        self.use_overlap = (
            self.num_stages > 1 if use_overlap is None else use_overlap
        ) and backend == "ffa"
        self.cast_plans = [CastPlan.from_stage(s, cp_rank) for s in comm_meta.kv_stages]
        self._build_plans()

    def _build_plans(self) -> None:
        km, r = self.calc_meta, self.cp_rank
        shard, kv_shard = km.shard_len, km.kv_shard_len
        if self.use_overlap:
            self.plans = [_plan(km.host_args[r], shard, kv_shard)] + [
                _plan(km.remote_args_per_stage[st][r], shard, rl)
                for st, rl in enumerate(km.recv_len_per_stage)
            ]
        else:
            total = kv_shard + sum(km.recv_len_per_stage)
            self.plans = [_plan(km.merged_args[r], shard, total)]

    def _params(self, d: int) -> list[FFAParams]:
        scale = float(d) ** -0.5 if self.softmax_scale is None else self.softmax_scale
        return [
            FFAParams(
                num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles,
                block_q=p.block_q, block_k=p.block_k,
                softmax_scale=scale, softcap=float(self.softcap),
            )
            for p in self.plans
        ]

    def calc_attn(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        return_max_logits: bool = False,
    ):
        """Attention of this rank's dispatched rows.

        Args:
            q: ``[shard, hq, d]``, k/v ``[kv_shard, hk, d|dv]``: this rank's
                dispatched rows.
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
        k_parts, v_parts, waits = [k], [v], []
        if self.cast_plans:  # cp > 1: the remote kv of every stage
            d = k.shape[-1]
            hp = env_comm.is_bwd_high_precision_reduce_enable()
            kv_parts, waits = group_cast_all(
                torch.cat([k, v.to(k.dtype)], dim=-1), self.cast_plans, self.cp_group, hp
            )
            k_parts = [p[..., :d] for p in kv_parts]
            v_parts = [p[..., d:] for p in kv_parts]
        if not self.use_overlap and len(k_parts) > 1:
            for wait in waits:
                wait()
            k_parts, v_parts = [torch.cat(k_parts)], [torch.cat(v_parts)]
            waits = []
        if self.backend == "sdpa":
            arg = self.calc_meta.merged_args[self.cp_rank]
            kv = (k_parts[0].to(q.dtype), v_parts[0].to(q.dtype))
            kw = dict(
                softmax_scale=self.softmax_scale, softcap=self.softcap,
                d_lo=arg.d_lo, d_hi=arg.d_hi,
            )
            out, lse = sdpa_attn(q, *kv, arg.q_ranges, arg.k_ranges, **kw)
            res = (out, lse.detach())  # lse carries no gradient, as on ffa
            if return_max_logits:
                res += (dense_max_logits(q, kv[0], arg.q_ranges, arg.k_ranges, **kw).detach(),)
        else:
            res = multi_ffa(
                q, k_parts, v_parts, self.plans, self._params(q.shape[-1]),
                [None, *waits], return_max_logits,
            )
        if return_max_logits and self.cp_size > 1:
            dist.all_reduce(res[2], op=dist.ReduceOp.MAX, group=self.cp_group)
        return res
