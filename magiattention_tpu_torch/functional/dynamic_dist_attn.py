"""The dynamic (qo-comm) CP runtime, per rank.

The port's counterpart of ``magiattention_tpu/functional/dynamic_dist_attn.py``:
the execution of a :class:`~..meta.collection.dynamic_meta.DynamicAttnPlan`,
in which any rank may compute any piece of the mask, so q and out rows move
between ranks as well as k and v (ref: magi_attention/functional/dist_attn.py
qo-comm paths, _fetch_remote_q :1625, _fetch_remote_qo_do_lse :1714,
_reduce_partial_out_lse :1979, _reduce_partial_dq :2302).

Forward, on every rank:

1. ``q_buf = [q | GroupCast(q, q_cast)]``, ``k_buf``/``v_buf`` likewise over
   ``kv_cast`` (k and v in one transfer, as the static runtime sends them);
2. one FFA forward over the buffers (:meth:`DynamicDistAttnRuntime.fwd_step`);
3. the partial ``out_buf``/``lse_buf`` rows go back to their owners over
   ``ret`` (out in float32 under MAGI_ATTENTION_FWD_HIGH_PRECISION_REDUCE);
4. each owner lse-merges its rows' contributions, picked by ``merge_idx``
   from ``[out_buf | returned rows | dummy (0, -inf)]``
   (:meth:`~DynamicDistAttnRuntime.merge_step`).

Backward (:class:`_DynAttn`), the distributed-flash identity of the JAX
package's ``_dyn_bwd``: the owner computes ``delta = rowsum(dO * out)`` on
its own rows; dO, lse and delta go out over the same ``q_cast``; one FFA
backward over the buffers runs against the final lse and delta
(:meth:`~DynamicDistAttnRuntime.bwd_step`), which makes every partial dq,
dk, dv exact with no gradient through the merge weights; the partials go
back to their owners by GroupReduce over ``q_cast``/``kv_cast``, in the
input dtype unless MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE asks for
float32. The forward saves its buffers, so the backward fetches no q, k or
v again.

Each step is a method that takes and returns this rank's tensors, joined
only by the collectives in :meth:`~DynamicDistAttnRuntime.calc_attn`, so
the steps of several ranks can run on one device with index gathers in
place of the transfers. ``backend="sdpa"`` replays the rank's slices with
the dense ``sdpa_attn``, and ``"sdpa_online"`` with the blockwise
online-softmax ``sdpa_online_attn``, differentiated by autograd through
the casts (the JAX package's ``_calc_attn_sdpa``). ``calc_attn`` takes the
static runtime's guarded and recorded entry
(:meth:`~.dist_attn.DeferredTilePolicy._guarded_calc_attn`); its scopes are
``qo_comm_cast`` and ``ffa_fwd_dyn``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import telemetry
from ..comm.primitives import CastPlan, group_cast_rows, group_reduce_rows
from ..env import comm as env_comm
from ..kernels.ffa import FFAParams, ffa_bwd, ffa_delta, ffa_fwd_dispatch
from ..kernels.sdpa import dense_max_logits, sdpa_attn
from ..kernels.sdpa_online import sdpa_online_attn
from ..meta.collection.dynamic_meta import DynamicAttnPlan
from ..utils.profiling import instrument_scope, profile_scope
from .dist_attn import DeferredTilePolicy, _plan
from .utils import lse_weighted_reduce

NEG_INF = float("-inf")


def merge_rows(out_buf, lse_buf, ret_out, ret_lse, merge_idx):
    """lse-merge each local row's contributions (the JAX package's
    ``_merge_rows``).

    Args:
        out_buf/lse_buf: ``[q_buf_len, h, dv]`` / ``[q_buf_len, h]``: this
            rank's own partials.
        ret_out/ret_lse: ``[ret_len, h, dv]`` / ``[ret_len, h]``: the
            partials other ranks returned.
        merge_idx: ``[shard, M]`` int64 rows of ``[out_buf | ret | dummy]``;
            the dummy (last) row is out 0, lse -inf.

    Returns:
        (out ``[shard, h, dv]`` in the wider of the two out dtypes, lse
        ``[shard, h]``); a row with only dummy entries is (0, -inf).
    """
    dtype = torch.promote_types(out_buf.dtype, ret_out.dtype)
    h, dv = out_buf.shape[1], out_buf.shape[2]
    cat_out = torch.cat(
        [out_buf.to(dtype), ret_out.to(dtype), out_buf.new_zeros((1, h, dv), dtype=dtype)]
    )
    cat_lse = torch.cat([lse_buf, ret_lse, lse_buf.new_full((1, h), NEG_INF)])
    if merge_idx.shape[1] == 1:  # one entry a row: the merge is the gather
        return cat_out[merge_idx[:, 0]], cat_lse[merge_idx[:, 0]]
    co = cat_out[merge_idx]  # [shard, M, h, dv]
    cl = cat_lse[merge_idx]  # [shard, M, h]
    return lse_weighted_reduce(co.transpose(0, 1), cl.transpose(0, 1))


class _DynAttn(torch.autograd.Function):
    """The qo-comm forward and backward of one rank (see the module
    docstring). lse and max_logits are auxiliary outputs: their cotangents
    are ignored."""

    @staticmethod
    def forward(ctx, q, k, v, rt, params, return_max_logits):
        with profile_scope("qo_comm_cast"):
            q_buf, k_buf, v_buf = rt.buffers(q, k, v)
        with profile_scope("ffa_fwd_dyn"):
            out_buf, lse_buf, *ml = rt.fwd_step(q_buf, k_buf, v_buf, params, return_max_logits)
        ret_out, ret_lse = rt.ret_step(out_buf, lse_buf)
        out, lse = rt.merge_step(out_buf, lse_buf, ret_out, ret_lse)
        out = out.to(q.dtype)
        ctx.save_for_backward(q_buf, k_buf, v_buf, out, lse)
        ctx.rt, ctx.params, ctx.dtypes = rt, params, (q.dtype, k.dtype, v.dtype)
        ctx.mark_non_differentiable(lse, *ml)
        return (out, lse, *ml)

    @staticmethod
    def backward(ctx, do, *_aux):
        q_buf, k_buf, v_buf, out, lse = ctx.saved_tensors
        rt = ctx.rt
        with profile_scope("ffa_bwd_delta"):
            do_buf, lse_buf, delta_buf = rt.spread_step(out, lse, do.contiguous())
        with profile_scope("ffa_bwd"):
            dq_buf, dk_buf, dv_buf = rt.bwd_step(
                q_buf, k_buf, v_buf, do_buf, lse_buf, delta_buf, ctx.params
            )
        dq, dk, dv = rt.reduce_step(dq_buf, dk_buf, dv_buf, *ctx.dtypes)
        return dq, dk, dv, None, None, None


class DynamicDistAttnRuntime(DeferredTilePolicy):
    """One rank's runtime for one DynamicAttnPlan: its three GroupCast
    plans, its FFA plan over the buffers and its merge index, built once
    (under auto-tile the FFA plan at the first call:
    :class:`~.dist_attn.DeferredTilePolicy`)."""

    def __init__(
        self,
        plan: DynamicAttnPlan,
        cp_rank: int,
        cp_group=None,
        softmax_scale: float | None = None,
        softcap: float = 0.0,
        backend: str | None = "ffa",
        mesh_sig: str | None = None,
    ) -> None:
        if backend not in (None, "ffa", "sdpa", "sdpa_online"):
            raise ValueError(f"unknown kernel backend {backend!r} (ffa | sdpa | sdpa_online)")
        self.plan, self.mesh_sig = plan, mesh_sig
        self.cp_size, self.cp_rank, self.cp_group = plan.cp_size, cp_rank, cp_group
        self._resolve_backend(backend)
        self.softmax_scale, self.softcap = softmax_scale, softcap
        self.q_cast = CastPlan.from_stage(plan.q_cast, cp_rank)
        self.kv_cast = CastPlan.from_stage(plan.kv_cast, cp_rank)
        self.ret_cast = CastPlan.from_stage(plan.ret, cp_rank)
        self.attn_arg = plan.attn_args[cp_rank]
        self._merge_idx: dict = {}
        self._init_tile_policy()

    def _build_plans(self, block_q: int | None = None, block_k: int | None = None) -> None:
        with telemetry.stage_timer("build_plans"):
            p = self.plan
            self.ffa_plan = _plan(self.attn_arg, p.q_buf_len, p.k_buf_len, block_q, block_k)
            self._bq, self._bk = self.ffa_plan.block_q, self.ffa_plan.block_k
            self._tel_payload = None  # the step payload follows the plan

    def _attn_step_payload(self, q, k, v) -> dict:
        """One qo-comm step's telemetry payload (the JAX package's fields;
        callers gate on ``telemetry.enabled()``). Per-stage row bytes
        differ: q rows, fused k|v rows, and returned partial out+lse rows
        each have their own width. Shapes are the step's whole (rows times
        cp); the plan figures are this rank's (no padding to a common
        count; at cp 1, the JAX package's)."""
        p = self.plan
        sq, hq, dh = q.shape
        _, hk, dv = v.shape
        # partial out rows ride the ret cast in float32 under the fwd HP reduce
        out_itemsize = 4 if env_comm.is_fwd_high_precision_reduce_enable() else q.element_size()
        stage_defs = (
            ("q_cast", p.q_cast, "qo_comm_cast", hq * dh * q.element_size()),
            ("kv_cast", p.kv_cast, "qo_comm_cast",
             hk * dh * k.element_size() + hk * dv * v.element_size()),
            ("ret", p.ret, "ffa_fwd_dyn", hq * dv * out_itemsize + hq * 4),  # + float32 lse
        )
        stages = []
        payload_total = wire_total = 0
        for name, cast, scope, row_bytes in stage_defs:
            d = cast.telemetry_dict(executed="a2a")
            d["stage"] = name
            d["xprof_scope"] = scope
            d["row_bytes"] = row_bytes
            d["payload_bytes"] = d["payload_rows"] * row_bytes
            d["wire_bytes"] = d["wire_rows"] * row_bytes
            d["padding_bytes"] = d["padding_rows"] * row_bytes
            payload_total += d["payload_bytes"]
            wire_total += d["wire_bytes"]
            stages.append(d)
        payload = {
            "planner": "dynamic",
            "backend": self.backend,
            "mask_sig": self._mask_signature(),
            "mesh_sig": self._mesh_signature(),
            "env_sig": self._env_signature(),
            "q_shape": [sq * self.cp_size, hq, dh],
            "kv_shape": [v.shape[0] * self.cp_size, hk, dv],
            "cp_size": self.cp_size,
            "overlap_degree": 1,  # qo-comm runs one compute stage
            "seqlen_q_shard": sq * self.cp_size,
            "heads_q": hq, "head_dim": dh, "heads_kv": hk, "head_dim_v": dv,
            "dtype": str(q.dtype).removeprefix("torch."),
            "stages": stages,
            "payload_bytes_total": payload_total,
            "wire_bytes_total": wire_total,
            "padding_bytes_total": wire_total - payload_total,
        }
        if self.backend == "ffa":
            fp = self.ffa_plan
            padded = fp.num_work * fp.block_q * fp.block_k
            a = self.attn_arg
            band = telemetry.band_area(a.q_ranges, a.k_ranges, a.d_lo, a.d_hi)
            params = self.params(dh, q.element_size(), dv)
            payload.update(
                block_q=self._bq, block_k=self._bk,
                band_elems=band,
                padded_elems=padded,
                est_flops_fwd=4 * band * dh * hq,
                padded_flops_fwd=4 * padded * dh * hq,
                **self._bwd_mode_fields(fp, params, q, k, v),
            )
        return payload

    def _tile_geoms(self):
        """Every rank's slice set over its buffers and the buffers' lengths."""
        p = self.plan
        geoms = [(a.q_ranges, a.k_ranges, a.d_lo, a.d_hi) for a in p.attn_args]
        return geoms, p.q_buf_len, p.k_buf_len

    # -- the collectives ----------------------------------------------------

    def _fwd_exchanges(self, q, k, v) -> list[tuple]:
        """The forward's casts in issue order: ``[k | v]`` rows in k's
        dtype, q rows, then the partial out rows (float32 under the forward
        high-precision flag) and their float32 lse."""
        if self.cp_size == 1:
            return []
        hq, d, hk, dv = q.shape[1], q.shape[-1], k.shape[1], v.shape[-1]
        out_dtype = torch.float32 if env_comm.is_fwd_high_precision_reduce_enable() else q.dtype
        g = self.cp_group
        return (
            [(e, (hk, d + dv), k.dtype) for e in self.kv_cast.exchanges(g)]
            + [(e, (hq, d), q.dtype) for e in self.q_cast.exchanges(g)]
            + [(e, (hq, dv), out_dtype) for e in self.ret_cast.exchanges(g)]
            + [(e, (hq,), torch.float32) for e in self.ret_cast.exchanges(g)]
        )

    def _cast(self, x: torch.Tensor, plan: CastPlan) -> torch.Tensor:
        """GroupCast of ``x``'s rows: the ``[buf_len, ...]`` receive buffer
        (zero past the received rows). Differentiable (its backward is the
        GroupReduce); at cp 1 nothing is received."""
        if self.cp_size == 1:
            return x.new_zeros((plan.buf_len, *x.shape[1:]))
        return group_cast_rows(x, plan, self.cp_group)

    def _reduce(self, y: torch.Tensor, plan: CastPlan, shard_len: int) -> torch.Tensor:
        """GroupReduce (cp > 1) of partials ``y`` against the receive
        buffer, in y's dtype on the wire: ``[shard_len, ...]`` float32."""
        return group_reduce_rows(y, plan, self.cp_group, shard_len)

    # -- the local steps and the transfers between them ---------------------

    def params(self, d: int, itemsize: int = 2, dv: int | None = None) -> FFAParams:
        """The FFA params of this rank's buffers at head dims ``d`` (``dv``,
        default ``d``) and dtype ``itemsize``, with the backward's per-pass
        tiles."""
        dv = d if dv is None else dv
        self._ensure_auto_plans(d, dv, itemsize)
        p = self.ffa_plan
        scale = float(d) ** -0.5 if self.softmax_scale is None else self.softmax_scale
        return self._bwd_params(FFAParams(
            num_q_tiles=p.num_q_tiles, num_k_tiles=p.num_k_tiles,
            block_q=p.block_q, block_k=p.block_k,
            softmax_scale=scale, softcap=float(self.softcap),
        ), d, dv, itemsize)

    def merge_index(self, device: torch.device) -> torch.Tensor:
        """This rank's ``merge_idx`` ``[shard, M]`` as int64 on ``device``
        (cached)."""
        t = self._merge_idx.get(device)
        if t is None:
            t = torch.from_numpy(self.plan.merge_idx[self.cp_rank]).to(device, torch.int64)
            self._merge_idx[device] = t
        return t

    def buffers(self, q, k, v):
        """(q_buf, k_buf, v_buf): this rank's rows, then the fetched ones
        (k and v fetched in one transfer)."""
        d = k.shape[-1]
        kv = (
            torch.cat([k, v.to(k.dtype)], dim=-1) if self.cp_size > 1
            else k.new_empty((0, k.shape[1], d + v.shape[-1]))  # only its shape is read
        )
        kv_recv = self._cast(kv, self.kv_cast)
        k_buf = torch.cat([k, kv_recv[..., :d]])
        v_buf = torch.cat([v, kv_recv[..., d:].to(v.dtype)])
        return torch.cat([q, self._cast(q, self.q_cast)]), k_buf, v_buf

    def fwd_step(self, q_buf, k_buf, v_buf, params: FFAParams, return_max_logits=False):
        """(out_buf, lse_buf[, max_logits]): one FFA forward (B1, or B2
        under the pack flags) over the buffers."""
        return ffa_fwd_dispatch(q_buf, k_buf, v_buf, self.ffa_plan, params, return_max_logits)

    def ret_step(self, out_buf, lse_buf):
        """(ret_out, ret_lse): the partial rows other ranks computed for this
        rank's q, out in float32 under the forward high-precision flag."""
        if env_comm.is_fwd_high_precision_reduce_enable():
            out_buf = out_buf.float()
        ret = self._cast(out_buf, self.ret_cast), self._cast(lse_buf, self.ret_cast)
        self._fwd_casts_issued()  # the forward's last cast
        return ret

    def merge_step(self, out_buf, lse_buf, ret_out, ret_lse):
        """(out, lse) of this rank's rows (:func:`merge_rows`)."""
        return merge_rows(out_buf, lse_buf, ret_out, ret_lse, self.merge_index(out_buf.device))

    def spread_step(self, out, lse, do):
        """(do_buf, lse_buf, delta_buf): the owner's delta (B7) on its own
        rows, then dO, lse and delta over ``q_cast``; lse is -inf on the
        buffer's rows past the received ones."""
        delta = ffa_delta(out, do)
        shard = self.plan.shard_len
        do_buf = torch.cat([do, self._cast(do, self.q_cast)])
        stats = torch.stack([lse, delta], dim=-1)
        stats_buf = torch.cat([stats, self._cast(stats, self.q_cast)])
        stats_buf[shard + self.q_cast.recv_len:, :, 0] = NEG_INF
        return do_buf, stats_buf[..., 0], stats_buf[..., 1]

    def bwd_step(self, q_buf, k_buf, v_buf, do_buf, lse_buf, delta_buf, params: FFAParams):
        """(dq_buf, dk_buf, dv_buf) float32: one FFA backward over the
        buffers against the final lse and delta (B8/B9 fused, or B3-B6
        split, as :func:`~..kernels.ffa.ffa_bwd_mode` picks); dk/dv per kv
        head."""
        return ffa_bwd(q_buf, k_buf, v_buf, do_buf, lse_buf, delta_buf, self.ffa_plan, params)

    def reduce_step(self, dq_buf, dk_buf, dv_buf, q_dtype, k_dtype, v_dtype):
        """(dq, dk, dv) of this rank's rows: its own partials plus the
        GroupReduce of every rank's partials against its buffers, sent in
        the input dtype, or float32 under the backward high-precision
        flag."""
        shard, kv_shard, d = self.plan.shard_len, self.plan.kv_shard_len, dk_buf.shape[-1]
        if self.cp_size == 1:  # nothing to reduce
            return dq_buf[:shard].to(q_dtype), dk_buf[:kv_shard].to(k_dtype), dv_buf[:kv_shard].to(v_dtype)
        hp = env_comm.is_bwd_high_precision_reduce_enable()
        dq_buf = dq_buf if hp else dq_buf.to(q_dtype)
        dkv_buf = torch.cat([dk_buf, dv_buf], dim=-1)
        dkv_buf = dkv_buf if hp else dkv_buf.to(k_dtype)
        dq = dq_buf[:shard].float() + self._reduce(dq_buf[shard:], self.q_cast, shard)
        dkv = dkv_buf[:kv_shard].float() + self._reduce(dkv_buf[kv_shard:], self.kv_cast, kv_shard)
        return dq.to(q_dtype), dkv[..., :d].to(k_dtype), dkv[..., d:].to(v_dtype)

    # -- the entry ----------------------------------------------------------

    @instrument_scope(name="DynamicDistAttnRuntime.calc_attn")
    def calc_attn(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        return_max_logits: bool = False,
    ):
        """Attention of this rank's dispatched rows, qo-comm execution.

        Args:
            q: ``[shard, hq, d]``, k/v ``[kv_shard, hk, d|dv]``: this rank's
                dispatched rows.
            return_max_logits: also return the per-head max logit ``[hq]``
                float32: the max over this rank's buffers, all-reduced (MAX)
                over the cp group.

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
        if self.backend != "ffa":
            res = self._calc_attn_sdpa(q, k, v, return_max_logits)
        else:
            params = self.params(q.shape[-1], q.element_size(), v.shape[-1])
            res = _DynAttn.apply(q, k, v, self, params, return_max_logits)
        if return_max_logits and self.cp_size > 1:
            dist.all_reduce(res[2], op=dist.ReduceOp.MAX, group=self.cp_group)
            self._fwd_comm_done = True
        return res

    def _calc_attn_sdpa(self, q, k, v, return_max_logits):
        """The dense path: the same casts and merge around ``sdpa_attn``
        (or ``sdpa_online_attn``) over this rank's slices, differentiated
        by autograd (the casts' backward is the GroupReduce)."""
        q_buf, k_buf, v_buf = self.buffers(q, k, v)
        a = self.attn_arg
        kw = dict(
            softmax_scale=self.softmax_scale, softcap=self.softcap, d_lo=a.d_lo, d_hi=a.d_hi,
        )
        kv = (k_buf.to(q.dtype), v_buf.to(q.dtype))
        dense = sdpa_attn if self.backend == "sdpa" else sdpa_online_attn
        out_buf, lse_buf = dense(q_buf, *kv, a.q_ranges, a.k_ranges, **kw)
        out, lse = self.merge_step(out_buf, lse_buf, *self.ret_step(out_buf, lse_buf))
        res = (out.to(q.dtype), lse.detach())  # lse carries no gradient, as on ffa
        if return_max_logits:
            res += (dense_max_logits(q_buf, kv[0], a.q_ranges, a.k_ranges, **kw).detach(),)
        return res
