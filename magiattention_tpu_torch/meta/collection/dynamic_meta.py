"""DynamicAttnPlan — the executable plan emitted by the dynamic (qo-comm)
solver.

The port's copy of ``magiattention_tpu/meta/collection/dynamic_meta.py``
(numpy only, imports rewired).

Ref: magi_attention/meta/solver/dynamic_attn_solver.py:47-608 builds
group-collective args for q, o, do, dq and kv; here the backward-direction
collectives need no separate args — they are the reverses of the two
forward casts (q_cast, kv_cast) plus the return cast (ret), so the plan
carries exactly three GroupCollectiveArgs and one merge-index matrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .calc_meta import AttnArg
from .comm_meta import GroupCollectiveArg


@dataclass
class DynamicAttnPlan:
    """Host plan for one dynamic-solver solve.

    Execution contract (per rank; ``functional/dynamic_dist_attn.py``):

    1. ``q_buf = [local q shard | group_cast(q, q_cast)]``  (q_buf_len rows)
    2. ``k_buf/v_buf = [local kv shard | group_cast(k/v, kv_cast)]``
    3. ``out_buf, lse_buf = FFA(q_buf, k_buf, v_buf, attn_args[rank])``
    4. ``ret_out/lse = group_cast(out_buf/lse_buf, ret)`` — partials return
       to their q owners
    5. per local row, lse-merge the rows selected by ``merge_idx`` from
       ``[out_buf | ret_buf | dummy]`` (dummy = 0 / -inf).

    Backward is the exact reverse: (do, lse, delta) re-distribute via
    ``q_cast``; dq/dkv partial rows reduce back (GroupReduce) over
    ``q_cast`` / ``kv_cast``.
    """

    q_cast: GroupCollectiveArg
    kv_cast: GroupCollectiveArg
    ret: GroupCollectiveArg
    attn_args: list[AttnArg]
    merge_idx: np.ndarray  # (cp, shard, M) int32
    shard_len: int
    kv_shard_len: int
    q_buf_len: int
    k_buf_len: int
    ret_len: int
    # solver carryover (DynSolveState): the input rectangles + per-rank tile
    # buckets behind this plan, fed back as prev_state for the next step's
    # incremental re-solve. Not part of the executable contract.
    solver_state: object | None = None

    @property
    def cp_size(self) -> int:
        return len(self.attn_args)

    @property
    def dummy_index(self) -> int:
        return self.q_buf_len + self.ret_len

    def comm_rows(self) -> dict[str, int]:
        """Total communicated rows by stream (plan-quality metric)."""
        return {
            "q": int(self.q_cast.send_counts.sum()),
            "kv": 2 * int(self.kv_cast.send_counts.sum()),
            "out_lse": 2 * int(self.ret.send_counts.sum()),
        }
