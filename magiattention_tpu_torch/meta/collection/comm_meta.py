"""CommMeta / GroupCollectiveArg — the group-collective plan.

The port's copy of ``magiattention_tpu/meta/collection/comm_meta.py`` (numpy only, imports
rewired). The lowering arrays below are the JAX package's plan, kept
field for field; the port executes every stage, whatever its planned
lowering, as one ``all_to_all_single`` with the true per-pair counts
(``send_counts``, ``send_idx``; see ``comm/primitives.py``).

Ref: magi_attention/meta/collection/comm_meta.py:41-765. A
GroupCollectiveArg describes one GroupCast stage as whole-mesh index arrays
that lower onto ``jax.lax.all_to_all`` inside shard_map:

  send:  every rank gathers ``send_idx[rank]`` rows of its kv shard into a
         (cp, A) buffer (A = aligned max rows per (src,dst) pair)
  a2a:   all_to_all over the cp axis
  recv:  every rank gathers ``recv_sel[rank]`` rows of the flattened (cp*A)
         receive buffer into its remote-kv buffer (R_max rows)

The transpose of this program under jax AD is exactly GroupReduce (scatter-add
back through the gathers + reverse all_to_all), so the backward dkv reduction
needs no hand-written comm (XLA replaces the reference's
group_reduce/_reduce_partial_dkv machinery, dist_attn.py:2123).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from ...common.ranges import AttnRanges

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (comm -> meta)
    from ...comm.hier import HierGroupCastPlan


@dataclass
class GroupCollectiveArg:
    """One GroupCast stage over the whole mesh.

    Three interchangeable wire lowerings are planned host-side and the
    cheapest available one is picked per stage (``lowering``):

    - ``a2a``: dense equal-split ``jax.lax.all_to_all`` — every (src,dst)
      pair padded to ``a_cap`` (max pair rows). Wire rows/rank = cp * a_cap.
    - ``ppermute``: one ``jax.lax.ppermute`` round per active ring distance
      delta, each padded only to that distance's max pair (``pp_caps``).
      Wire rows/rank = sum(pp_caps). For skewed masks (causal) this is near
      zero-redundant instead of cp x max-pair. Portable to every backend.
    - ``ragged``: ``jax.lax.ragged_all_to_all`` — true per-pair split sizes,
      exactly zero padding on the wire (the TPU counterpart of the
      reference's native grpcoll kernels, csrc/comm/grpcoll/, splits per
      grpcoll/utils.py:593). TPU-only (XLA:CPU lacks the op — verified
      UNIMPLEMENTED in XLA:CPU ThunkEmitter as of jax 0.9), so it enters
      the candidate set only when env_comm.is_ragged_grpcoll_enable().
    """

    # [dst][src] -> global k ranges src sends to dst (the transfer table,
    # ref meta/container/transfer_table.py)
    transfer_table: list[list[AttnRanges]]
    # a2a lowering arrays
    send_idx: np.ndarray  # (cp, cp, A) int32 — [src][dst] local row indices
    send_counts: np.ndarray  # (cp, cp) int32
    recv_sel: np.ndarray  # (cp, R_max) int32 — [dst] flat src*A+pos selects
    recv_len: np.ndarray  # (cp,) int32 — valid rows per dst
    a_cap: int  # per-pair aligned capacity A
    r_max: int  # padded receive length
    # ppermute lowering arrays (None when cp == 1 / no remote traffic)
    pp_deltas: tuple[int, ...] = ()  # active ring distances (1..cp-1)
    pp_caps: tuple[int, ...] = ()  # per-delta aligned capacity
    pp_send_idx: np.ndarray | None = None  # (cp, sum_caps) int32
    pp_recv_sel: np.ndarray | None = None  # (cp, R_max) int32
    lowering: str = "a2a"  # chosen wire lowering for this stage
    # two-level plans: the solver-built phase-A/phase-B split for this stage
    # on a (dcn, ici) mesh. None on flat meshes; when set, the runtime uses
    # it directly instead of re-planning from the transfer table.
    hier_plan: "HierGroupCastPlan | None" = None

    def total_send_rows(self) -> int:
        return int(self.send_counts.sum())

    def comm_volume_bytes(self, row_bytes: int) -> int:
        """Payload actually needed (excludes alignment padding)."""
        return self.payload_rows() * row_bytes

    def payload_rows(self) -> int:
        """True off-diagonal payload rows (whole mesh)."""
        off_diag = self.send_counts.copy()
        np.fill_diagonal(off_diag, 0)
        return int(off_diag.sum())

    def wire_rows(self, lowering: str | None = None) -> int:
        """Rows crossing the wire (whole mesh) under a lowering, padding
        included — the denominator of the zero-redundancy claim."""
        cp = self.send_counts.shape[0]
        kind = lowering or self.lowering
        if kind == "ppermute":
            return cp * int(sum(self.pp_caps))
        if kind == "ragged":
            # true per-pair splits: only off-diagonal payload crosses the
            # wire (src==dst segments are local copies)
            return self.payload_rows()
        return cp * cp * self.a_cap

    def wire_ratio(self) -> float:
        """wire/payload under the chosen lowering (1.0 = zero-redundant)."""
        payload = self.payload_rows()
        return self.wire_rows() / payload if payload else 1.0

    def padding_rows(self, lowering: str | None = None) -> int:
        """Alignment-padding waste on the wire: rows transferred that carry
        no payload (wire - payload) under a lowering."""
        return max(self.wire_rows(lowering) - self.payload_rows(), 0)

    def telemetry_dict(self, executed: str | None = None) -> dict:
        """One stage's comm-volume summary for the telemetry registry
        (rows; multiply by row_bytes for bytes — the runtime does, once
        tensor dtypes are known). ``executed`` is the lowering the runtime
        actually runs when it overrides the solver's portable choice."""
        kind = executed or self.lowering
        wire = (
            self.wire_rows(kind)
            if kind in ("a2a", "ppermute", "ragged")
            else self.wire_rows(self.lowering)  # e.g. hier: flat # is a bound
        )
        payload = self.payload_rows()
        out = {
            "lowering_planned": self.lowering,
            "lowering_executed": kind,
            "payload_rows": payload,
            "wire_rows": wire,
            "padding_rows": max(wire - payload, 0),
            "wire_ratio": wire / payload if payload else 1.0,
            "a2a_wire_rows": self.wire_rows("a2a"),
            "a_cap": self.a_cap,
            "r_max": self.r_max,
            "send_rows_per_rank": self.send_counts.sum(axis=1).tolist(),
            "recv_rows_per_rank": self.recv_len.tolist(),
        }
        if self.hier_plan is not None:
            out["dcn_rows"] = self.hier_plan.dcn_rows()
        return out


def pick_lowering(arg: GroupCollectiveArg) -> str:
    """Per-stage AUTO wire-tier choice, shared by the static and dynamic
    solvers: cheapest available lowering by wire rows. The ragged tier's
    wire volume is the true payload (zero padding) so it wins whenever
    available (TPU); ties also go to it."""
    from ...env import comm as env_comm

    candidates = ["a2a"]
    if sum(arg.pp_caps):
        candidates.insert(0, "ppermute")
    if env_comm.is_ragged_grpcoll_enable():
        candidates.insert(0, "ragged")
    return min(candidates, key=arg.wire_rows)


def build_pp_lowering(
    pair_counts: np.ndarray,
    rows_for,
    recv_parts: list[list[tuple[int, int, int]]],
    r_max: int,
    align: int,
) -> tuple[tuple[int, ...], tuple[int, ...], np.ndarray | None, np.ndarray | None]:
    """Shared ppermute-lowering planner (used by both the static and the
    dynamic solver — one implementation of the per-distance packing).

    Args:
        pair_counts: (cp, cp) [src][dst] row counts.
        rows_for: callable (src, dst) -> int32 array of local row indices in
            pair order (only called for non-empty pairs).
        recv_parts: [dst] -> (src, start_pos_in_pair, n) in buffer order.
        r_max: padded receive length.
        align: per-delta capacity alignment.

    Returns:
        (deltas, caps, pp_send_idx (cp, sum_caps), pp_recv_sel (cp, r_max)),
        with the arrays None when there is no remote traffic.
    """
    cp = pair_counts.shape[0]
    deltas, caps = [], []
    for delta in range(1, cp):
        mx = max(int(pair_counts[s, (s + delta) % cp]) for s in range(cp))
        if mx > 0:
            deltas.append(delta)
            caps.append(-(-mx // align) * align)
    cum = {}
    off = 0
    for delta, c in zip(deltas, caps):
        cum[delta] = off
        off += c
    sum_caps = off
    if not sum_caps:
        return (), (), None, None
    pp_send_idx = np.zeros((cp, sum_caps), dtype=np.int32)
    for s in range(cp):
        for delta in deltas:
            d = (s + delta) % cp
            n = int(pair_counts[s, d])
            if n:
                pp_send_idx[s, cum[delta]: cum[delta] + n] = rows_for(s, d)
    pp_recv_sel = np.zeros((cp, r_max), dtype=np.int32)
    for d in range(cp):
        parts = [
            cum[(d - src) % cp] + start_pos + np.arange(n, dtype=np.int32)
            for src, start_pos, n in recv_parts[d]
            if n
        ]
        if parts:
            flat = np.concatenate(parts)
            pp_recv_sel[d, : flat.size] = flat
    return tuple(deltas), tuple(caps), pp_send_idx, pp_recv_sel


@dataclass
class CommMeta:
    """All GroupCast stages of the forward pass (kv; qo-comm adds more).

    ``kv_host_ranges`` (per-rank merged global kv ownership) rides along so
    the runtime can re-plan any stage hierarchically (comm/hier.py) from its
    transfer table without consulting the solver again.
    """

    kv_stages: list[GroupCollectiveArg] = field(default_factory=list)
    kv_host_ranges: list | None = None

    @property
    def overlap_degree(self) -> int:
        return len(self.kv_stages)
