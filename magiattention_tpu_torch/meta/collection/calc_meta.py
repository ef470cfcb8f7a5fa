"""CalcMeta / AttnArg — per-rank kernel arguments in local coordinates.

The port's copy of ``magiattention_tpu/meta/collection/calc_meta.py`` (numpy only, imports
rewired).

Ref: magi_attention/meta/collection/calc_meta.py:67-918. An AttnArg is the
band-slice list one kernel invocation replays; the CP runtime stacks per-rank
args (padded to a common slice count) into sharded device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...kernels.mask_utils import BAND_INF


@dataclass
class AttnArg:
    """Band slices in local coordinates for one kernel call."""

    q_ranges: np.ndarray  # (N, 2) int32
    k_ranges: np.ndarray  # (N, 2) int32
    d_lo: np.ndarray  # (N,) int32
    d_hi: np.ndarray  # (N,) int32
    total_seqlen_q: int = 0
    total_seqlen_k: int = 0

    @classmethod
    def empty(cls, total_seqlen_q: int = 0, total_seqlen_k: int = 0) -> "AttnArg":
        return cls(
            q_ranges=np.zeros((0, 2), dtype=np.int32),
            k_ranges=np.zeros((0, 2), dtype=np.int32),
            d_lo=np.zeros((0,), dtype=np.int32),
            d_hi=np.zeros((0,), dtype=np.int32),
            total_seqlen_q=total_seqlen_q,
            total_seqlen_k=total_seqlen_k,
        )

    @classmethod
    def from_slices(
        cls,
        slices: list[tuple[int, int, int, int, int, int]],
        total_seqlen_q: int,
        total_seqlen_k: int,
    ) -> "AttnArg":
        """slices: (n, 6) rows of (qs, qe, ks, ke, d_lo, d_hi) in local
        coords — a list of tuples or an int array."""
        if len(slices) == 0:
            return cls.empty(total_seqlen_q, total_seqlen_k)
        arr = np.asarray(slices, dtype=np.int64)
        return cls(
            q_ranges=arr[:, 0:2].astype(np.int32),
            k_ranges=arr[:, 2:4].astype(np.int32),
            d_lo=np.clip(arr[:, 4], -BAND_INF, BAND_INF).astype(np.int32),
            d_hi=np.clip(arr[:, 5], -BAND_INF, BAND_INF).astype(np.int32),
            total_seqlen_q=total_seqlen_q,
            total_seqlen_k=total_seqlen_k,
        )

    @property
    def num_slices(self) -> int:
        return len(self.q_ranges)

    def pad_to(self, n: int) -> "AttnArg":
        """Pad with empty slices to a static count (SPMD stacking)."""
        cur = self.num_slices
        if cur > n:
            raise ValueError(f"{cur} slices > pad target {n}")
        if cur == n:
            return self
        pad = n - cur
        return AttnArg(
            q_ranges=np.concatenate(
                [self.q_ranges, np.zeros((pad, 2), dtype=np.int32)]
            ),
            k_ranges=np.concatenate(
                [self.k_ranges, np.zeros((pad, 2), dtype=np.int32)]
            ),
            d_lo=np.concatenate(
                [self.d_lo, np.full((pad,), -BAND_INF, dtype=np.int32)]
            ),
            d_hi=np.concatenate(
                [self.d_hi, np.full((pad,), BAND_INF, dtype=np.int32)]
            ),
            total_seqlen_q=self.total_seqlen_q,
            total_seqlen_k=self.total_seqlen_k,
        )

    def area(self) -> int:
        from ..container.slice import band_area

        return sum(
            band_area(
                int(self.q_ranges[i, 0]), int(self.q_ranges[i, 1]),
                int(self.k_ranges[i, 0]), int(self.k_ranges[i, 1]),
                int(self.d_lo[i]), int(self.d_hi[i]),
            )
            for i in range(self.num_slices)
        )


@dataclass
class CalcMeta:
    """Per-rank kernel args for the CP engine (self-attention).

    Attributes:
        host_args: rank -> slices over (local q, local kv shard).
        remote_args_per_stage: stage -> rank -> slices over (local q, that
            stage's remote-kv receive buffer).
        merged_args: rank -> slices over (local q, [kv shard | all remote kv])
            — the single-kernel concat path (ref dist_attn.py:3305 no-overlap).
        shard_len: local q rows per rank.
        kv_shard_len: local kv rows per rank (== shard_len for self-attn).
        recv_len_per_stage: stage -> padded remote-kv rows (same on all ranks).
    """

    host_args: list[AttnArg]
    remote_args_per_stage: list[list[AttnArg]]
    merged_args: list[AttnArg]
    shard_len: int
    recv_len_per_stage: list[int] = field(default_factory=list)
    kv_shard_len: int | None = None

    def __post_init__(self) -> None:
        if self.kv_shard_len is None:
            self.kv_shard_len = self.shard_len
