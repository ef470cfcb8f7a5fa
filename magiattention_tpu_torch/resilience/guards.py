"""Opt-in numeric sentinels for attention outputs (the port's copy of
``magiattention_tpu/resilience/guards.py``).

Gated by ``MAGI_ATTENTION_NUMERIC_GUARD`` (env/resilience.py): with the
flag unset :func:`check_outputs` is one env lookup + early return; with it
set, every guarded ``calc_attn`` is followed by a host-side finiteness
check of the merged output and LSE.

The LSE check deliberately allows ``-inf``: a fully-masked row's
log-sum-exp IS ``-inf`` (the kernels and the merge pad with it), so the
sentinel only flags NaN and ``+inf`` there. The output must be entirely
finite (masked rows produce zeros).

Policies: ``raise`` — throw a typed :class:`~.errors.NumericGuardError`
naming the stage; ``record`` — bump the ``resilience.guard_trip`` counter
and emit a ``resilience`` telemetry record, then return normally. Either
way a NaN can never pass silently while the guard is on.

Cost when on: one blocking device sync per guarded step (the two flags
come back to the host together). That is the documented price — the flag
is a debugging/canary tool, not a default.
"""

from __future__ import annotations

import torch

from .. import telemetry
from ..env import resilience as env_resilience
from .errors import NumericGuardError


def check_outputs(stage: str, out, lse=None) -> None:
    """Finiteness sentinel over one stage's (out, lse). No-op when
    MAGI_ATTENTION_NUMERIC_GUARD is unset."""
    policy = env_resilience.numeric_guard_policy()
    if not policy:
        return
    with torch.no_grad():
        flags = [~torch.isfinite(out).all()]
        if lse is not None:
            # -inf is the legal empty-row LSE; flag only NaN and +inf
            flags.append(torch.isnan(lse).any() | (lse == float("inf")).any())
        bad = torch.stack(flags).tolist()  # the one host sync
    bad_out = bool(bad[0])
    bad_lse = bool(bad[1]) if lse is not None else False
    if not (bad_out or bad_lse):
        return
    what = " and ".join(
        n for n, b in (("out", bad_out), ("lse", bad_lse)) if b
    )
    telemetry.inc("resilience.guard_trip", always=True)
    telemetry.record_event(
        "resilience", action="guard_trip", site="numeric_guard",
        stage=stage, policy=policy, bad_out=bad_out, bad_lse=bad_lse,
    )
    if policy == "raise":
        raise NumericGuardError(stage, f"non-finite values in {what}")
