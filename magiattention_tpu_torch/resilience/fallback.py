"""Degradation chains: keep the step alive when a kernel or plan fails
(the port's copy of ``magiattention_tpu/resilience/fallback.py``).

Three chains, all gated by ``MAGI_ATTENTION_FALLBACK=1``:

1. **Kernel ladder** (:func:`run_calc_attn`): when the FFA path raises —
   an injected ``kernel_lowering`` fault, a CUDA error a kernel launch
   returned (:class:`~..kernels._build.KernelLaunchError`), or, at cp 1, a
   CUDA out-of-memory — the runtime rebuilds its plans one rung down the
   tile ladder (:func:`tile_ladder`, derived from the port's
   ``kernels/tile_policy.CANDIDATES``, the Hopper 64/128 pairs) and
   retries. When every rung fails, a step on CPU tensors pins the runtime
   to the registry's last ``calc_attn`` rung, the ``sdpa_online``
   reference path; a step on the card raises ``FallbackExhaustedError``
   instead (see below). Degradation is sticky: later steps keep the
   surviving rung (or the reference backend) instead of re-failing every
   step.
2. **Planner fallback** (``dist_attn_runtime_mgr.py``): a dynamic
   (qo-comm) plan solve that raises falls back to the static solver plan.
3. **Bounded build retry** (``DistAttnRuntimeDict``): a runtime build that
   raises is retried once; a build that still fails propagates its typed
   error and is never cached.

Every hop emits a ``resilience`` telemetry record (action="fallback" /
"retry" / "recovered") and bumps ``resilience.<action>``. With
``MAGI_ATTENTION_FALLBACK`` unset, failures propagate unchanged — and when
no resilience flag at all is set, the guarded entry points are never
reached (functional/dist_attn.py gates on
``env/resilience.is_resilience_active``).

What a kernel failure is, in the port: a kernel that fails to BUILD
(``KernelBuildError``: no ``nvcc``, a broken source) is never recovered,
under any flag — a machine that cannot build its kernels must fail loudly,
not run the plain path. At cp > 1 every rank recovers on its own, and a
retry re-issues the step's collectives, which is safe only when every rank
takes the same hop at the same call: an injected fault does (one spec, one
seeded stream on every rank), a launch-configuration error does (it
follows from the shapes), and a retry rebuilds only rank-local plans. A
failure on one rank alone, such as an out-of-memory on one card, cannot
be agreed on in the middle of a step, so at cp > 1 it is not recoverable
and raises on that rank.

On the card the layer only ever moves from one hand-written kernel to
another: the tile ladder, the fused backward to the split one, and the
decode kernels (B10/B11/B12) to ``gather_ffa``. The plain PyTorch rungs
(:data:`PLAIN_RUNGS`: ``sdpa`` and ``sdpa_online`` for ``calc_attn``,
``dense`` for ``serve_decode``) are taken only for CPU tensors, where every
wrapper runs its plain version anyway; on CUDA tensors a chain that would
descend to one raises ``FallbackExhaustedError`` from the kernel's error.
"""

from __future__ import annotations

import torch

from .. import telemetry
from ..env import resilience as env_resilience
from .errors import FallbackExhaustedError, InjectedFault
from .guards import check_outputs
from .inject import should_fire

# bounded retry budget for runtime/plan builds (attempts = 1 + RETRIES)
PLAN_BUILD_RETRIES = 1

# the final rung of the kernel ladder: the reference dense path. Kept as
# a module constant; _descend_ladder consults the backend registry's
# calc_attn ladder, whose lowest-ranked rung is this.
REFERENCE_BACKEND = "sdpa_online"

# the rungs of each ladder that run plain PyTorch, not a kernel: never a
# kernel's stand-in on the card
PLAIN_RUNGS = {"calc_attn": ("sdpa", "sdpa_online"), "serve_decode": ("dense",)}

_OOM = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)


def on_card(t: torch.Tensor) -> bool:
    """Whether a step on ``t`` runs the card's kernels (CUDA tensors): the
    resilience layer then never descends to a plain rung."""
    return t.device.type == "cuda"


def card_rungs(decision: str, rungs, card: bool) -> list[str]:
    """``rungs`` without the decision's plain rungs when ``card``."""
    plain = PLAIN_RUNGS.get(decision, ()) if card else ()
    return [r for r in rungs if r not in plain]


def reference_backend() -> str:
    """Last rung of the registry's ``calc_attn`` ladder — the backend the
    kernel fallback chain pins when every tile rung has failed."""
    from ..kernels import registry as _registry

    rungs = _registry.ladder("calc_attn")
    return rungs[-1] if rungs else REFERENCE_BACKEND


def kernel_failure_types(cp_size: int = 1) -> tuple[type[BaseException], ...]:
    """Exception types the kernel ladder treats as recoverable: injected
    faults and CUDA errors a launch returned, plus, at cp 1 only, CUDA
    out-of-memory (a one-rank failure that a cp > 1 group cannot agree on
    mid-step). A kernel build failure is never among them."""
    from ..kernels._build import KernelLaunchError

    types: tuple[type[BaseException], ...] = (InjectedFault, KernelLaunchError)
    return types + (_OOM,) if cp_size == 1 else types


def record_resilience_event(action: str, site: str, **extra) -> None:
    """One telemetry record + counter per resilience action (the counter
    is kept with telemetry off too: ``telemetry.counters("resilience.")``)."""
    telemetry.inc(f"resilience.{action}", always=True)
    telemetry.record_event("resilience", action=action, site=site, **extra)


def tile_ladder(bq: int, bk: int) -> list[tuple[int, int]]:
    """Descending retry rungs below the current (bq, bk): every
    ``tile_policy.CANDIDATES`` entry with strictly smaller padded area,
    largest first — each rung shrinks the kernel's shared-memory residency,
    the resource whose exhaustion the ladder exists to survive."""
    from ..kernels.tile_policy import CANDIDATES

    area = bq * bk
    rungs = sorted(
        {c for c in CANDIDATES if c[0] * c[1] < area},
        key=lambda c: (-(c[0] * c[1]), -c[0]),
    )
    return rungs


def _corrupt_output(out: torch.Tensor) -> torch.Tensor:
    """The nan_output injection payload: poison one element so the
    numeric guards have something real to catch (out's gradient is
    unchanged: a constant is added)."""
    poison = torch.zeros(out.shape, dtype=out.dtype, device=out.device)
    poison.view(-1)[0] = float("nan")
    return out + poison


def run_calc_attn(runtime, q, k, v, return_max_logits: bool = False):
    """Guarded execution of one ``calc_attn`` step (both CP runtimes).

    Only reached when a resilience flag is set; the fast path in
    ``functional/dist_attn.py`` bypasses this function entirely. With
    ``MAGI_ATTENTION_STEP_RETRIES`` > 0 the step watchdog governs instead:
    bounded retry through backend rungs with numeric quarantine
    (resilience/watchdog.py); otherwise behavior is exactly the
    pre-watchdog chain below.
    """
    if env_resilience.step_retries() > 0:
        from .watchdog import run_with_watchdog

        return run_with_watchdog(runtime, q, k, v, return_max_logits)
    stage = f"{type(runtime).__name__}.calc_attn"
    failures = kernel_failure_types(getattr(runtime, "cp_size", 1))
    try:
        result = runtime._calc_attn_impl(q, k, v, return_max_logits)
    except failures as e:
        if not env_resilience.is_fallback_enable():
            raise
        result = _descend_ladder(
            runtime, q, k, v, return_max_logits, first_err=e,
            failures=failures,
        )
    if should_fire("nan_output"):
        result = (_corrupt_output(result[0]), *result[1:])
    check_outputs(stage, result[0], result[1])
    return result


def _descend_ladder(runtime, q, k, v, return_max_logits, first_err,
                    failures):
    """Retry down the tile ladder, then, for CPU tensors, the reference
    dense path; on the card an exhausted tile ladder raises."""
    bq = getattr(runtime, "_bq", None)
    bk = getattr(runtime, "_bk", None)
    record_resilience_event(
        "fallback", "kernel_lowering", action_detail="ladder_start",
        blocks=[bq, bk], error=type(first_err).__name__,
    )
    if bq is not None:
        # pin the ladder's choice: the deferred auto-tile policy must not
        # overwrite a rung's plans on the retry
        runtime._auto_tile_pending = False
        for hop, (rung_bq, rung_bk) in enumerate(tile_ladder(bq, bk)):
            try:
                runtime._build_plans(rung_bq, rung_bk)
                result = runtime._calc_attn_impl(
                    q, k, v, return_max_logits
                )
            except failures:
                record_resilience_event(
                    "fallback", "kernel_lowering",
                    action_detail="ladder_hop_failed", hop=hop,
                    blocks=[rung_bq, rung_bk],
                )
                continue
            record_resilience_event(
                "recovered", "kernel_lowering",
                action_detail="ladder_hop", hop=hop,
                blocks=[rung_bq, rung_bk],
            )
            return result
    reference = reference_backend()
    if on_card(q):
        record_resilience_event(
            "fallback", "kernel_lowering", action_detail="exhausted_on_card",
            error=type(first_err).__name__,
        )
        raise FallbackExhaustedError(
            f"kernel fallback chain exhausted: every tile rung failed, and the "
            f"{reference} rung is plain PyTorch, never run in a kernel's place "
            "on the card"
        ) from first_err
    # last rung, CPU tensors only: the reference dense path
    # (kernels/sdpa_online.py)
    runtime._backend_override = reference
    try:
        result = runtime._calc_attn_impl(q, k, v, return_max_logits)
    except Exception as e:
        runtime._backend_override = None
        raise FallbackExhaustedError(
            "kernel fallback chain exhausted: tile ladder and the "
            f"{reference} reference path all failed"
        ) from (first_err if isinstance(e, failures) else e)
    record_resilience_event(
        "recovered", "kernel_lowering", action_detail="reference_backend",
        backend=reference,
    )
    return result
