"""Static analysis of the port's plans (the port's counterpart of
``magiattention_tpu/analysis``).

:mod:`verifier` proves (or reports violations of) the named rule set
R1-R5 over already-constructed plan metadata (slices, ``DispatchMeta``,
``CommMeta``/``GroupCollectiveArg``, ``CalcMeta``, ``DynamicAttnPlan`` and
the tile choice) before any collective runs. Entry points: the opt-in
runtime hook ``MAGI_ATTENTION_VERIFY_PLANS=1`` (``dist_attn_runtime_mgr``
-> :func:`maybe_verify_runtime`), and the plan tiers, which verify every
plan loaded from disk or received from the leader before its first use.

Not ported yet: the JAX package's kernel contract checker
(``kernel_check``, rules K1-K5; its Hopper counterpart is ROADMAP Queue A
item 4, where its exports would join these) and its linter (``lint``,
Queue A item 3).
"""

from .violation import (  # noqa: F401
    PlanVerificationError,
    RULES,
    RULE_COVERAGE,
    VerifyReport,
    Violation,
)
from .verifier import (  # noqa: F401
    maybe_verify_runtime,
    verify_dynamic_plan,
    verify_plan,
)
