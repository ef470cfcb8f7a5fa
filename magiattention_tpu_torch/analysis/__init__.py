"""Static analysis of the port's plans (the port's counterpart of
``magiattention_tpu/analysis``).

:mod:`verifier` proves (or reports violations of) the named rule set
R1-R5 over already-constructed plan metadata (slices, ``DispatchMeta``,
``CommMeta``/``GroupCollectiveArg``, ``CalcMeta``, ``DynamicAttnPlan`` and
the tile choice) before any collective runs. Entry points: the opt-in
runtime hook ``MAGI_ATTENTION_VERIFY_PLANS=1`` (``dist_attn_runtime_mgr``
-> :func:`maybe_verify_runtime`), and the plan tiers, which verify every
plan loaded from disk or received from the leader before its first use.

:mod:`kernel_check` is the Hopper counterpart of the JAX package's kernel
contract checker: K1 (each library's shared memory against the host model),
K3 (work-list, page-table and key-table bounds over host plans) and K5 (the
env keys the kernels' code reads). :mod:`lint` is the repo linter
(MAGI-L001 to L006) over the port's tree,
``python -m magiattention_tpu_torch.analysis.lint``.
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
from .kernel_check import (  # noqa: F401
    K5_ALLOWLIST,
    check_env_keys,
    check_k1,
    check_k1_libraries,
    check_k3_decode,
    check_k3_ffa_plan,
    check_k3_key_table,
    run_kernel_audit,
)
