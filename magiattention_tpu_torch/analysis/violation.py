"""Violation records + the named rule registry for the plan verifier
(the port's copy of ``magiattention_tpu/analysis/violation.py``).

Severity taxonomy: ``error`` marks an invariant whose violation produces
wrong results or a hang inside a collective (the runtime hook raises on
these); ``warning`` marks a plan that is correct but off-contract on a
quality bound (load imbalance, dead overlap stage, non-minimal padding).
"""

from __future__ import annotations

from dataclasses import dataclass, field

ERROR = "error"
WARNING = "warning"

# The named rule set (one-line rationale each). R5 is the port's own: the
# Hopper kernels' compiled tile instances and shared memory in place of
# the TPU lane quanta and VMEM. The kernel contract rules K1, K3 and K5
# are the kernel checker's (kernel_check.py).
RULES: dict[str, str] = {
    "R1": "slice well-formedness: non-negative, in-bounds, "
          "mask-type/band-consistent q/k ranges",
    "R2": "dispatch partition: chunks cover [0, total_seqlen) exactly once "
          "per rank-set; per-rank area within the declared balance bound",
    "R3": "zero-redundancy comms: per-stage cast rows disjoint + complete "
          "vs remote KV demand, reduce/gather indices mirror cast rows, "
          "wire rows exceed payload only via declared alignment padding",
    "R4": "overlap staging: stage partition covers all remote work; "
          "overlap degree consistent between CommMeta and CalcMeta",
    "R5": "tile legality: each pass's blocks are a compiled Hopper "
          "instance, the bwd overrides divide the fwd-padded geometry, and "
          "each CTA's shared memory fits the card's opt-in limit",
}

# Which verifier rule(s) cover each public dataclass in meta/collection.
# The JAX package's linter (its rule MAGI-L004) fails when a public
# dataclass appears there without an entry here: adding a new plan object
# forces someone to decide how it is verified.
RULE_COVERAGE: dict[str, tuple[str, ...]] = {
    "DispatchMeta": ("R2",),
    "GroupCollectiveArg": ("R3",),
    "CommMeta": ("R3", "R4"),
    "AttnArg": ("R1",),
    "CalcMeta": ("R1", "R4"),
    "DynamicAttnPlan": ("R1", "R3", "R4"),
}


@dataclass(frozen=True)
class Violation:
    """One rule violation at one site.

    Attributes:
        rule_id: "R1".."R5" (see :data:`RULES`).
        severity: "error" | "warning".
        site: where in the plan (e.g. "kv_stage0 transfer_table[2][1]").
        detail: what exactly is wrong, with the offending values.
    """

    rule_id: str
    severity: str
    site: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule_id}:{self.severity}] {self.site}: {self.detail}"


class PlanVerificationError(ValueError):
    """Raised by the runtime hook on error-severity violations."""

    def __init__(self, report: "VerifyReport") -> None:
        self.report = report
        errs = report.errors()
        lines = [f"plan verification failed ({len(errs)} error(s)):"]
        lines += [f"  {v}" for v in errs]
        super().__init__("\n".join(lines))


@dataclass
class VerifyReport:
    """Outcome of one verifier run: rules exercised + violations found."""

    violations: list[Violation] = field(default_factory=list)
    rules_run: list[str] = field(default_factory=list)

    def add(self, rule_id: str, severity: str, site: str, detail: str) -> None:
        self.violations.append(Violation(rule_id, severity, site, detail))

    def mark_run(self, rule_id: str) -> None:
        if rule_id not in self.rules_run:
            self.rules_run.append(rule_id)

    def errors(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == ERROR]

    def warnings(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == WARNING]

    def fired_rules(self) -> set[str]:
        return {v.rule_id for v in self.violations}

    def ok(self) -> bool:
        return not self.errors()

    def raise_if_errors(self) -> None:
        if not self.ok():
            raise PlanVerificationError(self)

    def summary(self) -> str:
        head = (
            f"plan verify: rules={','.join(self.rules_run) or '-'} "
            f"errors={len(self.errors())} warnings={len(self.warnings())}"
        )
        return "\n".join([head] + [f"  {v}" for v in self.violations])
