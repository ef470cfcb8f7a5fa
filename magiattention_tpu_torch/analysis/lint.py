"""AST-based linter of the port's tree: codebase rules the type system
cannot express (the port's copy of ``magiattention_tpu/analysis/lint.py``,
run over ``magiattention_tpu_torch/``).

Rules (MAGI-L prefix; all stdlib ``ast``, no third-party linter deps):

- **MAGI-L001** — no raw ``os.environ`` / ``os.getenv`` outside
  ``magiattention_tpu_torch/env/``: every behavior flag goes through a
  typed getter so ``ENV_KEYS_AFFECTING_RUNTIME`` can snapshot it into the
  runtime cache key (an unregistered flag read silently survives cache
  hits with stale behavior).
- **MAGI-L002** — no host clocks (``time.time``, ``perf_counter``,
  ``monotonic``, ``process_time``) inside ``kernels/`` or ``functional/``:
  a kernel launch returns before the card runs it, so a host clock there
  reads launch time, not device time; timing belongs to the telemetry
  layer (its CUDA events).
- **MAGI-L003** — no ``print`` in library code: the package logs through
  ``logging`` / telemetry so output is capturable and gated.
- **MAGI-L004** — every public dataclass in ``meta/collection`` has an
  entry in :data:`~.violation.RULE_COVERAGE`: a new plan object forces a
  decision about how the verifier checks it.
- **MAGI-L005** — every registered fault-injection site
  (``resilience.inject.INJECTION_SITES``) is named in the port's chaos
  tests, :data:`CHAOS_TESTS` (``tests/test_torch_resilience.py``, and
  ``tests/test_torch_plan_store.py`` for the plan sites): a site nobody
  injects is a recovery path nobody tests.
- **MAGI-L006** — every ``MAGI_*`` env key named under ``env/`` has a
  row in ``docs/env_variables.md``: an undocumented flag is invisible to
  operators, and the table doubles as the review surface for the
  "does this key belong in ENV_KEYS_AFFECTING_RUNTIME?" decision.

Known-legacy findings would live in ``lint_baseline.txt`` beside this
module (``<rule> <relpath>`` per line); it is empty, and a non-empty one
warns.

CLI: ``python -m magiattention_tpu_torch.analysis.lint [root] [--baseline FILE]``.
"""

from __future__ import annotations

import ast
import os
import sys
from dataclasses import dataclass

_CLOCK_NAMES = frozenset(
    {"time", "perf_counter", "monotonic", "process_time", "perf_counter_ns",
     "monotonic_ns", "time_ns"}
)
_ENV_ATTRS = frozenset({"environ", "getenv"})


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str  # relative to the lint root
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    @property
    def baseline_key(self) -> str:
        return f"{self.rule} {self.path}"


class _FileLinter(ast.NodeVisitor):
    def __init__(self, relpath: str, check_env: bool, check_clocks: bool):
        self.relpath = relpath
        self.check_env = check_env
        self.check_clocks = check_clocks
        self.findings: list[LintFinding] = []
        self.os_aliases: set[str] = set()
        self.time_aliases: set[str] = set()
        self.env_names: set[str] = set()  # from os import environ/getenv
        self.clock_names: set[str] = set()  # from time import perf_counter...

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            LintFinding(rule, self.relpath, getattr(node, "lineno", 0), message)
        )

    # -- alias collection --------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name == "os":
                self.os_aliases.add(a.asname or "os")
            elif a.name == "time":
                self.time_aliases.add(a.asname or "time")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "os":
            for a in node.names:
                if a.name in _ENV_ATTRS:
                    self.env_names.add(a.asname or a.name)
        elif node.module == "time":
            for a in node.names:
                if a.name in _CLOCK_NAMES:
                    self.clock_names.add(a.asname or a.name)
        self.generic_visit(node)

    # -- rule checks -------------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        base = node.value
        if isinstance(base, ast.Name):
            if (
                self.check_env
                and base.id in self.os_aliases
                and node.attr in _ENV_ATTRS
            ):
                self._add(
                    "MAGI-L001", node,
                    f"raw os.{node.attr} outside env/ — add a typed getter "
                    "in magiattention_tpu_torch/env/ instead",
                )
            if (
                self.check_clocks
                and base.id in self.time_aliases
                and node.attr in _CLOCK_NAMES
            ):
                self._add(
                    "MAGI-L002", node,
                    f"host clock time.{node.attr} in kernel/runtime code — "
                    "a host clock reads launch time here; use the "
                    "telemetry layer",
                )
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if self.check_env and node.id in self.env_names:
            self._add(
                "MAGI-L001", node,
                f"raw {node.id} (from os) outside env/ — add a typed "
                "getter in magiattention_tpu_torch/env/ instead",
            )
        if self.check_clocks and node.id in self.clock_names:
            self._add(
                "MAGI-L002", node,
                f"host clock {node.id} (from time) in kernel/runtime code",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name) and node.func.id == "print":
            self._add(
                "MAGI-L003", node,
                "print() in library code — use logging or telemetry",
            )
        self.generic_visit(node)


def _iter_py_files(root: str):
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _in_subdir(relpath: str, subdir: str) -> bool:
    return relpath.replace(os.sep, "/").startswith(subdir + "/")


def lint_file(path: str, relpath: str) -> list[LintFinding]:
    """Lint one python file; relpath decides which rules apply."""
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintFinding("MAGI-L000", relpath, e.lineno or 0,
                            f"syntax error: {e.msg}")]
    linter = _FileLinter(
        relpath,
        check_env=not _in_subdir(relpath, "env"),
        check_clocks=(
            _in_subdir(relpath, "kernels") or _in_subdir(relpath, "functional")
        ),
    )
    linter.visit(tree)
    return linter.findings


def check_rule_coverage(root: str) -> list[LintFinding]:
    """MAGI-L004: every public dataclass in meta/collection is covered by a
    verifier rule (declared in violation.RULE_COVERAGE)."""
    from .violation import RULE_COVERAGE

    findings: list[LintFinding] = []
    coll = os.path.join(root, "meta", "collection")
    if not os.path.isdir(coll):
        return findings
    for path in _iter_py_files(coll):
        relpath = os.path.relpath(path, root)
        with open(path, "r", encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
                continue
            is_dataclass = any(
                (isinstance(d, ast.Name) and d.id == "dataclass")
                or (isinstance(d, ast.Attribute) and d.attr == "dataclass")
                or (
                    isinstance(d, ast.Call)
                    and (
                        (isinstance(d.func, ast.Name)
                         and d.func.id == "dataclass")
                        or (isinstance(d.func, ast.Attribute)
                            and d.func.attr == "dataclass")
                    )
                )
                for d in node.decorator_list
            )
            if is_dataclass and node.name not in RULE_COVERAGE:
                findings.append(
                    LintFinding(
                        "MAGI-L004", relpath, node.lineno,
                        f"public plan dataclass {node.name} has no entry in "
                        "analysis.violation.RULE_COVERAGE — declare which "
                        "verifier rule(s) check it",
                    )
                )
    return findings


# the port's chaos tests, beside the package root: the resilience plane's
# and the plan tiers' (where the plan_* sites are injected)
CHAOS_TESTS = ("tests/test_torch_resilience.py", "tests/test_torch_plan_store.py")


def check_injection_site_coverage(
    root: str, corpus_files: tuple[str, ...] = CHAOS_TESTS
) -> list[LintFinding]:
    """MAGI-L005: every registered injection site name appears in the
    chaos tests (``corpus_files``, relative to the package root's parent)."""
    from ..resilience.inject import INJECTION_SITES

    findings: list[LintFinding] = []
    inject_rel = os.path.join("resilience", "inject.py")
    if not os.path.exists(os.path.join(root, inject_rel)):
        return findings  # linting a foreign tree; the registry isn't there
    corpus = ""
    for rel in corpus_files:
        path = os.path.join(os.path.dirname(root), rel)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                corpus += f.read()
    for site in INJECTION_SITES:
        if site not in corpus:
            findings.append(
                LintFinding(
                    "MAGI-L005", inject_rel, 0,
                    f"injection site '{site}' has no test in "
                    f"{', '.join(corpus_files)} — every registered site must "
                    "exercise its documented recover-or-raise path",
                )
            )
    return findings


_ENV_KEY_RE = None  # compiled lazily; keeps the module import light


def check_env_doc_coverage(
    root: str, docs_path: str | None = None
) -> list[LintFinding]:
    """MAGI-L006: every ``MAGI_*`` env key string constant under ``env/``
    appears in ``docs/env_variables.md``.

    Keys are discovered syntactically (string constants matching
    ``MAGI_[A-Z0-9_]+`` in ``env/*.py``) so getters, the
    ``ENV_KEYS_AFFECTING_RUNTIME`` registry, and scoped_env defaults all
    feed the same check. Non-``MAGI_`` keys (e.g. ``CUDA_HOME``) are
    deliberately exempt — they are not ours to catalogue.
    """
    global _ENV_KEY_RE
    if _ENV_KEY_RE is None:
        import re

        _ENV_KEY_RE = re.compile(r"^MAGI_[A-Z0-9_]+$")
    findings: list[LintFinding] = []
    env_dir = os.path.join(root, "env")
    if not os.path.isdir(env_dir):
        return findings
    if docs_path is None:
        docs_path = os.path.join(
            os.path.dirname(root), "docs", "env_variables.md"
        )
    doc_text = ""
    if os.path.exists(docs_path):
        with open(docs_path, "r", encoding="utf-8") as f:
            doc_text = f.read()
    for path in _iter_py_files(env_dir):
        relpath = os.path.relpath(path, root)
        with open(path, "r", encoding="utf-8") as f:
            try:
                tree = ast.parse(f.read(), filename=path)
            except SyntaxError:
                continue
        seen: set[str] = set()
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _ENV_KEY_RE.match(node.value)
                and node.value not in seen
                and node.value not in doc_text
            ):
                seen.add(node.value)
                findings.append(
                    LintFinding(
                        "MAGI-L006", relpath, node.lineno,
                        f"env key {node.value} has no row in "
                        "docs/env_variables.md — document it (and decide "
                        "whether it belongs in ENV_KEYS_AFFECTING_RUNTIME)",
                    )
                )
    return findings


def lint_package(root: str) -> list[LintFinding]:
    """Run every rule over a package directory; findings in path order."""
    findings: list[LintFinding] = []
    for path in _iter_py_files(root):
        findings.extend(lint_file(path, os.path.relpath(path, root)))
    findings.extend(check_rule_coverage(root))
    findings.extend(check_injection_site_coverage(root))
    findings.extend(check_env_doc_coverage(root))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def load_baseline(path: str) -> set[str]:
    """``<rule> <relpath>`` per line; '#' comments and blanks ignored."""
    out: set[str] = set()
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def run(root: str, baseline_path: str | None = None) -> int:
    """Lint ``root``; returns the number of non-baselined findings."""
    w = sys.stdout.write
    baseline = load_baseline(baseline_path) if baseline_path else set()
    findings = lint_package(root)
    fresh = [f for f in findings if f.baseline_key not in baseline]
    used = {f.baseline_key for f in findings} & baseline
    for f in fresh:
        w(f"{f}\n")
    stale = sorted(baseline - used)
    for key in stale:
        w(f"note: stale baseline entry (violation fixed — remove the "
          f"line): {key}\n")
    if baseline:
        w(
            f"warning: lint baseline is non-empty ({len(baseline)} "
            f"entr{'y' if len(baseline) == 1 else 'ies'}) — the legacy "
            f"debt was burned down; fix the site instead of baselining\n"
        )
    w(
        f"lint: {len(findings)} finding(s), {len(findings) - len(fresh)} "
        f"baselined, {len(fresh)} new\n"
    )
    return len(fresh)


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    baseline = None
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline = args[i + 1]
        del args[i: i + 2]
    if args:
        root = args[0]
    else:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if baseline is None:
        default = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "lint_baseline.txt"
        )
        baseline = default if os.path.exists(default) else None
    return 1 if run(root, baseline_path=baseline) else 0


if __name__ == "__main__":
    sys.exit(main())
