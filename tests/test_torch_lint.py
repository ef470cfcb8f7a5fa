"""The port's linter (``magiattention_tpu_torch/analysis/lint.py``) against
the JAX package's.

- A temporary tree with one seeded violation per rule: JAX's linter and
  the port's give the same findings (rule, file, line) for L001-L004 and
  L006, and every rule fires.
- L005 reads each package's own registry and chaos tests, so it has its own
  seeded case: a corpus that names no site flags every site; the port's
  corpus (``test_torch_resilience.py``, ``test_torch_plan_store.py``)
  names them all.
- The port's tree lints clean against its empty baseline, through the CLI
  too.
"""

import os
import subprocess
import sys
import textwrap

import pytest

from magiattention_tpu.analysis import lint as jlint
from magiattention_tpu_torch.analysis import lint as plint
from magiattention_tpu_torch.resilience.inject import INJECTION_SITES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROOT = os.path.join(REPO, "magiattention_tpu_torch")

SEEDED = {
    # L001 outside env/, and the allowed read inside it
    "kernels/reader.py": """
        import os
        from os import getenv

        def flag():
            return os.environ.get("MAGI_ATTENTION_X"), getenv("MAGI_ATTENTION_Y")
        """,
    "env/flags.py": """
        import os

        def x():
            return os.environ.get("MAGI_ATTENTION_SEEDED_UNDOCUMENTED", "0")

        def y():
            return os.environ.get("MAGI_ATTENTION_KERNEL_BACKEND", "ffa")
        """,
    # L002 in functional/, not outside it
    "functional/timed.py": """
        import time
        from time import perf_counter

        def step():
            return time.time() + perf_counter()
        """,
    "utils/timed.py": """
        import time

        def wall():
            return time.monotonic()
        """,
    # L003
    "api/noisy.py": """
        def hello():
            print("hello")
        """,
    # L004: an uncovered public dataclass, a covered one, a private one
    "meta/collection/plans.py": """
        from dataclasses import dataclass
        import dataclasses

        @dataclass(frozen=True)
        class SeededPlan:
            x: int

        @dataclasses.dataclass
        class DispatchMeta:
            y: int

        @dataclass
        class _Private:
            z: int
        """,
}


@pytest.fixture(scope="module")
def seeded_tree(tmp_path_factory):
    """A package tree with one seeded violation per rule, and a docs table
    that names one of its two env keys."""
    base = tmp_path_factory.mktemp("lint")
    root = base / "pkg"
    for rel, src in SEEDED.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    docs = base / "docs" / "env_variables.md"
    docs.parent.mkdir()
    docs.write_text("| `MAGI_ATTENTION_KERNEL_BACKEND` | `ffa` | the backend |\n")
    return str(root), str(docs)


def _keys(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


def _file_findings(mod, root):
    out = []
    for path in mod._iter_py_files(root):
        out += mod.lint_file(path, os.path.relpath(path, root))
    return out


@pytest.mark.parametrize("rule", ["MAGI-L001", "MAGI-L002", "MAGI-L003", "MAGI-L004", "MAGI-L006"])
def test_seeded_tree_findings_equal_jax(seeded_tree, rule):
    root, docs = seeded_tree
    got, want = [], []
    for mod, out in ((plint, got), (jlint, want)):
        out += _file_findings(mod, root)
        out += mod.check_rule_coverage(root)
        out += mod.check_env_doc_coverage(root, docs)
    got = [f for f in got if f.rule == rule]
    want = [f for f in want if f.rule == rule]
    assert got, rule
    assert _keys(got) == _keys(want)


def test_seeded_findings_are_the_seeded_sites(seeded_tree):
    root, docs = seeded_tree
    found = _keys(_file_findings(plint, root) + plint.check_rule_coverage(root)
                  + plint.check_env_doc_coverage(root, docs))
    assert [(r, p) for r, p, _ in found] == sorted([
        ("MAGI-L001", "kernels/reader.py"), ("MAGI-L001", "kernels/reader.py"),
        ("MAGI-L002", "functional/timed.py"), ("MAGI-L002", "functional/timed.py"),
        ("MAGI-L003", "api/noisy.py"), ("MAGI-L004", "meta/collection/plans.py"),
        ("MAGI-L006", "env/flags.py"),
    ])


def test_l005_flags_every_site_a_corpus_does_not_name(tmp_path):
    empty = tmp_path / "chaos.py"
    empty.write_text("# no site named here\n")
    flagged = plint.check_injection_site_coverage(PORT_ROOT, corpus_files=(str(empty),))
    assert sorted(f.message.split("'")[1] for f in flagged) == sorted(INJECTION_SITES)
    one = tmp_path / "one.py"
    one.write_text(f"SITE = {INJECTION_SITES[0]!r}\n")
    flagged = plint.check_injection_site_coverage(PORT_ROOT, corpus_files=(str(one),))
    assert len(flagged) == len(INJECTION_SITES) - 1


def test_l005_corpus_names_every_site():
    assert plint.CHAOS_TESTS == ("tests/test_torch_resilience.py", "tests/test_torch_plan_store.py")
    assert plint.check_injection_site_coverage(PORT_ROOT) == []


def test_port_tree_lints_clean_against_its_empty_baseline(capsys):
    baseline = os.path.join(PORT_ROOT, "analysis", "lint_baseline.txt")
    assert os.path.exists(baseline) and plint.load_baseline(baseline) == set()
    assert plint.lint_package(PORT_ROOT) == []
    assert plint.run(PORT_ROOT, baseline) == 0
    assert "0 new" in capsys.readouterr().out


def test_cli_exits_zero_on_the_port():
    proc = subprocess.run([sys.executable, "-m", "magiattention_tpu_torch.analysis.lint"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: 0 finding(s)" in proc.stdout


def test_cli_fails_on_the_seeded_tree(seeded_tree):
    root, _ = seeded_tree
    assert plint.main([root]) == 1
