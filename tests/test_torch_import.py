"""The port stands alone: importing it, every submodule and chip_smoke.py's
imports loads neither jax nor the JAX package, and with no visible GPU its
entry points raise instead of quietly running on the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_jax_side(name: str) -> bool:
    # careful: "magiattention_tpu_torch" starts with "magiattention_tpu"
    return name in ("jax", "magiattention_tpu") or name.startswith(
        ("jax.", "jaxlib", "magiattention_tpu.")
    )


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def test_port_and_chip_smoke_import_no_jax():
    proc = _run(
        """
        import pkgutil, sys
        import magiattention_tpu_torch as port
        import chip_smoke
        for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            __import__(info.name)
        print("\\n".join(sorted(sys.modules)))
        """
    )
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "magiattention_tpu_torch.serving.engine" in loaded
    assert "chip_smoke" in loaded
    assert [m for m in loaded if _is_jax_side(m)] == []


def test_chip_smoke_names_no_jax_module():
    """chip_smoke.py imports the port inside its phases; no import
    statement anywhere in it may name jax or the JAX package."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "magiattention_tpu_torch.serving" in names
    assert [n for n in names if _is_jax_side(n)] == []


def test_entry_points_raise_without_a_gpu():
    proc = _run(
        """
        import torch
        from magiattention_tpu_torch import PagedKVCache, ToyModel
        assert not torch.cuda.is_available()
        for make in (
            lambda: ToyModel.create(),
            lambda: PagedKVCache.create(4, 16, 2, 16, 1, 2),
        ):
            try:
                make()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise SystemExit("ran on the CPU without being asked")
        ToyModel.create(device="cpu")  # asking for the CPU works
        print("ok")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
