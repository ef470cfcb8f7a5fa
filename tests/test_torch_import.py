"""The port stands alone: importing it, every submodule and chip_smoke.py's
imports loads neither jax nor the JAX package, and with no visible GPU its
entry points raise instead of quietly running on the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

from tests import torch_port_cases  # noqa: F401  (caps torch's threads)

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
    for module in (
        "magiattention_tpu_torch.serving.engine",
        "magiattention_tpu_torch.models.llama",
        "magiattention_tpu_torch.functional.flex_flash_attn",
        "magiattention_tpu_torch.functional.sink",
        "magiattention_tpu_torch.kernels.sdpa_online",
        "magiattention_tpu_torch.common.enum",
        "magiattention_tpu_torch.common.forward_meta",
        "magiattention_tpu_torch.env.backend",
        "magiattention_tpu_torch.env.comm",
        "magiattention_tpu_torch.api.magi_attn_interface",
        "magiattention_tpu_torch.api.functools",
        "magiattention_tpu_torch.comm.primitives",
        "magiattention_tpu_torch.functional.dispatch",
        "magiattention_tpu_torch.functional.dist_attn",
        "magiattention_tpu_torch.functional.utils",
        "magiattention_tpu_torch.dist_attn_runtime_mgr",
        "magiattention_tpu_torch.config",
        "magiattention_tpu_torch.common.mask",
        "magiattention_tpu_torch.common.rectangle",
        "magiattention_tpu_torch.meta.solver.dispatch_solver",
        "magiattention_tpu_torch.meta.solver.dist_attn_solver",
        "magiattention_tpu_torch.meta.solver.overlap_solver",
        "magiattention_tpu_torch.meta.collection.comm_meta",
        "magiattention_tpu_torch.kernels.tile_policy",
        "magiattention_tpu_torch.kernels.registry",
        "magiattention_tpu_torch.utils.mem_budget",
        "magiattention_tpu_torch.kernels.ffa_plan",
        "magiattention_tpu_torch.kernels.paged_decode",
        "magiattention_tpu_torch.kernels.paged_kv",
        "magiattention_tpu_torch.serving.decode",
        "magiattention_tpu_torch.serving.reference",
        "magiattention_tpu_torch.serving.scheduler",
        "magiattention_tpu_torch.kernels.block_sparse",
        "magiattention_tpu_torch.parallel",
        "magiattention_tpu_torch.parallel.nsa",
        "magiattention_tpu_torch.parallel._mesh",
        "magiattention_tpu_torch.parallel._utils",
        "magiattention_tpu_torch.parallel.ring",
        "magiattention_tpu_torch.parallel.ulysses",
        "magiattention_tpu_torch.parallel.usp",
        "magiattention_tpu_torch.parallel.loongtrain",
        "magiattention_tpu_torch.parallel.hybrid",
        "magiattention_tpu_torch.comm.functional",
        "magiattention_tpu_torch.functional.dynamic_dist_attn",
        "magiattention_tpu_torch.functional.roll",
        "magiattention_tpu_torch.common.range_op",
        "magiattention_tpu_torch.meta.collection.dynamic_meta",
        "magiattention_tpu_torch.meta.solver.dynamic_attn_solver",
        "magiattention_tpu_torch.meta.solver.algorithms.binary_greedy",
        "magiattention_tpu_torch.meta.solver.algorithms.snf",
        "magiattention_tpu_torch.testing.template",
        "magiattention_tpu_torch.models.moe",
        "magiattention_tpu_torch.models.video_dit",
        "magiattention_tpu_torch.models.convert",
        "magiattention_tpu_torch.models.shard",
        "magiattention_tpu_torch.utils.sparse_utils",
        "magiattention_tpu_torch.utils.profiling",
        "magiattention_tpu_torch.env.health",
        "magiattention_tpu_torch.env.resilience",
        "magiattention_tpu_torch.telemetry",
        "magiattention_tpu_torch.telemetry.export",
        "magiattention_tpu_torch.telemetry.stats",
        "magiattention_tpu_torch.telemetry.registry",
        "magiattention_tpu_torch.telemetry.store",
        "magiattention_tpu_torch.telemetry.drift",
        "magiattention_tpu_torch.telemetry.health",
        "magiattention_tpu_torch.resilience.errors",
        "magiattention_tpu_torch.resilience.inject",
        "magiattention_tpu_torch.resilience.guards",
        "magiattention_tpu_torch.resilience.fallback",
        "magiattention_tpu_torch.resilience.watchdog",
        "magiattention_tpu_torch.analysis.lint",
        "magiattention_tpu_torch.analysis.kernel_check",
        "magiattention_tpu_torch.testing.ref_attn",
        "magiattention_tpu_torch.testing.gt_dispatcher",
        "magiattention_tpu_torch.testing.flag_generator",
        "magiattention_tpu_torch.testing.precompile",
        "magiattention_tpu_torch.common.protocols",
        "magiattention_tpu_torch.csrc_backend",
        "magiattention_tpu_torch.csrc_backend.build",
        "magiattention_tpu_torch.csrc_backend.ops",
        "magiattention_tpu_torch.csrc_backend.ranges",
        "magiattention_tpu_torch.benchmarking",
        "magiattention_tpu_torch.benchmarking.bench",
        "magiattention_tpu_torch.benchmarking.perf_report",
        "chip_smoke",
    ):
        assert module in loaded, module
    assert [m for m in loaded if _is_jax_side(m)] == []
    assert [m for m in loaded if m.split(".")[0] == "transformers"] == []


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
    assert "magiattention_tpu_torch.models.llama" in names
    assert "magiattention_tpu_torch.functional.dist_attn" in names
    assert [n for n in names if _is_jax_side(n)] == []


def test_entry_points_raise_without_a_gpu():
    proc = _run(
        """
        import torch
        from magiattention_tpu_torch import PagedKVCache, ToyModel, magi_attn_flex_key
        from magiattention_tpu_torch.models import LlamaConfig, init_params
        from magiattention_tpu_torch.models import params_from_numpy
        assert not torch.cuda.is_available()
        cfg = LlamaConfig(vocab_size=8, dim=8, n_layers=1, n_heads=2,
                          n_kv_heads=1, head_dim=4, ffn_hidden=8)
        for make in (
            lambda: ToyModel.create(),
            lambda: PagedKVCache.create(4, 16, 2, 16, 1, 2),
            lambda: PagedKVCache.create(4, 16, 2, 16, 1, 2, dtype=torch.int8),
            lambda: init_params(cfg),
            lambda: params_from_numpy(init_params(cfg, device="cpu")),
            lambda: magi_attn_flex_key([[0, 8]], [[0, 8]], [1], 8, 8),
        ):
            try:
                make()
            except RuntimeError as e:
                assert "device='cpu'" in str(e), e
            else:
                raise SystemExit("ran on the CPU without being asked")
        ToyModel.create(device="cpu")  # asking for the CPU works
        init_params(cfg, device="cpu")
        magi_attn_flex_key([[0, 8]], [[0, 8]], [1], 8, 8, device="cpu")
        print("ok")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
