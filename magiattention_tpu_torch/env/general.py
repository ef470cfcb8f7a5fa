"""General runtime toggles, read lazily on each call so tests can
monkeypatch ``os.environ``.

The port's copy of the getters its slices need from
``magiattention_tpu/env/general.py``; the flag names are the same.
"""

from __future__ import annotations

import os


def _get_bool(name: str, default: bool = False) -> bool:
    return os.environ.get(name, "1" if default else "0") == "1"


def _get_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _get_float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


def _get_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def kernel_backend() -> str:
    """Attention kernel backend: ffa | sdpa | sdpa_online."""
    return _get_str("MAGI_ATTENTION_KERNEL_BACKEND", "ffa").lower()


def precision() -> str:
    """Precision override for attention compute: default | fp32 | bf16."""
    return _get_str("MAGI_ATTENTION_PRECISION", "default").lower()


def is_profile_mode_enable() -> bool:
    """Wrap hot-path functions and regions in profiler ranges
    (``utils/profiling.py``: ``torch.profiler.record_function``, plus an
    NVTX range on a card)."""
    return _get_bool("MAGI_ATTENTION_PROFILE_MODE")


def is_telemetry_enable() -> bool:
    """Record runtime telemetry (the ``telemetry`` package): dispatch
    balance, per-stage comm volumes, plan/step timings, cache stats,
    exported as JSONL. Off by default: the hot path reads no clock and
    writes no file."""
    return _get_bool("MAGI_ATTENTION_TELEMETRY")


def telemetry_dir() -> str:
    """Directory for telemetry JSONL files (one per writer,
    ``magiattention-<host>-<pid>-<token>.jsonl``)."""
    return _get_str("MAGI_ATTENTION_TELEMETRY_DIR", "telemetry")


def is_deterministic_mode_enable() -> bool:
    """MAGI_ATTENTION_DETERMINISTIC_MODE=1: the attention backward must be
    bitwise reproducible (the original MagiAttention's key). The JAX
    package needs no such key (its kernels run in a fixed order); the port
    keeps the guarantee by resolving the split FFA backward, which has no
    atomics (``kernels/ffa.py:ffa_bwd_mode``)."""
    return _get_bool("MAGI_ATTENTION_DETERMINISTIC_MODE")


def is_sanity_check_enable() -> bool:
    """Expensive invariant checks throughout solver/comm planning."""
    return _get_bool("MAGI_ATTENTION_SANITY_CHECK")


def runtime_dict_size() -> int:
    """LRU capacity of the runtime-manager cache."""
    return _get_int("MAGI_ATTENTION_RUNTIME_DICT_SIZE", 100)


def is_plan_cache_enable() -> bool:
    """Solved-plan cache one level below the runtime-manager LRU
    (dist_attn_runtime_mgr.py): a repeated mask signature skips the
    solvers. Reuse never changes which plan a signature gets, so this is
    not a runtime-cache-key flag."""
    return _get_bool("MAGI_ATTENTION_PLAN_CACHE", default=True)


def plan_cache_size() -> int:
    """LRU capacity of the solved-plan cache (entries = mask signatures)."""
    return _get_int("MAGI_ATTENTION_PLAN_CACHE_SIZE", 100)


def is_verify_plans_enable() -> bool:
    """Run the static plan verifier (``analysis/verifier.py``, R1-R5) at
    plan-build time and raise ``PlanVerificationError`` on error-severity
    violations. Plan time only, never on the step; it does not change
    which plan is built, so it is not a runtime-key flag."""
    return _get_bool("MAGI_ATTENTION_VERIFY_PLANS")


def is_plan_store_enable() -> bool:
    """The on-disk tier of the solved-plan cache (``meta/plan_store.py``):
    plans persist across processes and restarts in a shared directory,
    keyed by the plan signature's digest. Reuse is byte-exact (every load
    is checksum-checked and verified again, R1-R5), so like
    MAGI_ATTENTION_PLAN_CACHE this is not a runtime-key flag."""
    return _get_bool("MAGI_ATTENTION_PLAN_STORE")


def plan_store_dir() -> str:
    """Directory of the on-disk plan store (shared across processes)."""
    return _get_str("MAGI_ATTENTION_PLAN_STORE_DIR", "plan_store")


def min_chunks_per_rank() -> int:
    """Lower bound on dispatch chunks per rank when the chunk size is
    derived (api/magi_attn_interface.py ``_auto_chunk_size``)."""
    return _get_int("MAGI_ATTENTION_MIN_CHUNKS_PER_RANK", 4)


def is_range_merge_enable() -> bool:
    """Merge band-compatible adjacent slices before kernel planning
    (kernels/ffa_plan.py build_ffa_plan -> mask_utils.merge_band_slices)."""
    return _get_bool("MAGI_ATTENTION_RANGE_MERGE", default=True)


def is_incremental_solve_enable() -> bool:
    """Dynamic-solver incremental re-solve: diff the mask's rectangles
    against the previous solve's state (same mask family) and re-run the
    assignment algorithm only on changed rectangles
    (meta/solver/dynamic_attn_solver.py). It can give another plan than a
    cold solve, so it is part of the runtime cache key."""
    return _get_bool("MAGI_ATTENTION_INCREMENTAL_SOLVE", default=True)


def is_cpp_backend_enable() -> bool:
    """Use the native (C++) host backend (``csrc_backend/``: range algebra,
    band areas, the dispatch min-heap and binary-greedy solves) where it
    builds; Python where ``g++`` is missing. On by default, as in the JAX
    package."""
    return _get_bool("MAGI_ATTENTION_CPP_BACKEND", default=True)


def jit_cache_dir() -> str:
    """Where the native host backend's library is built
    (``csrc_backend/build.py``, keyed by a hash of its source): default
    ``build/host/`` at the root of the checkout."""
    default = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "build", "host",
    )
    return _get_str("MAGI_ATTENTION_JIT_CACHE_DIR", default)


def cuda_home() -> str | None:
    """The CUDA toolkit's root named by ``CUDA_HOME`` (where ``nvcc`` is
    looked for after PATH), or None. Not a MAGI_ key."""
    return os.environ.get("CUDA_HOME")


# flags that change numerics, planning output or the kernels a runtime runs,
# and so belong to every runtime cache key (the port's subset of the JAX
# package's ENV_KEYS_AFFECTING_RUNTIME)
ENV_KEYS_AFFECTING_RUNTIME: tuple[str, ...] = (
    "MAGI_ATTENTION_KERNEL_BACKEND",
    "MAGI_ATTENTION_PRECISION",
    "MAGI_ATTENTION_RANGE_MERGE",
    "MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE",
    "MAGI_ATTENTION_FWD_HIGH_PRECISION_REDUCE",
    "MAGI_ATTENTION_INCREMENTAL_SOLVE",
    "MAGI_ATTENTION_MIN_CHUNKS_PER_RANK",
    # the native host backend's band area, min-heap solve and FFA work lists
    # are array-equal to Python's, but its binary-greedy solve places tiles
    # by another cost (csrc/magi_host.cpp:bg_greedy), so dynamic plans differ
    "MAGI_ATTENTION_CPP_BACKEND",
    "MAGI_ATTENTION_QO_COMM",
    "MAGI_ATTENTION_HIERARCHICAL_COMM",
    "MAGI_ATTENTION_FFA_BLOCK_Q",
    "MAGI_ATTENTION_FFA_BLOCK_K",
    "MAGI_ATTENTION_FFA_BLOCK_Q_DQ",
    "MAGI_ATTENTION_FFA_BLOCK_K_DQ",
    "MAGI_ATTENTION_FFA_BLOCK_Q_DKV",
    "MAGI_ATTENTION_FFA_BLOCK_K_DKV",
    "MAGI_ATTENTION_FFA_AUTO_TILE",
    # the pack flags pick the packed forward and dq kernels (B2, B4;
    # registry.gqa_pack_variant); the dk/dv one selects the same kernel
    # either way in the port, but JAX's key carries it and a stored plan
    # binds to this snapshot, so the three flip keys and plans alike
    "MAGI_ATTENTION_FFA_GQA_PACK",
    "MAGI_ATTENTION_FFA_GQA_PACK_DQ",
    "MAGI_ATTENTION_FFA_GQA_PACK_DKV",
    # mixed dispatch (the legacy flag and the registry pin) changes which
    # plans and kernels a mask runs through ffa_attn (kernels/tile_policy.py)
    "MAGI_ATTENTION_FFA_MIXED_BLOCKS",
    "MAGI_ATTENTION_FFA_FUSED_BWD",
    "MAGI_ATTENTION_BACKEND_FFA_BWD",
    # the deterministic mode runs the split backward in place of the fused
    # one (kernels/ffa.py:ffa_bwd_mode): other kernels and other dq bits,
    # and a step payload's bwd_mode re-keys on a flip
    "MAGI_ATTENTION_DETERMINISTIC_MODE",
    "MAGI_ATTENTION_BACKEND_MIXED_BLOCKS",
    # NSA's selected branch: the block-sparse kernels or the gathered dense
    # reference (parallel/nsa.py through registry.nsa_slc_backend)
    "MAGI_ATTENTION_BACKEND_NSA_SLC",
    # the store and calibration let measured history steer kernel choice
    # and the tile policy's constants
    "MAGI_ATTENTION_BACKEND_STORE",
    "MAGI_ATTENTION_CALIBRATION",
    "MAGI_ATTENTION_RAGGED_GRPCOLL",
    "MAGI_ATTENTION_SPLIT_ALIGNMENT",
    # injection, fallback and the step watchdog change which plans and
    # kernels run, so a (possibly degraded) runtime is never shared across
    # their flips; NUMERIC_GUARD only reads, STRAGGLER_DETECT acts through
    # the capacity vector, which keys on its own
    "MAGI_ATTENTION_FAULT_INJECT",
    "MAGI_ATTENTION_FALLBACK",
    "MAGI_ATTENTION_STEP_RETRIES",
)


def snapshot_env() -> tuple[tuple[str, str | None], ...]:
    """Hashable snapshot of every behavior-affecting flag."""
    return tuple((k, os.environ.get(k)) for k in ENV_KEYS_AFFECTING_RUNTIME)


class scoped_env:
    """Temporarily set/del environment variables, restoring on exit.
    Values of ``None`` unset the key."""

    def __init__(self, overrides: dict[str, str | None]) -> None:
        self._overrides = dict(overrides)
        self._saved: dict[str, str | None] = {}

    def __enter__(self) -> "scoped_env":
        for key, val in self._overrides.items():
            self._saved[key] = os.environ.get(key)
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = str(val)
        return self

    def __exit__(self, *exc) -> None:
        for key, old in self._saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
