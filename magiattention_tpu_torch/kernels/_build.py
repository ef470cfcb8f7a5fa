"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). Libraries go to ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc``.

Failures are typed, both ``RuntimeError`` subclasses: :class:`KernelBuildError`
(no ``nvcc``, or a source that does not compile), which no fallback ever
recovers, and :class:`KernelLaunchError` (a CUDA error a launch returned),
which the resilience layer's kernel ladder may.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..env import general as env_general

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (
    "ffa_fwd", "paged_decode", "ffa_bwd_delta", "ffa_bwd_dq", "ffa_bwd_dkv",
    "ffa_bwd_fused", "ffa_fwd_gqa", "ffa_bwd_dq_gqa", "paged_decode_spec",
    "paged_decode_int8", "block_sparse_fwd", "block_sparse_bwd",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel could not be built: ``nvcc`` is missing, or a source does
    not compile. Never recovered (a machine whose toolchain or sources are
    broken must fail loudly, not run the plain path)."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (a refused launch never runs).
    Carries the launch's ``code``."""

    def __init__(self, message: str, code: int) -> None:
        self.code = code
        super().__init__(message)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (env_general.cuda_home(), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by its source, the shared
    headers and the flags."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> None:
    """Compile every listed kernel that is not built yet, one ``nvcc`` per
    source, all started together. Raises with the compiler's output if any
    build fails. The ``ptxas -v`` report (registers, shared memory, spills)
    stays beside each library as ``<lib>.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        final = library_path(name)
        tmp = final.with_suffix(f".tmp{os.getpid()}.so")
        log = open(final.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, final, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT,
        )))
    failed = []
    for name, final, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, final)  # atomic: concurrent builds agree
        else:
            failed.append(
                f"{name}: nvcc exit {rc}\n"
                + final.with_suffix(".log").read_text()
            )
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.magi_error_string.argtypes = [ctypes.c_int]
        lib.magi_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise :class:`KernelLaunchError` if a launch returned a CUDA error (a
    refused launch never runs, and a later synchronize would not report
    it)."""
    if code != 0:
        msg = lib.magi_error_string(code).decode()
        raise KernelLaunchError(f"{what}: CUDA error {code} ({msg})", code)
