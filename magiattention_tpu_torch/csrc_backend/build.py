"""Build the native host backend at first use and load it with ctypes.

``csrc/magi_host.cpp`` compiles with ``g++ -O3 -std=c++17 -shared -fPIC``
into ``MAGI_ATTENTION_JIT_CACHE_DIR`` (default ``build/host/`` at the root
of the checkout, listed in ``.gitignore``), named by a hash of the source,
so an edited source rebuilds and an unchanged one is reused.

The build is race-free across processes: it takes an exclusive file lock
beside the library, compiles to a name unique to the process and thread,
and moves the result into place with ``os.replace``; a process that waited
on the lock finds the library built. (The JAX package's build writes one
fixed ``.so.tmp``, which two concurrent builders can corrupt.)

Failures are typed: :class:`NativeBuildError` (no ``g++``, or a source that
does not compile or load), an ``ImportError`` so that the callers' Python
fallback catches it; it is memoized, so a missing toolchain is not retried
on every call. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..env import general as env_general

SRC = Path(__file__).resolve().parent.parent / "csrc" / "magi_host.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_ERR: ImportError | None = None  # memoized failure: never retry builds


class NativeBuildError(ImportError):
    """The native host backend could not be built or loaded (no ``g++``,
    a source that does not compile, an unloadable library). An
    ``ImportError``: every caller has a Python path to fall back to."""


def library_path() -> Path:
    """Where the library builds to: keyed by its source and flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return Path(env_general.jit_cache_dir()) / f"magi_host_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile to ``out`` under an exclusive lock; no-op when a process
    that held the lock first already built it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"g++ not found: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"native build failed (g++ exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """Build (once, cached by source hash) and load the native library;
    raises the memoized :class:`NativeBuildError` after a failure."""
    global _LIB, _LIB_ERR
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_ERR is not None:
            raise _LIB_ERR
        try:
            if not SRC.exists():
                raise NativeBuildError(f"native source missing: {SRC}")
            so = library_path()
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise NativeBuildError(f"native library unloadable: {e}") from e
            _declare(lib)
        except NativeBuildError as e:
            _LIB_ERR = e
            raise
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        get_lib()
    except ImportError:
        return False
    return True


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32p, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.magi_band_area.restype = i64
    lib.magi_band_area.argtypes = [i64] * 6
    lib.magi_chunk_areas.restype = None
    lib.magi_chunk_areas.argtypes = [i64p, i64, i64, i64, i64p]
    lib.magi_ranges_merge.restype = i64
    lib.magi_ranges_merge.argtypes = [i32p, i64, i32p]
    lib.magi_ranges_holes.restype = i64
    lib.magi_ranges_holes.argtypes = [i32p, i64, i32p, i64, i32p]
    lib.magi_ranges_overlap.restype = i64
    lib.magi_ranges_overlap.argtypes = [i32p, i64, i32p, i64, i32p]
    lib.magi_ranges_make_local.restype = i64
    lib.magi_ranges_make_local.argtypes = [i32p, i64, i32p, i64, i32p]
    lib.magi_minheap_solve.restype = None
    lib.magi_minheap_solve.argtypes = [i64p, i64, i64, i64, i32p]
    lib.magi_binary_greedy_solve.restype = ctypes.c_int32
    lib.magi_binary_greedy_solve.argtypes = [
        i64p, i64p, i64p, i64p, i64p, i32p, i32p,
        i64, i64, ctypes.c_double, i64, i32p,
    ]
    lib.magi_ffa_plan_count.restype = ctypes.c_int32
    lib.magi_ffa_plan_count.argtypes = [
        i32p, i32p, i32p, i32p, i64, i64, i64, i64, i64, i64p, i64p,
    ]
    lib.magi_ffa_plan_fill.restype = None
    lib.magi_ffa_plan_fill.argtypes = [
        i32p, i32p, i32p, i32p, i64, i64, i64, i64, i64,
        i64p, i64p, i64p, i64p,
        i32p, i32p, i32p, i32p, i32p, i32p,
    ]
