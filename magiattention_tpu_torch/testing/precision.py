"""Dual-threshold closeness asserts (copy of magiattention_tpu/testing/precision.py).

``assert_close`` passes iff BOTH the relative-norm error is under
``norm_rtol`` AND the elementwise mismatch ratio (beyond atol/rtol) is under
``mismatch_thres`` — robust for low-precision kernels where a tiny fraction of
elements may exceed tight elementwise bounds. Inputs may be numpy arrays or
torch tensors (on any device).
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def rel_norm_err(a: np.ndarray, b: np.ndarray) -> float:
    denom = np.linalg.norm(b.astype(np.float64).ravel())
    if denom == 0.0:
        return float(np.linalg.norm(a.astype(np.float64).ravel()))
    return float(
        np.linalg.norm((a.astype(np.float64) - b.astype(np.float64)).ravel()) / denom
    )


def mismatch_ratio(
    a: np.ndarray, b: np.ndarray, atol: float, rtol: float
) -> float:
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    finite_mismatch = ~np.isclose(a64, b64, atol=atol, rtol=rtol, equal_nan=True)
    # -inf == -inf counts as a match (fully-masked lse rows)
    both_neginf = np.isneginf(a64) & np.isneginf(b64)
    mismatch = finite_mismatch & ~both_neginf
    return float(mismatch.mean()) if mismatch.size else 0.0


def assert_close(
    actual,
    expected,
    atol: float = 1e-5,
    rtol: float = 1e-5,
    norm_rtol: float = 1e-4,
    mismatch_thres: float = 0.0,
    msg: str = "",
) -> None:
    a = _np(actual)
    b = _np(expected)
    assert a.shape == b.shape, f"{msg}: shape {a.shape} != {b.shape}"

    finite = np.isfinite(b)
    if finite.any():
        nerr = rel_norm_err(
            np.where(finite, a, 0.0), np.where(finite, b, 0.0)
        )
    else:
        nerr = 0.0
    mratio = mismatch_ratio(a, b, atol, rtol)

    assert nerr <= norm_rtol and mratio <= mismatch_thres, (
        f"{msg}: rel-norm-err {nerr:.3e} (thres {norm_rtol:.1e}), "
        f"mismatch-ratio {mratio:.3e} (thres {mismatch_thres:.1e}, "
        f"atol={atol:.1e} rtol={rtol:.1e})"
    )
