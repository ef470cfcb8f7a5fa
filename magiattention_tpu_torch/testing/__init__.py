"""Testing support: precision asserts."""

from .precision import assert_close, mismatch_ratio, rel_norm_err  # noqa: F401
