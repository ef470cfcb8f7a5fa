"""Testing support: precision asserts and the overlap-safety check."""

from .precision import assert_close, mismatch_ratio, rel_norm_err  # noqa: F401
from .template import assert_overlap_safe  # noqa: F401
