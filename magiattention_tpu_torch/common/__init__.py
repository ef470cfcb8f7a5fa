"""Common host-side types: mask types, ranges and forward side outputs.

When ``MAGI_ATTENTION_CPP_BACKEND=1`` (default), ``AttnRange`` /
``AttnRanges`` resolve to the native host backend's classes
(``csrc_backend.CppAttnRange`` / ``CppAttnRanges``), as in the JAX
package; otherwise to the pure-Python ones. Both conform to
``common.protocols``.
"""

from .enum import AttnMaskType  # noqa: F401
from .forward_meta import AttnForwardMeta  # noqa: F401
from .range import AttnRange as _PyAttnRange
from .ranges import AttnRanges as _PyAttnRanges

AttnRange = _PyAttnRange
AttnRanges = _PyAttnRanges

from ..env import general as _env_general  # noqa: E402

if _env_general.is_cpp_backend_enable():
    from ..csrc_backend import CppAttnRange, CppAttnRanges  # noqa: E402

    AttnRange = CppAttnRange  # type: ignore[misc]
    AttnRanges = CppAttnRanges  # type: ignore[misc]

__all__ = ["AttnForwardMeta", "AttnMaskType", "AttnRange", "AttnRanges"]
