"""Common host-side types: mask types and forward side outputs."""

from .enum import AttnMaskType  # noqa: F401
from .forward_meta import AttnForwardMeta  # noqa: F401

__all__ = ["AttnForwardMeta", "AttnMaskType"]
