"""Single-device attention entry points: ``flex_flash_attn_func`` and the
attention-sink math."""

from .flex_flash_attn import flex_flash_attn_func  # noqa: F401
from .sink import apply_sink_fwd, sink_bwd  # noqa: F401

__all__ = ["apply_sink_fwd", "flex_flash_attn_func", "sink_bwd"]
