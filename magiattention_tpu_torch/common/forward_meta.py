"""Forward-pass side outputs (the port's copy of
``magiattention_tpu/common/forward_meta.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class AttnForwardMeta:
    """Side outputs returned by every attention call.

    Attributes:
        lse: log-sum-exp of attention logits, shape ``[seqlen_q, num_heads]``
            (float32), or None when not requested.
        max_logits: per-head max attention logit (float32), or None when not
            requested.
    """

    lse: Any = None
    max_logits: Any = None
