"""Backend pins.

The port's copy of the pin the training slice reads from
``magiattention_tpu/env/backend.py``; the flag names are the same. A pin
is an explicit backend name, ``None`` when unset.
"""

from __future__ import annotations

import logging
import os

from .general import _get_str

logger = logging.getLogger("magiattention_tpu_torch.env.backend")

# legacy keys already warned about this process (one notice per key)
_warned_legacy: set[str] = set()


def _warn_legacy_once(legacy_key: str, new_key: str, mapped: str) -> None:
    if legacy_key in _warned_legacy:
        return
    _warned_legacy.add(legacy_key)
    logger.warning(
        "%s is deprecated as a direct kernel-choice flag; it now maps to "
        "the pin %s=%s.", legacy_key, new_key, mapped,
    )


def ffa_bwd_pin() -> str | None:
    """Pin for the split-vs-fused FFA backward: 'fused' | 'split' | None.

    MAGI_ATTENTION_BACKEND_FFA_BWD wins; legacy MAGI_ATTENTION_FFA_FUSED_BWD
    maps 1->fused, 0->split, auto->None."""
    val = _get_str("MAGI_ATTENTION_BACKEND_FFA_BWD", "").lower()
    if val in ("fused", "split"):
        return val
    legacy = os.environ.get("MAGI_ATTENTION_FFA_FUSED_BWD")
    if legacy in ("0", "1"):
        mapped = "fused" if legacy == "1" else "split"
        _warn_legacy_once(
            "MAGI_ATTENTION_FFA_FUSED_BWD", "MAGI_ATTENTION_BACKEND_FFA_BWD",
            mapped,
        )
        return mapped
    return None
