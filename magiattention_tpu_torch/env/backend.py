"""Backend pins.

The port's copy of the pins its slices read from
``magiattention_tpu/env/backend.py``; the flag names and values are the
same. A pin is an explicit backend name, ``None`` when unset; the backend
registry (``kernels/registry.py``) resolves every decision as pin >
in-process memo > heuristic. The JAX package's store and drift knobs
(MAGI_ATTENTION_BACKEND_STORE, _STORE_DIR, _DRIFT_THRESHOLD,
_CALIBRATION) configure its telemetry store, which the port does not have.
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


def kernel_backend_pin() -> str | None:
    """The MAGI_ATTENTION_KERNEL_BACKEND value as a registry pin: the
    explicit value when set, None when unset (the registry's heuristic
    supplies the default 'ffa')."""
    val = os.environ.get("MAGI_ATTENTION_KERNEL_BACKEND")
    return val.lower() if val else None


def mixed_blocks_pin() -> str | None:
    """Pin for mixed-granularity dispatch: 'mixed' | 'single' | None.

    MAGI_ATTENTION_BACKEND_MIXED_BLOCKS wins; legacy
    MAGI_ATTENTION_FFA_MIXED_BLOCKS maps 1->mixed (skip the profitability
    gate), 0->single, auto->None. A 'mixed' pin still degrades to single
    when the mask yields a trivial partition (``kernels/tile_policy.py:
    choose_mixed_dispatch``)."""
    val = _get_str("MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", "").lower()
    if val in ("mixed", "single"):
        return val
    legacy = os.environ.get("MAGI_ATTENTION_FFA_MIXED_BLOCKS")
    if legacy in ("0", "1"):
        mapped = "mixed" if legacy == "1" else "single"
        _warn_legacy_once(
            "MAGI_ATTENTION_FFA_MIXED_BLOCKS",
            "MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", mapped,
        )
        return mapped
    return None


def serve_decode_pin() -> str | None:
    """Pin for the serve decode rung: 'paged_decode_sharded' |
    'paged_decode_spec' | 'paged_decode_int8' | 'paged_decode' |
    'gather_ffa' | 'dense' | None.

    MAGI_ATTENTION_BACKEND_SERVE_DECODE wins; legacy
    MAGI_ATTENTION_SERVE_DECODE_KERNEL maps 1->paged_decode, 0->gather_ffa,
    auto->None. A pin stays subject to the call site's feasibility (cache
    dtype, 1-row vs multi-row step): an infeasible pin starts at the first
    feasible rung below it (``serving/decode.py``)."""
    val = _get_str("MAGI_ATTENTION_BACKEND_SERVE_DECODE", "").lower()
    if val in (
        "paged_decode_sharded",
        "paged_decode_spec",
        "paged_decode_int8",
        "paged_decode",
        "gather_ffa",
        "dense",
    ):
        return val
    legacy = os.environ.get("MAGI_ATTENTION_SERVE_DECODE_KERNEL")
    if legacy in ("0", "1"):
        mapped = "paged_decode" if legacy == "1" else "gather_ffa"
        _warn_legacy_once(
            "MAGI_ATTENTION_SERVE_DECODE_KERNEL",
            "MAGI_ATTENTION_BACKEND_SERVE_DECODE", mapped,
        )
        return mapped
    return None


def nsa_slc_pin() -> str | None:
    """Pin for the NSA selected-block branch: 'block_sparse_pallas' (the
    block-sparse kernels; the JAX package's value name, kept as the flag's
    public value) | 'gathered_dense' | None. No legacy key exists."""
    val = _get_str("MAGI_ATTENTION_BACKEND_NSA_SLC", "").lower()
    if val in ("block_sparse_pallas", "gathered_dense"):
        return val
    return None
