"""Env-flag combination generator (the port's copy of
``magiattention_tpu/testing/flag_generator.py``).

Iterates valid combinations of behavior-affecting env flags so tests cover
the flag matrix without exhaustive blowup. Strategies: constant (defaults
only), sequential (one flag varied at a time), random (seeded sampling),
heuristic (hand-picked high-risk combos).

The flag space is the JAX package's, key for key: the port reads every one
of these keys (``MAGI_ATTENTION_CPP_BACKEND`` and
``MAGI_ATTENTION_NATIVE_FFA_PLAN`` through the native host backend), with
the same candidate values, so one seed yields the JAX package's sequence.
"""

from __future__ import annotations

import random
from contextlib import contextmanager
from typing import Iterator

from ..env.general import scoped_env

# flag -> candidate values (None = unset)
FLAG_SPACE: dict[str, list[str | None]] = {
    "MAGI_ATTENTION_KERNEL_BACKEND": [None, "sdpa", "sdpa_online", "ffa"],
    "MAGI_ATTENTION_RANGE_MERGE": [None, "0", "1"],
    "MAGI_ATTENTION_FWD_HIGH_PRECISION_REDUCE": [None, "0", "1"],
    "MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE": [None, "0", "1"],
    "MAGI_ATTENTION_CPP_BACKEND": [None, "0", "1"],
    "MAGI_ATTENTION_NATIVE_FFA_PLAN": [None, "0", "1"],
    "MAGI_ATTENTION_FFA_GQA_PACK": [None, "0", "1"],
    "MAGI_ATTENTION_FFA_GQA_PACK_DQ": [None, "0", "1"],
    "MAGI_ATTENTION_FFA_AUTO_TILE": [None, "0", "1"],
}

HEURISTIC_COMBOS: list[dict[str, str]] = [
    {"MAGI_ATTENTION_KERNEL_BACKEND": "sdpa",
     "MAGI_ATTENTION_CPP_BACKEND": "0"},
    {"MAGI_ATTENTION_KERNEL_BACKEND": "ffa",
     "MAGI_ATTENTION_FWD_HIGH_PRECISION_REDUCE": "0"},
    {"MAGI_ATTENTION_KERNEL_BACKEND": "ffa",
     "MAGI_ATTENTION_BWD_HIGH_PRECISION_REDUCE": "1"},
    {"MAGI_ATTENTION_KERNEL_BACKEND": "ffa",
     "MAGI_ATTENTION_NATIVE_FFA_PLAN": "0"},
    # both GQA packs + auto-tile through the full pipeline at once
    {"MAGI_ATTENTION_KERNEL_BACKEND": "ffa",
     "MAGI_ATTENTION_FFA_GQA_PACK": "1",
     "MAGI_ATTENTION_FFA_GQA_PACK_DQ": "1",
     "MAGI_ATTENTION_FFA_AUTO_TILE": "1"},
]


class FlagCombGenerator:
    """Yields flag dicts; apply with :func:`with_flags`."""

    def __init__(self, strategy: str = "heuristic", seed: int = 0,
                 max_combos: int = 8) -> None:
        self.strategy = strategy
        self.seed = seed
        self.max_combos = max_combos

    def __iter__(self) -> Iterator[dict[str, str | None]]:
        if self.strategy == "constant":
            yield {}
        elif self.strategy == "sequential":
            yield {}
            for flag, values in FLAG_SPACE.items():
                for v in values:
                    if v is not None:
                        yield {flag: v}
        elif self.strategy == "random":
            rng = random.Random(self.seed)
            for _ in range(self.max_combos):
                combo = {}
                for flag, values in FLAG_SPACE.items():
                    v = rng.choice(values)
                    if v is not None:
                        combo[flag] = v
                yield combo
        elif self.strategy == "heuristic":
            yield {}
            yield from HEURISTIC_COMBOS
        else:
            raise ValueError(f"unknown strategy {self.strategy}")


@contextmanager
def with_flags(combo: dict[str, str | None]):
    """Temporarily apply a flag combination via env.general.scoped_env
    (the one sanctioned environment mutation point)."""
    with scoped_env(combo):
        yield
