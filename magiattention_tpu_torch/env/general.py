"""General runtime toggles, read lazily on each call so tests can
monkeypatch ``os.environ``.

The port's copy of the few getters its serving slice needs from
``magiattention_tpu/env/general.py``; the flag names are the same.
"""

from __future__ import annotations

import os


def _get_bool(name: str, default: bool = False) -> bool:
    return os.environ.get(name, "1" if default else "0") == "1"


def _get_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _get_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def is_range_merge_enable() -> bool:
    """Merge band-compatible adjacent slices before kernel planning
    (kernels/ffa_plan.py build_ffa_plan -> mask_utils.merge_band_slices)."""
    return _get_bool("MAGI_ATTENTION_RANGE_MERGE", default=True)


class scoped_env:
    """Temporarily set/del environment variables, restoring on exit.
    Values of ``None`` unset the key."""

    def __init__(self, overrides: dict[str, str | None]) -> None:
        self._overrides = dict(overrides)
        self._saved: dict[str, str | None] = {}

    def __enter__(self) -> "scoped_env":
        for key, val in self._overrides.items():
            self._saved[key] = os.environ.get(key)
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = str(val)
        return self

    def __exit__(self, *exc) -> None:
        for key, old in self._saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
