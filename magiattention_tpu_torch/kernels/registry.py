"""The backend registry: one selection point for every kernel-choice
decision of the port.

The port's counterpart of ``magiattention_tpu/kernels/registry.py``. Call
sites that read a pin resolve through :func:`resolve` instead:
``ffa_bwd_mode`` (``ffa_bwd``, MAGI_ATTENTION_BACKEND_FFA_BWD),
``gqa_pack_variant`` (the pack flags), ``tile_policy.choose_mixed_dispatch``
(``ffa_dispatch``, MAGI_ATTENTION_BACKEND_MIXED_BLOCKS), the serve decode
route (``serve_decode``), NSA's selected branch (``nsa_slc``) and the CP
runtime's backend (``calc_attn``, MAGI_ATTENTION_KERNEL_BACKEND), in this
order of precedence:

1. **pin**: an explicit env-derived choice (:mod:`..env.backend` maps the
   ``MAGI_ATTENTION_BACKEND_*`` keys and the legacy flags to pins),
   re-read on every call and subject only to the call site's feasibility
   guards (shared memory, compiled tiles, plan layout);
2. **memo**: the in-process resolution of the same (decision, key),
   the :data:`MEMO_SIZE` most recently used keys of each decision;
3. **heuristic**: the call site's default (a cost model or a constant),
   run at most once per key (``stats()["heuristic_calls"]``).

The JAX package's persistent policy store (its telemetry observatory,
sources ``policy`` and ``measured``) is not ported: those sources never
apply, which is the JAX package's own behaviour with the observatory off,
so every decision here is what that package resolves with it off. Nor is
the ``ffa_lowering`` decision: the port's kernels have one body per
dtype (no extent-clamped variant).

The rank-ordered registrations are the ladders, naming the port's
Hopper routes: ``ladder("serve_decode")`` is the order
``serving/decode.py:decode_route`` walks from its start rung.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

from ..env import backend as env_backend
from ..env import kernel as env_kernel


@dataclass(frozen=True)
class BackendChoice:
    name: str
    source: str  # "pin" | "heuristic"


# decision -> [(rank, name, description)], rank order = ladder order
_BACKENDS: dict[str, list[tuple[int, str, str]]] = {}


def register_backend(decision: str, name: str, rank: int, description: str = "") -> None:
    """Register a backend for a decision. Rank orders the ladder (0 =
    preferred, last = the most conservative reference)."""
    entries = _BACKENDS.setdefault(decision, [])
    entries[:] = [e for e in entries if e[1] != name]
    entries.append((rank, name, description))
    entries.sort()


def decisions() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def backends_for(decision: str) -> tuple[str, ...]:
    return tuple(name for _, name, _ in _BACKENDS.get(decision, ()))


def ladder(decision: str, start: str | None = None) -> tuple[str, ...]:
    """The rank-ordered ladder of a decision, from ``start`` when it is one
    of its backends (else the whole ladder)."""
    names = backends_for(decision)
    if start in names:
        return names[names.index(start):]
    return names


# resolutions the memo keeps per decision, least recently used dropped
# first: keys digest run geometry (``ffa_bwd``, ``ffa_dispatch``), and a
# trainer whose packing changes every step brings new ones each step
MEMO_SIZE = 512


class BackendRegistry:
    """The in-process resolution memo (an LRU of :data:`MEMO_SIZE` keys
    per decision) and its counts (one global instance)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._memo: dict[str, OrderedDict[Any, BackendChoice]] = {}
        self._last: dict[str, tuple[Any, str]] = {}
        self.stats: dict[str, int] = {
            "resolves": 0, "pins": 0, "memo_hits": 0, "heuristic_calls": 0,
        }

    def resolve(
        self, decision: str, key: Any, heuristic: Callable[[], str], pin: str | None = None,
    ) -> BackendChoice:
        with self._lock:
            self.stats["resolves"] += 1
            if pin is not None:
                self.stats["pins"] += 1
                self._last[decision] = (key, pin)
                return BackendChoice(pin, "pin")
            memo = self._memo.setdefault(decision, OrderedDict())
            hit = memo.get(key)
            if hit is not None:
                memo.move_to_end(key)
                self.stats["memo_hits"] += 1
                self._last[decision] = (key, hit.name)
                return hit
        choice = BackendChoice(heuristic(), "heuristic")
        with self._lock:
            self.stats["heuristic_calls"] += 1
            memo = self._memo.setdefault(decision, OrderedDict())
            memo[key] = choice
            memo.move_to_end(key)
            while len(memo) > MEMO_SIZE:
                memo.popitem(last=False)
            self._last[decision] = (key, choice.name)
        return choice

    def memo_size(self, decision: str) -> int:
        with self._lock:
            return len(self._memo.get(decision, ()))

    def last(self, decision: str) -> tuple[Any, str] | None:
        with self._lock:
            return self._last.get(decision)


_registry: BackendRegistry | None = None
_registry_lock = threading.Lock()


def get_registry() -> BackendRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = BackendRegistry()
        return _registry


def reset_registry() -> None:
    """Drop the in-process memo and counts (tests)."""
    global _registry
    with _registry_lock:
        _registry = None


def resolve(
    decision: str, key: Any, heuristic: Callable[[], str], pin: str | None = None,
) -> BackendChoice:
    """Resolve one decision for a hashable ``key``: the pin, else the memo,
    else ``heuristic()`` (memoized)."""
    return get_registry().resolve(decision, key, heuristic, pin=pin)


def stats() -> dict[str, int]:
    return dict(get_registry().stats)


def memo_size(decision: str) -> int:
    """Resolutions the memo holds for ``decision`` (at most :data:`MEMO_SIZE`)."""
    return get_registry().memo_size(decision)


def last_choice(decision: str) -> str | None:
    last = get_registry().last(decision)
    return None if last is None else last[1]


def last_key(decision: str) -> Any | None:
    last = get_registry().last(decision)
    return None if last is None else last[0]


# -- call-site conveniences (the env reads kernel code used to do) ----------


def calc_attn_backend(key: Any = ()) -> str:
    """The CP runtime's attention backend: MAGI_ATTENTION_KERNEL_BACKEND
    pins it, otherwise 'ffa'."""
    return resolve("calc_attn", key, lambda: "ffa", pin=env_backend.kernel_backend_pin()).name


def nsa_slc_backend(key: Any = ()) -> str:
    """NSA's selected-block branch: MAGI_ATTENTION_BACKEND_NSA_SLC pins it,
    otherwise the block-sparse kernels (B13/B14; the value keeps the JAX
    package's name ``block_sparse_pallas``)."""
    return resolve(
        "nsa_slc", key, lambda: "block_sparse_pallas", pin=env_backend.nsa_slc_pin(),
    ).name


def tiles_pinned() -> bool:
    """Explicit FFA tile settings present (env FFA_BLOCK_Q/K): auto-tile and
    mixed dispatch stand down, explicit settings always win."""
    return env_kernel.ffa_blocks_pinned()


def gqa_pack_variant(kind: str) -> str:
    """'gqa_packed' | 'plain' for the fwd / bwd-dq / bwd-dkv kernels. The
    pack flags are explicit opt-ins, so these decisions are always pinned;
    the call site's shared-memory and register guard applies on top. The
    port has one dk/dv kernel, which loops the group inside the CTA (the
    packed semantics), so "dkv" reads its flag and either value selects
    that kernel."""
    flags = {
        "fwd": (env_kernel.ffa_gqa_pack, "ffa_fwd"),
        "dq": (env_kernel.ffa_gqa_pack_dq, "ffa_bwd_dq"),
        "dkv": (env_kernel.ffa_gqa_pack_dkv, "ffa_bwd_dkv"),
    }
    if kind not in flags:
        raise ValueError(f"unknown gqa pack kind: {kind!r}")
    flag, decision = flags[kind]
    return resolve(decision, (), lambda: "plain", pin="gqa_packed" if flag() else "plain").name


# -- backend registrations: the port's routes --------------------------------

register_backend("calc_attn", "ffa", 0, "the FFA kernels (csrc/ffa_*.cu)")
register_backend("calc_attn", "sdpa", 1, "dense sdpa_attn, autograd")
register_backend("calc_attn", "sdpa_online", 2, "blockwise online-softmax reference")
register_backend("ffa_fwd", "plain", 0, "one q head a CTA (csrc/ffa_fwd.cu)")
register_backend("ffa_fwd", "gqa_packed", 1, "G heads of a kv head a CTA (csrc/ffa_fwd_gqa.cu)")
register_backend("ffa_bwd", "fused", 0, "one-pass dq/dk/dv (csrc/ffa_bwd_fused.cu)")
register_backend("ffa_bwd", "split", 1, "dq then dk/dv, no atomics (deterministic)")
register_backend("ffa_bwd_dq", "plain", 0, "one q head a CTA (csrc/ffa_bwd_dq.cu)")
register_backend("ffa_bwd_dq", "gqa_packed", 1, "G heads a CTA (csrc/ffa_bwd_dq_gqa.cu)")
register_backend("ffa_bwd_dkv", "gqa_packed", 0, "the group looped in the CTA (csrc/ffa_bwd_dkv.cu)")
register_backend("ffa_bwd_dkv", "plain", 1, "the same kernel")
register_backend("ffa_dispatch", "mixed", 0, "coarse + fine plans, lse-merged")
register_backend("ffa_dispatch", "single", 1, "one plan, one tiling")
register_backend("serve_decode", "paged_decode_spec", 1, "multi-row verify (csrc/paged_decode_spec.cu)")
register_backend("serve_decode", "paged_decode_int8", 2, "int8 pages (csrc/paged_decode_int8.cu)")
register_backend("serve_decode", "paged_decode", 3, "split page walk (csrc/paged_decode.cu)")
register_backend("serve_decode", "gather_ffa", 4, "per-slot gather + FFA (the replay oracle's call)")
register_backend("serve_decode", "dense", 5, "dense softmax, last resort")
register_backend("nsa_slc", "block_sparse_pallas", 0, "block-sparse kernels (csrc/block_sparse_*.cu)")
register_backend("nsa_slc", "gathered_dense", 1, "gathered dense reference")

# which env keys pin each decision (new BACKEND_* key first, legacy second)
PIN_KEYS: dict[str, tuple[str, ...]] = {
    "calc_attn": ("MAGI_ATTENTION_KERNEL_BACKEND",),
    "ffa_bwd": ("MAGI_ATTENTION_BACKEND_FFA_BWD", "MAGI_ATTENTION_FFA_FUSED_BWD"),
    "ffa_dispatch": (
        "MAGI_ATTENTION_BACKEND_MIXED_BLOCKS", "MAGI_ATTENTION_FFA_MIXED_BLOCKS",
    ),
    "serve_decode": (
        "MAGI_ATTENTION_BACKEND_SERVE_DECODE", "MAGI_ATTENTION_SERVE_DECODE_KERNEL",
    ),
    "ffa_fwd": ("MAGI_ATTENTION_FFA_GQA_PACK",),
    "ffa_bwd_dq": ("MAGI_ATTENTION_FFA_GQA_PACK_DQ",),
    "ffa_bwd_dkv": ("MAGI_ATTENTION_FFA_GQA_PACK_DKV",),
    "nsa_slc": ("MAGI_ATTENTION_BACKEND_NSA_SLC",),
}
