"""The Hopper kernel contract checker (rules K1, K3, K5): the port's
counterpart of ``magiattention_tpu/analysis/kernel_check.py``.

The JAX package intercepts every ``pl.pallas_call`` and checks its grid,
BlockSpecs and scratch. The port has no such site: its kernels are plain C
entries of the libraries ``csrc/<name>.cu`` builds, so the contract is
each library's C interface and the host plan that feeds it.

- **K1, shared memory.** Every instance's dynamic shared memory comes from
  one host model (``utils/mem_budget.py``: ``ffa_smem_bytes`` /
  ``compiled_tiles`` for the FFA libraries, ``decode_smem_bytes`` for
  B10-B12, ``block_sparse_smem_bytes`` for B13/B14) and must fit one CTA's
  opt-in limit (``SMEM_PER_CTA``, 232,448 bytes on the H100)
  (:func:`check_k1`, on the CPU). On the card each library's
  ``<name>_smem_bytes`` export must equal the model for every instance,
  and be 0 where the instance is not compiled
  (:func:`check_k1_libraries`; ``chip_smoke.py`` phases ``tiles_smem``
  and ``kernel_audit``).
- **K3, work-list bounds over host plans** (on the CPU): every FFA work row
  lies inside its tile grid and its slice, runs are contiguous with their
  first/last flags, and the k-major list is the q-major one transposed
  (:func:`check_k3_ffa_plan`); every decode call's page table names pages
  inside the pool and its split walk covers each slot's tokens exactly
  once (:func:`check_k3_decode`); every NSA key table names blocks inside
  the key length and expands every chunk entry once for each key tile it
  overlaps (:func:`check_k3_key_table`). :func:`corpus` is the verifier's
  corpus (causal, two documents, a sliding window at cp 1, 2, 4 and the
  (2, 2) mesh, static and dynamic plans) plus seeded decode and NSA
  tables.
- **K5, env keys** (:func:`check_env_keys`): every ``MAGI_*`` key read
  under ``kernels/`` is in ``ENV_KEYS_AFFECTING_RUNTIME`` or on
  :data:`K5_ALLOWLIST`, each entry with its proof.

K2 and K4 are about Pallas's sequential grid (accumulators zero-initialised
under the first visit, stored once under the last) and ``dot_general``
precision. Their Hopper counterparts are checked on the card, not here:
the accumulator discipline by the SASS checks (``chip_smoke.py`` phase
``tensor_cores``: no atomic in a split, deterministic library; phase
``decode_sass``: the decode walks' loads), by the fused backward's dq
accumulator, zeroed before its atomics and converted once
(``ffa_bwd_fused``, checked against the plain version in phase
``ffa_bwd_fused``), and by the bitwise runs of phase ``deterministic``;
the precision by each kernel against its plain version (every kernel
phase) and the float32 forward's 3xTF32 against float64 (phases
``ffa_fwd``, ``tf32_probe``).

CLI: ``python -m magiattention_tpu_torch.analysis.kernel_check`` runs K1
(host), K3 and K5 over the corpus and exits 1 on an error.
"""

from __future__ import annotations

import ast
import ctypes
import re
import sys
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..kernels.ffa_plan import (
    DHI, DLO, EK0, EK1, EQ0, EQ1, IS_FIRST, IS_LAST, KE, KS, QE, QS, QVF, QVL, FFAPlan,
)
from ..utils import mem_budget as mb
from .violation import ERROR, VerifyReport

__all__ = [
    "K5_ALLOWLIST",
    "SmemInstance",
    "check_env_keys",
    "check_k1",
    "check_k1_libraries",
    "check_k3_decode",
    "check_k3_ffa_plan",
    "check_k3_key_table",
    "consumed_env_keys",
    "corpus",
    "run_kernel_audit",
    "smem_instances",
]

# env keys read under kernels/ that are proven not to change what a
# runtime computes, exempt from ENV_KEYS_AFFECTING_RUNTIME (K5); each entry
# carries its proof
K5_ALLOWLIST: dict[str, str] = {
    "MAGI_ATTENTION_NATIVE_FFA_PLAN": (
        "selects the native (C) or the Python FFA work-list builder; both "
        "emit the same arrays (array-equal, tests/test_torch_native_host.py "
        "and chip_smoke.py phase native_host), so no kernel input differs"
    ),
}

# ---------------------------------------------------------------------------
# K1: shared memory
# ---------------------------------------------------------------------------

FFA_LIBRARIES = {
    "ffa_fwd": "fwd", "ffa_bwd_dq": "dq", "ffa_bwd_dkv": "dkv", "ffa_bwd_fused": "fused",
    "ffa_fwd_gqa": "fwd_gqa", "ffa_bwd_dq_gqa": "dq_gqa",
}
DECODE_LIBRARIES = ("paged_decode", "paged_decode_spec", "paged_decode_int8")
BSP_LIBRARIES = ("block_sparse_fwd", "block_sparse_bwd")
LIBRARIES = (*FFA_LIBRARIES, *DECODE_LIBRARIES, *BSP_LIBRARIES)
# head dims queried: every compiled width and one with no instance
QUERY_DIMS = (64, 96, 128, 256)
SPEC_ROWS = (1, 8, 9, 16, 17, 32, 33)


@dataclass(frozen=True)
class SmemInstance:
    """One query of a library's ``<library>_smem_bytes``: its arguments
    (the bf16 flag last) and the model's bytes (0: not compiled)."""

    library: str
    args: tuple[int, ...]
    model: int

    @property
    def tag(self) -> str:
        return f"{self.library}{self.args}"


def _ffa_instances(lib: str) -> list[SmemInstance]:
    kernel = FFA_LIBRARIES[lib]
    packed = kernel.endswith("_gqa")
    out = []
    for isz in (2, 4):
        for d in (64, 128, 256):
            for heads in ((2, 4) if packed else (1,)):
                for bq, bk in mb.TILE_PAIRS:
                    on = mb.is_compiled(kernel, isz, d, bq, bk, heads)
                    model = mb.ffa_smem_bytes(kernel, d, bq, bk, isz, heads) if on else 0
                    args = (d, heads, bq, bk) if packed else (d, bq, bk)
                    out.append(SmemInstance(lib, (*args, int(isz == 2)), model))
    return out


def smem_instances(libraries=LIBRARIES) -> list[SmemInstance]:
    """Every instance query of ``libraries`` with its model's bytes."""
    out: list[SmemInstance] = []
    for lib in libraries:
        if lib in FFA_LIBRARIES:
            out += _ffa_instances(lib)
            continue
        for d in QUERY_DIMS:
            for bf16 in (1, 0):
                isz = 2 if bf16 else 4
                if lib == "paged_decode":
                    out.append(SmemInstance(lib, (d, bf16), mb.decode_smem_bytes(d, isz, 8)))
                elif lib == "paged_decode_int8":
                    out.append(SmemInstance(lib, (d, bf16), mb.decode_smem_bytes(d, 1, 8)))
                elif lib == "paged_decode_spec":
                    for rows in SPEC_ROWS:
                        rmax = mb.decode_rmax(rows)
                        model = mb.decode_smem_bytes(d, isz, rmax) if rmax else 0
                        out.append(SmemInstance(lib, (d, rows, bf16), model))
                elif lib == "block_sparse_fwd":
                    out.append(SmemInstance(lib, (d, bf16), mb.block_sparse_smem_bytes("fwd", d, isz)))
                elif lib == "block_sparse_bwd":
                    for dkv in (0, 1):
                        kind = "dkv" if dkv else "dq"
                        out.append(SmemInstance(
                            lib, (d, dkv, bf16), mb.block_sparse_smem_bytes(kind, d, isz)))
                else:
                    raise ValueError(f"unknown kernel library {lib!r}")
    return out


def check_k1(report: VerifyReport, limit: int = mb.SMEM_PER_CTA,
             instances: list[SmemInstance] | None = None) -> None:
    """K1 on the host: every compiled instance's model fits ``limit``."""
    report.mark_run("K1")
    for inst in smem_instances() if instances is None else instances:
        if inst.model > limit:
            report.add("K1", ERROR, inst.tag,
                       f"{inst.model} bytes of shared memory exceed a CTA's {limit}")


def library_query(lib: str):
    """``args -> bytes`` of the built library's ``<lib>_smem_bytes`` (on
    the card: builds the library first)."""
    from ..kernels import _build

    fn = getattr(_build.library(lib), f"{lib}_smem_bytes")
    fn.restype = ctypes.c_long

    def query(*args: int) -> int:
        fn.argtypes = [ctypes.c_int] * len(args)
        return int(fn(*args))

    return query


def check_k1_libraries(report: VerifyReport, libraries=LIBRARIES, query=None,
                       limit: int | None = None) -> dict:
    """K1 against the libraries: each ``<lib>_smem_bytes`` equals the
    model for every instance (0 where not compiled), and every compiled
    instance fits ``limit`` (the card's opt-in limit; default the model's
    budget). ``query(lib)`` gives the export (default
    :func:`library_query`). Returns a summary: instances checked, the
    compiled ones by library and tag, each library's largest CTA."""
    report.mark_run("K1")
    limit = mb.SMEM_PER_CTA if limit is None else limit
    query = library_query if query is None else query
    checked, compiled, largest = 0, {}, {}
    for lib in libraries:
        fn = query(lib)
        for inst in smem_instances((lib,)):
            got = fn(*inst.args)
            checked += 1
            if got != inst.model:
                report.add("K1", ERROR, inst.tag,
                           f"library reports {got} bytes of shared memory, the model {inst.model}")
            if inst.model:
                compiled.setdefault(lib, []).append(inst.args)
                largest[lib] = max(largest.get(lib, 0), inst.model)
                if inst.model > limit:
                    report.add("K1", ERROR, inst.tag,
                               f"{inst.model} bytes exceed the card's {limit} a CTA")
    return dict(checked=checked, compiled={k: len(v) for k, v in compiled.items()},
                largest=largest, limit=limit, instances=compiled)


# ---------------------------------------------------------------------------
# K3: work-list bounds over host plans
# ---------------------------------------------------------------------------


def _check_runs(report, site, tiles, ptr, meta, n_tiles, major) -> None:
    n = len(tiles)
    if len(ptr) != n_tiles + 1 or ptr[0] != 0 or ptr[-1] != n or np.any(np.diff(ptr) < 1):
        report.add("K3", ERROR, f"{site} {major}-major runs",
                   f"run offsets {ptr.tolist()[:8]}... do not split {n} items into {n_tiles} runs")
        return
    want = np.repeat(np.arange(n_tiles), np.diff(ptr))
    if not np.array_equal(tiles, want):
        report.add("K3", ERROR, f"{site} {major}-major runs", "a run holds items of another tile")
    first = np.zeros(n, bool)
    first[ptr[:-1]] = True
    last = np.zeros(n, bool)
    last[ptr[1:] - 1] = True
    if not (np.array_equal(meta[:, IS_FIRST] == 1, first) and np.array_equal(meta[:, IS_LAST] == 1, last)):
        report.add("K3", ERROR, f"{site} {major}-major runs",
                   "IS_FIRST / IS_LAST do not mark each run's ends")


def check_k3_ffa_plan(report: VerifyReport, plan: FFAPlan, seqlen_q: int, seqlen_k: int,
                      site: str = "plan") -> None:
    """K3 over one FFA plan: every item's tiles inside the grid, its slice
    inside the sequences, the tile meeting the slice, its live extent
    inside the tile, runs contiguous with their flags, the q-visit flags
    0/1, and the k-major list the q-major one's real items transposed."""
    report.mark_run("K3")
    bq, bk, nq, nk = plan.block_q, plan.block_k, plan.num_q_tiles, plan.num_k_tiles
    if nq * bq < seqlen_q or nk * bk < seqlen_k:
        report.add("K3", ERROR, site, f"grid {nq}x{nk} of {bq}x{bk} tiles misses {seqlen_q}x{seqlen_k}")
    for major, qt, kt, meta, ptr, tiles, n_tiles in (
        ("q", plan.work_qt, plan.work_kt, plan.meta, plan.run_ptr, plan.work_qt, nq),
        ("k", plan.work_qt_t, plan.work_kt_t, plan.meta_t, plan.run_ptr_t, plan.work_kt_t, nk),
    ):
        where = f"{site} {major}-major"
        if np.any((qt < 0) | (qt >= nq)) or np.any((kt < 0) | (kt >= nk)):
            report.add("K3", ERROR, where, "a work row's tile lies outside the grid")
            continue
        _check_runs(report, site, tiles, ptr, meta, n_tiles, major)
        real = (meta[:, QE] > meta[:, QS]) & (meta[:, KE] > meta[:, KS])
        m, q0, k0 = meta[real], qt[real] * bq, kt[real] * bk
        if np.any((m[:, QS] < 0) | (m[:, QE] > seqlen_q) | (m[:, KS] < 0) | (m[:, KE] > seqlen_k)):
            report.add("K3", ERROR, where, "a work row's slice lies outside the sequences")
        if np.any((m[:, QS] >= q0 + bq) | (m[:, QE] <= q0) | (m[:, KS] >= k0 + bk) | (m[:, KE] <= k0)):
            report.add("K3", ERROR, where, "a work row's tile does not meet its slice")
        if np.any(m[:, DLO] > m[:, DHI]):
            report.add("K3", ERROR, where, "a work row's band is empty")
        ext = meta[real][:, [EQ0, EQ1, EK0, EK1]]
        if np.any((ext[:, 0] < 0) | (ext[:, 1] > bq) | (ext[:, 2] < 0) | (ext[:, 3] > bk)):
            report.add("K3", ERROR, where, "a work row's live extent lies outside its tile")
        if np.any(~np.isin(meta[:, [QVF, QVL]], (0, 1))):
            report.add("K3", ERROR, where, "a q-visit flag is neither 0 nor 1")
    rows = []
    for qt, kt, meta in ((plan.work_qt, plan.work_kt, plan.meta),
                         (plan.work_qt_t, plan.work_kt_t, plan.meta_t)):
        real = (meta[:, QE] > meta[:, QS]) & (meta[:, KE] > meta[:, KS])
        cols = np.column_stack([qt[real], kt[real], meta[real][:, [QS, QE, KS, KE, DLO, DHI]]])
        rows.append(cols[np.lexsort(cols.T[::-1])] if len(cols) else cols)
    if rows[0].shape != rows[1].shape or not np.array_equal(rows[0], rows[1]):
        report.add("K3", ERROR, site, "the k-major list is not the q-major list transposed")


def check_k3_decode(report: VerifyReport, table: np.ndarray, lengths: np.ndarray,
                    num_pages: int, page_size: int, splits: int, split_len: int,
                    site: str = "decode") -> None:
    """K3 over one decode call: every live page of each slot's table row
    lies inside the pool of ``num_pages``, each slot's length fits its
    row, and the split walk (``decode_split_plan``: split ``z`` owns tokens
    ``[z * split_len, (z + 1) * split_len)``, in whole 32-token chunks)
    covers every slot's tokens exactly once."""
    report.mark_run("K3")
    S, P = table.shape
    if np.any(lengths < 0) or np.any(lengths > P * page_size):
        report.add("K3", ERROR, site, f"a slot's length exceeds its {P} pages of {page_size}")
    live = np.arange(P)[None, :] * page_size < lengths[:, None]
    if np.any((table < 0)[live] | (table >= num_pages)[live]):
        report.add("K3", ERROR, site, f"a live page lies outside the pool of {num_pages}")
    if split_len % mb.DECODE_CHUNK or splits < 1:
        report.add("K3", ERROR, site, f"splits {splits} x {split_len} is not whole chunks")
        return
    starts = np.arange(splits) * split_len
    for s in range(S):
        n = int(lengths[s])
        cover = np.zeros(n, np.int64)
        for z0 in starts:
            cover[z0:min(z0 + split_len, n)] += 1
        if np.any(cover != 1):
            report.add("K3", ERROR, f"{site} slot {s}",
                       f"the split walk covers its {n} tokens {sorted(set(cover.tolist()))} times")


def check_k3_key_table(report: VerifyReport, ctbl: np.ndarray, table, seq: int, ds: int,
                       site: str = "nsa") -> None:
    """K3 over one NSA key table (``kernels/block_sparse.py:key_table``) of
    chunk table ``ctbl`` ``(hk, n_qb, C)``: chunks and key tiles inside the
    key length, the order a permutation of the (kv head, key tile) pairs,
    visits' q blocks inside the table, and every entry counted once for
    each key tile its chunk overlaps."""
    report.mark_run("K3")
    hk, n_qb, _ = ctbl.shape
    n_chunks = -(-seq // ds)
    if np.any((ctbl < 0) | (ctbl >= n_chunks)):
        report.add("K3", ERROR, site, f"a chunk entry lies outside the {n_chunks} chunks")
        return
    order, ptr = table.order.cpu().numpy(), table.ptr.cpu().numpy()
    qblock, mult = table.qblock.cpu().numpy(), table.mult.cpu().numpy()
    pairs, tile = hk * table.n_tiles, 64
    if table.n_tiles != -(-seq // tile) or not np.array_equal(np.sort(order), np.arange(pairs)):
        report.add("K3", ERROR, site, "the walk's order is not a permutation of the key-tile pairs")
    if len(ptr) != pairs + 1 or ptr[0] != 0 or np.any(np.diff(ptr) < 0):
        report.add("K3", ERROR, site, "the visit offsets are not monotone")
        return
    n = int(ptr[-1])
    if np.any((qblock[:n] < 0) | (qblock[:n] >= n_qb)):
        report.add("K3", ERROR, site, "a visit's q block lies outside the table")
        return
    # every visit's (kv head, chunk, key tile, q block) multiplicities
    # against each entry expanded over the key tiles its chunk overlaps
    got: Counter = Counter()
    for p in range(pairs):
        h, t = divmod(p, table.n_tiles)
        for row in range(int(ptr[p]), int(ptr[p + 1])):
            for m in np.nonzero(mult[row])[0]:
                got[(h, t * tile // ds + int(m), t, int(qblock[row]))] += int(mult[row, m])
    want: Counter = Counter()
    for (h, b, _), c in zip(np.ndindex(ctbl.shape), ctbl.ravel().tolist()):
        for t in range(c * ds // tile, (min((c + 1) * ds, seq) - 1) // tile + 1):
            want[(int(h), c, t, int(b))] += 1
    if got != want:
        wrong = sorted((got - want) + (want - got))[:3]
        report.add("K3", ERROR, site,
                   f"the visits do not name each entry once a key tile it overlaps: {wrong}")


# ---------------------------------------------------------------------------
# K5: env keys
# ---------------------------------------------------------------------------

_ENV_KEY = re.compile(r"MAGI_[A-Z0-9_]+")


def _callee_name(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _env_getter_keys(env_dir: Path) -> dict[str, set[str]]:
    """getter function name -> the env keys it reads, from env/*.py."""
    getters: dict[str, set[str]] = {}
    for path in sorted(env_dir.glob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, ast.FunctionDef):
                keys = {
                    node.value for node in ast.walk(fn)
                    if isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and _ENV_KEY.fullmatch(node.value)
                }
                if keys:
                    getters.setdefault(fn.name, set()).update(keys)
    return getters


def consumed_env_keys(kernels_dir: Path | None = None, env_dir: Path | None = None) -> dict[str, set[str]]:
    """env key -> the ``kernels/`` files reading it (a ``MAGI_*`` literal
    passed to a call, or a call of an ``env/`` getter that reads it)."""
    kroot = Path(kernels_dir) if kernels_dir else Path(__file__).resolve().parent.parent / "kernels"
    eroot = Path(env_dir) if env_dir else kroot.parent / "env"
    getters = _env_getter_keys(eroot)
    consumed: dict[str, set[str]] = {}
    for path in sorted(kroot.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            for key in getters.get(_callee_name(node.func), ()):
                consumed.setdefault(key, set()).add(path.name)
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and _ENV_KEY.fullmatch(arg.value):
                    consumed.setdefault(arg.value, set()).add(path.name)
    return consumed


def check_env_keys(report: VerifyReport, consumed: dict[str, set[str]] | None = None,
                   listed: tuple[str, ...] | None = None,
                   allowlist: dict[str, str] | None = None) -> None:
    """K5: every env key read under ``kernels/`` is in
    ``ENV_KEYS_AFFECTING_RUNTIME`` or on the allowlist with its proof."""
    report.mark_run("K5")
    if consumed is None:
        consumed = consumed_env_keys()
    if listed is None:
        from ..env.general import ENV_KEYS_AFFECTING_RUNTIME

        listed = ENV_KEYS_AFFECTING_RUNTIME
    allowlist = K5_ALLOWLIST if allowlist is None else allowlist
    for key in sorted(consumed):
        if key not in listed and key not in allowlist:
            report.add(
                "K5", ERROR, f"kernels/ ({', '.join(sorted(consumed[key]))})",
                f"env key {key} is read by the kernels' code but is missing from "
                "ENV_KEYS_AFFECTING_RUNTIME: cached runtimes would be shared across its flips",
            )


# ---------------------------------------------------------------------------
# the corpus and the audit
# ---------------------------------------------------------------------------

SEQ, CHUNK = 512, 32


def _masks() -> dict[str, tuple]:
    """The verifier's masks over :data:`SEQ` tokens: causal, two causal
    documents, a sliding window of 64 keys."""
    from ..api.functools import infer_attn_mask_from_cu_seqlens

    qr, kr, types = infer_attn_mask_from_cu_seqlens([0, SEQ], causal=False, window_size=(64, 0))
    return {
        "causal": ([[0, SEQ]], [[0, SEQ]], [1]),
        "two_docs": ([[0, 256], [256, SEQ]], [[0, 256], [256, SEQ]], [1, 1]),
        "window": ([list(map(int, r)) for r in qr.to_naive_ranges()],
                   [list(map(int, r)) for r in kr.to_naive_ranges()],
                   [int(t.to_int_type()) for t in types]),
    }


def _ffa_cases() -> list[tuple]:
    """(site, q_ranges, k_ranges, d_lo, d_hi, seqlen_q, seqlen_k) of every
    rank's kernel call in the verifier's corpus: the static plans at cp 1,
    2, 4 and the (2, 2) mesh (overlap degree 2: host part, each stage's
    remote part, the merged call) and the dynamic plans at cp 2, 4."""
    from ..common.enum import AttnMaskType
    from ..common.ranges import AttnRanges
    from ..config import DistAttnConfig, OverlapConfig
    from ..meta import make_attn_meta_from_dispatch_meta, make_dispatch_meta_from_qk_ranges
    from ..meta._make_attn_meta import make_dynamic_attn_plan

    cases = []
    for name, (qr, kr, types) in _masks().items():
        q, k = AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr)
        tmap = [AttnMaskType.from_int_type(t) for t in types]
        for cp, mesh in ((1, None), (2, None), (4, None), (4, (2, 2))):
            cfg = DistAttnConfig(overlap_config=OverlapConfig(degree=2))
            mq, mkv, bucket = make_dispatch_meta_from_qk_ranges(
                q, k, tmap, SEQ, SEQ, CHUNK, cp, cfg.dispatch_config)
            _, calc = make_attn_meta_from_dispatch_meta(
                bucket, mq, cfg, dispatch_meta_kv=mkv, mesh_shape=mesh)
            for r in range(cp):
                tag = f"{name} cp{cp}{'' if mesh is None else ' mesh'} rank{r}"
                calls = [("host", calc.host_args[r], calc.kv_shard_len),
                         ("merged", calc.merged_args[r],
                          calc.kv_shard_len + sum(calc.recv_len_per_stage))]
                calls += [(f"stage{s}", args[r], n) for s, (args, n) in
                          enumerate(zip(calc.remote_args_per_stage, calc.recv_len_per_stage))]
                for part, a, sk in calls:
                    cases.append((f"{tag} {part}", a.q_ranges, a.k_ranges, a.d_lo, a.d_hi,
                                  calc.shard_len, sk))
            if cp > 1 and mesh is None:
                dyn = make_dynamic_attn_plan(q, k, tmap, mq, DistAttnConfig(), dispatch_meta_kv=mkv)
                for r, a in enumerate(dyn.attn_args):
                    cases.append((f"{name} cp{cp} dynamic rank{r}", a.q_ranges, a.k_ranges,
                                  a.d_lo, a.d_hi, dyn.q_buf_len, dyn.k_buf_len))
    return cases


def _decode_cases(seed: int = 0) -> list[tuple]:
    """Seeded decode calls: (site, table, lengths, pages, page size, splits,
    split_len), with split plans from ``decode_split_plan`` at the H100's
    132 SMs."""
    from ..kernels.paged_decode import decode_split_plan

    rng = np.random.default_rng(seed)
    cases = []
    for S, P, ps, hk in ((8, 16, 16, 8), (4, 64, 64, 2), (16, 3, 128, 1), (2, 256, 16, 8)):
        pool = S * P + 5
        table = rng.permutation(pool)[: S * P].reshape(S, P).astype(np.int32)
        lengths = rng.integers(0, P * ps + 1, S).astype(np.int32)
        lengths[0] = P * ps
        splits, split_len = decode_split_plan(P, ps, hk, 132)
        cases.append((f"decode S{S} P{P} ps{ps} hk{hk}", table, lengths, pool, ps, splits, split_len))
    return cases


def _nsa_cases(seed: int = 0) -> list[tuple]:
    """Seeded NSA chunk tables (site, ctbl, seq, ds): each q block picks
    chunks at or before its own (causal selection), with repeats."""
    rng = np.random.default_rng(seed)
    cases = []
    for seq, ds, hk, bq, C in ((512, 64, 2, 64, 4), (1000, 32, 1, 64, 6), (384, 48, 2, 128, 3)):
        n_qb, n_chunks = -(-seq // bq), -(-seq // ds)
        limit = np.minimum((np.arange(n_qb) + 1) * bq // ds, n_chunks - 1)
        ctbl = (rng.random((hk, n_qb, C)) * (limit[None, :, None] + 1)).astype(np.int32)
        cases.append((f"nsa S{seq} ds{ds}", ctbl, seq, ds))
    return cases


@dataclass
class Corpus:
    """What K3 runs over, built once."""

    ffa: list
    decode: list
    nsa: list


def corpus() -> Corpus:
    return Corpus(ffa=_ffa_cases(), decode=_decode_cases(), nsa=_nsa_cases())


def run_kernel_audit(corpus_: Corpus | None = None, report: VerifyReport | None = None,
                     tiles=mb.TILE_PAIRS) -> VerifyReport:
    """K1 (host), K3 over the corpus (each FFA call at every tile pair of
    ``tiles``) and K5."""
    import torch

    from ..kernels.block_sparse import key_table
    from ..kernels.ffa_plan import build_ffa_plan

    report = VerifyReport() if report is None else report
    corpus_ = corpus() if corpus_ is None else corpus_
    check_k1(report)
    for site, qr, kr, lo, hi, sq, sk in corpus_.ffa:
        for bq, bk in tiles:
            plan = build_ffa_plan(qr, kr, lo, hi, sq, sk, bq, bk)
            check_k3_ffa_plan(report, plan, sq, sk, f"{site} {bq}x{bk}")
    for case in corpus_.decode:
        check_k3_decode(report, *case[1:], site=case[0])
    for site, ctbl, seq, ds in corpus_.nsa:
        check_k3_key_table(report, ctbl, key_table(torch.from_numpy(ctbl), seq, ds), seq, ds, site)
    check_env_keys(report)
    return report


def main() -> int:
    report = run_kernel_audit()
    sys.stdout.write(report.summary() + "\n")
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
