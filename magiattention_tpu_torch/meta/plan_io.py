"""Canonical byte encoding for solver-built plans (the port's copy of
``magiattention_tpu/meta/plan_io.py``; the same wire format, byte for byte).

Every host-solved artifact a ``_PlanCache`` entry can hold — dispatch metas,
the dispatch bucket, static comm/calc metas (including two-level
``hier_plan``s) and dynamic (qo-comm) plans — gets one versioned wire format
so plans can cross process and host boundaries (plan_store.py disk tier,
plan_broadcast.py wire tier). Design rules:

- **Canonical**: ``encode(decode(blob)) == blob`` byte-for-byte. Lazy caches
  (``DispatchMeta._position_ids``/``_host_ranges``/``_unpermute_index``,
  ``AttnSlice._area``) and solver carryover (``DynamicAttnPlan.solver_state``
  — an arbitrary in-process object feeding incremental re-solve, never part
  of the executable contract) are excluded from the payload; everything else
  is written in a fixed registered field order with deterministic primitive
  encodings.
- **The JAX package's format**: the registry names the port's classes by
  the same names and fields, so a plan encodes to the bytes the JAX
  package writes for the same plan, and a JAX blob decodes here. The
  port's ``HierGroupCastPlan`` also keeps its true per-pair row counts
  (``a_pair_rows``, ``b_pair_rows``); they are not on the wire and are
  read back from the receive selections at decode
  (``comm/hier.py:pair_rows_from_indices``). Plans are numpy only; the
  per-rank ``HierCastPlan`` the runtime derives is never encoded.
- **Identity-preserving**: repeated references to the same object (the
  self-attention case where one ``DispatchMeta`` serves q and kv, shared
  ndarrays) encode as back-references, so the decoded graph has the same
  topology the solver built — ``verify_runtime_mgr`` relies on
  ``dispatch_meta_kv is dispatch_meta_q`` to detect self-attention.
- **Self-checking**: a fixed header (magic, wire version, env-signature
  digest, plan-signature digest, payload length, payload sha256) makes
  truncation, bit-flips, stale schemas, cross-environment reuse and
  wrong-signature delivery each detectable as a *typed* error
  (:class:`PlanDecodeError` subclasses) before any object is built.

The ``plan_serialize`` fault-injection site arms on every encode so the
chaos suite can prove the persist path degrades to
"don't persist, keep the solved plan" rather than crashing the step.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Callable

import numpy as np

MAGIC = b"MAGIPLAN"
PLAN_WIRE_VERSION = 2
# magic(8) + version(u32) + env digest(16) + plan-signature digest(16)
# + payload len(u64) + sha256(32)
HEADER = struct.Struct("<8sI16s16sQ32s")

# header value of a blob encoded without a signature binding (direct
# encode_plan calls, e.g. the verify_plans round-trip rider); the manager's
# store/broadcast paths always bind
_UNBOUND_SIG = b"\x00" * 16


class PlanDecodeError(RuntimeError):
    """Base: a plan blob could not be decoded. Every subclass is a typed
    cache MISS for the store/broadcast layers — never a crash."""


class PlanSchemaError(PlanDecodeError):
    """Bad magic or unsupported wire version (stale schema)."""


class PlanChecksumError(PlanDecodeError):
    """Truncated payload or content-hash mismatch (bit flip)."""


class PlanEnvMismatchError(PlanDecodeError):
    """The blob was encoded under a different env signature."""


class PlanSigMismatchError(PlanDecodeError):
    """The blob is bound to a different plan-signature digest — a store
    file renamed/copied across keys, or a broadcast blob delivered for the
    wrong resolution (e.g. hosts pairing collectives off-by-one)."""


# ---------------------------------------------------------------------------
# value codec: tagged, deterministic, with back-references
# ---------------------------------------------------------------------------

_T_NONE = b"N"
_T_TRUE = b"T"
_T_FALSE = b"F"
_T_INT = b"I"      # int64
_T_BIGINT = b"J"   # arbitrary precision (length-prefixed two's complement)
_T_FLOAT = b"D"
_T_STR = b"S"
_T_BYTES = b"B"
_T_LIST = b"L"
_T_TUPLE = b"U"
_T_DICT = b"M"
_T_NDARRAY = b"A"
_T_OBJECT = b"O"
_T_ENUM = b"E"
_T_REF = b"R"

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _default_fields(cls: type, fields: tuple[str, ...]):
    def rebuild(values: list) -> Any:
        return cls(**dict(zip(fields, values)))

    return rebuild


def _build_registry() -> dict[str, tuple[type, tuple[str, ...], Callable]]:
    """name -> (class, encoded fields in order, rebuild(list) -> instance).

    Import inside the builder: plan_io sits under meta/ and must not create
    import cycles with the collections it serializes."""
    from ..common.range import AttnRange
    from ..common.ranges import AttnRanges
    from ..comm.hier import HierGroupCastPlan, pair_rows_from_indices
    from ..config import (
        DispatchConfig,
        DistAttnConfig,
        DynamicAttnConfig,
        GrpCollConfig,
        OverlapConfig,
    )
    from .collection.calc_meta import AttnArg, CalcMeta
    from .collection.comm_meta import CommMeta, GroupCollectiveArg
    from .collection.dispatch_meta import DispatchMeta
    from .collection.dynamic_meta import DynamicAttnPlan
    from .container.bucket import AttnBucket, AttnChunk
    from .container.slice import AttnSlice

    reg: dict[str, tuple[type, tuple[str, ...], Callable]] = {}

    def add(cls: type, fields: tuple[str, ...], rebuild=None) -> None:
        reg[cls.__name__] = (cls, fields, rebuild or _default_fields(cls, fields))

    add(
        AttnRange, ("_start", "_end"),
        lambda v: AttnRange(v[0], v[1]),
    )
    add(AttnRanges, ("_ranges",), lambda v: AttnRanges(v[0]))
    # _area is a lazy cache — recomputed on demand, excluded for canonicality
    add(AttnSlice, ("q_range", "k_range", "d_lo", "d_hi"))
    add(AttnChunk, ("chunk_id", "q_range", "attn_slices"))
    add(AttnBucket, ("cp_rank", "q_chunks"))
    # _position_ids/_host_ranges/_unpermute_index are lazy caches — excluded
    add(
        DispatchMeta,
        ("attn_type", "total_seqlen", "chunk_size", "cp_size", "partitions"),
    )
    hier_fields = (
        "n_outer", "n_inner", "a_send_idx", "a_recv_sel", "b_send_idx",
        "b_recv_sel", "shard_len", "r_max", "a_recv_len",
    )
    # the per-pair row counts are filled in by the owning stage's rebuild,
    # which holds the flat receive lengths phase B's counts need
    add(
        HierGroupCastPlan, hier_fields,
        lambda v: HierGroupCastPlan(
            **dict(zip(hier_fields, v)), a_pair_rows=None, b_pair_rows=None
        ),
    )
    arg_fields = (
        "transfer_table", "send_idx", "send_counts", "recv_sel", "recv_len",
        "a_cap", "r_max", "pp_deltas", "pp_caps", "pp_send_idx",
        "pp_recv_sel", "lowering", "hier_plan",
    )

    def rebuild_arg(values: list) -> GroupCollectiveArg:
        arg = GroupCollectiveArg(**dict(zip(arg_fields, values)))
        plan = arg.hier_plan
        if plan is not None and plan.a_pair_rows is None:
            plan.a_pair_rows, plan.b_pair_rows = pair_rows_from_indices(
                plan, arg.recv_len
            )
        return arg

    add(GroupCollectiveArg, arg_fields, rebuild_arg)
    add(CommMeta, ("kv_stages", "kv_host_ranges"))
    add(
        AttnArg,
        ("q_ranges", "k_ranges", "d_lo", "d_hi", "total_seqlen_q",
         "total_seqlen_k"),
    )
    add(
        CalcMeta,
        ("host_args", "remote_args_per_stage", "merged_args", "shard_len",
         "recv_len_per_stage", "kv_shard_len"),
    )
    # solver_state is in-process carryover for incremental re-solve —
    # excluded; a disk/wire-loaded dynamic plan decodes with state None
    # (the next solve for its family starts cold, correctness unaffected)
    add(
        DynamicAttnPlan,
        ("q_cast", "kv_cast", "ret", "attn_args", "merge_idx", "shard_len",
         "kv_shard_len", "q_buf_len", "k_buf_len", "ret_len"),
    )
    add(
        DispatchConfig,
        ("alg", "chunk_size", "top_p", "max_backtracks", "uneven_shard",
         "auto_comm_area_per_row", "auto_tol"),
    )
    add(
        OverlapConfig,
        ("enable", "mode", "degree", "min_chunk_size", "max_num_chunks",
         "alg"),
    )
    add(GrpCollConfig, ("split_alignment",))
    add(DynamicAttnConfig, ("alg",))
    add(
        DistAttnConfig,
        ("dispatch_config", "overlap_config", "grpcoll_config",
         "dynamic_config"),
    )
    return reg


_REGISTRY: dict[str, tuple[type, tuple[str, ...], Callable]] | None = None
_CLASS_NAMES: dict[type, str] = {}


def _registry() -> dict[str, tuple[type, tuple[str, ...], Callable]]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
        for name, (cls, _, _rb) in _REGISTRY.items():
            _CLASS_NAMES[cls] = name
    return _REGISTRY


def _enum_classes() -> dict[str, type]:
    from ..common import enum as enum_mod

    import enum as std_enum

    return {
        name: obj
        for name, obj in vars(enum_mod).items()
        if isinstance(obj, type) and issubclass(obj, std_enum.Enum)
    }


class _Encoder:
    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._memo: dict[int, int] = {}
        self._keep: list[Any] = []  # pin ids alive for the memo's lifetime
        _registry()

    def bytes(self) -> bytes:
        return b"".join(self._chunks)

    def _w(self, b: bytes) -> None:
        self._chunks.append(b)

    def _w_str(self, s: str) -> None:
        raw = s.encode("utf-8")
        self._w(_U32.pack(len(raw)))
        self._w(raw)

    def encode(self, obj: Any) -> None:
        import enum as std_enum

        if obj is None:
            self._w(_T_NONE)
        elif obj is True:
            self._w(_T_TRUE)
        elif obj is False:
            self._w(_T_FALSE)
        elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
            v = int(obj)
            if -(2**63) <= v < 2**63:
                self._w(_T_INT)
                self._w(_I64.pack(v))
            else:
                raw = v.to_bytes(
                    (v.bit_length() + 8) // 8, "little", signed=True
                )
                self._w(_T_BIGINT)
                self._w(_U32.pack(len(raw)))
                self._w(raw)
        elif isinstance(obj, (float, np.floating)):
            self._w(_T_FLOAT)
            self._w(_F64.pack(float(obj)))
        elif isinstance(obj, str):
            self._w(_T_STR)
            self._w_str(obj)
        elif isinstance(obj, bytes):
            self._w(_T_BYTES)
            self._w(_U32.pack(len(obj)))
            self._w(obj)
        elif isinstance(obj, list):
            self._w(_T_LIST)
            self._w(_U32.pack(len(obj)))
            for item in obj:
                self.encode(item)
        elif isinstance(obj, tuple):
            self._w(_T_TUPLE)
            self._w(_U32.pack(len(obj)))
            for item in obj:
                self.encode(item)
        elif isinstance(obj, dict):
            self._w(_T_DICT)
            self._w(_U32.pack(len(obj)))
            for k, v in obj.items():  # insertion order — deterministic
                self.encode(k)
                self.encode(v)
        elif isinstance(obj, np.ndarray):
            if self._ref(obj):
                return
            arr = np.ascontiguousarray(obj)
            self._w(_T_NDARRAY)
            self._w_str(arr.dtype.str)
            self._w(_U32.pack(arr.ndim))
            for dim in arr.shape:
                self._w(_I64.pack(dim))
            raw = arr.tobytes()
            self._w(_U32.pack(len(raw)))
            self._w(raw)
        elif isinstance(obj, std_enum.Enum):
            self._w(_T_ENUM)
            self._w_str(type(obj).__name__)
            self._w_str(obj.name)
        else:
            name = _CLASS_NAMES.get(type(obj))
            if name is None:
                raise PlanDecodeError(
                    f"plan_io cannot encode {type(obj).__name__}; register "
                    "it in plan_io._build_registry"
                )
            if self._ref(obj):
                return
            _, fields, _rb = _registry()[name]
            self._w(_T_OBJECT)
            self._w_str(name)
            for f in fields:
                self.encode(getattr(obj, f))

    def _ref(self, obj: Any) -> bool:
        """Emit a back-reference when obj was already encoded; otherwise
        assign it the next memo index (pre-order, mirrored by the decoder)."""
        idx = self._memo.get(id(obj))
        if idx is not None:
            self._w(_T_REF)
            self._w(_U32.pack(idx))
            return True
        self._memo[id(obj)] = len(self._memo)
        self._keep.append(obj)
        return False


class _Decoder:
    def __init__(self, payload: bytes) -> None:
        self._buf = payload
        self._pos = 0
        self._memo: list[Any] = []
        self._enums = _enum_classes()
        _registry()

    def _take(self, n: int) -> bytes:
        end = self._pos + n
        if end > len(self._buf):
            raise PlanChecksumError(
                f"plan payload underrun at byte {self._pos} "
                f"(want {n}, have {len(self._buf) - self._pos})"
            )
        out = self._buf[self._pos:end]
        self._pos = end
        return out

    def _r_u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def _r_str(self) -> str:
        return self._take(self._r_u32()).decode("utf-8")

    def done(self) -> bool:
        return self._pos == len(self._buf)

    def decode(self) -> Any:
        tag = self._take(1)
        if tag == _T_NONE:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            return _I64.unpack(self._take(8))[0]
        if tag == _T_BIGINT:
            return int.from_bytes(
                self._take(self._r_u32()), "little", signed=True
            )
        if tag == _T_FLOAT:
            return _F64.unpack(self._take(8))[0]
        if tag == _T_STR:
            return self._r_str()
        if tag == _T_BYTES:
            return self._take(self._r_u32())
        if tag == _T_LIST:
            return [self.decode() for _ in range(self._r_u32())]
        if tag == _T_TUPLE:
            return tuple(self.decode() for _ in range(self._r_u32()))
        if tag == _T_DICT:
            return {
                self.decode(): self.decode() for _ in range(self._r_u32())
            }
        if tag == _T_NDARRAY:
            slot = self._reserve()
            dtype = np.dtype(self._r_str())
            ndim = self._r_u32()
            shape = tuple(
                _I64.unpack(self._take(8))[0] for _ in range(ndim)
            )
            raw = self._take(self._r_u32())
            want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if len(raw) != want:
                raise PlanChecksumError(
                    f"ndarray byte count {len(raw)} != shape {shape} x "
                    f"{dtype} ({want})"
                )
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            self._memo[slot] = arr
            return arr
        if tag == _T_ENUM:
            cls_name = self._r_str()
            member = self._r_str()
            cls = self._enums.get(cls_name)
            if cls is None:
                raise PlanSchemaError(f"unknown enum class '{cls_name}'")
            try:
                return cls[member]
            except KeyError as e:
                raise PlanSchemaError(
                    f"unknown member '{member}' of enum {cls_name}"
                ) from e
        if tag == _T_OBJECT:
            slot = self._reserve()
            name = self._r_str()
            spec = _registry().get(name)
            if spec is None:
                raise PlanSchemaError(f"unknown plan class '{name}'")
            _cls, fields, rebuild = spec
            values = [self.decode() for _ in fields]
            try:
                obj = rebuild(values)
            except Exception as e:
                raise PlanDecodeError(
                    f"failed to rebuild {name}: {type(e).__name__}: {e}"
                ) from e
            self._memo[slot] = obj
            return obj
        if tag == _T_REF:
            idx = self._r_u32()
            if idx >= len(self._memo) or self._memo[idx] is None:
                raise PlanChecksumError(
                    f"dangling back-reference {idx} (memo size "
                    f"{len(self._memo)})"
                )
            return self._memo[idx]
        raise PlanSchemaError(f"unknown value tag {tag!r}")

    def _reserve(self) -> int:
        """Pre-order memo slot: matches the encoder's index assignment even
        when shared objects nest (plans are DAGs — a back-reference always
        targets an object whose decode already completed)."""
        self._memo.append(None)
        return len(self._memo) - 1


def encode_value(obj: Any) -> bytes:
    """Headerless canonical encoding (digests, tests)."""
    enc = _Encoder()
    enc.encode(obj)
    return enc.bytes()


def decode_value(payload: bytes) -> Any:
    dec = _Decoder(payload)
    obj = dec.decode()
    if not dec.done():
        raise PlanChecksumError(
            f"{len(payload) - dec._pos} trailing bytes after plan payload"
        )
    return obj


def env_sig_digest(env_sig: Any) -> bytes:
    """16-byte digest of an environment signature (the runtime key's
    ``env_snapshot`` — every behavior-affecting flag)."""
    return hashlib.sha256(encode_value(env_sig)).digest()[:16]


def plan_signature_digest(sig: Any) -> str:
    """Hex content address of a ``_plan_signature`` tuple — the store /
    broadcast key. Collision-safe across configs and env snapshots because
    both are part of the encoded signature."""
    return hashlib.sha256(encode_value(sig)).hexdigest()


def _sig_digest_bytes(digest: str) -> bytes:
    """16-byte header form of a plan-signature digest string."""
    return hashlib.sha256(digest.encode("utf-8")).digest()[:16]


def encode_plan(
    obj: Any, env_sig: Any = (), sig_digest: str | None = None
) -> bytes:
    """Serialize one plan-cache entry (or any registered plan object) into
    a self-checking blob. ``sig_digest`` — the plan-signature digest the
    blob is stored/broadcast under — is embedded in the header so a
    delivered blob is bound to the signature it answers; the manager's
    persist path always binds. Arms the ``plan_serialize`` injection
    site."""
    from ..resilience.inject import maybe_inject

    maybe_inject("plan_serialize")
    payload = encode_value(obj)
    return HEADER.pack(
        MAGIC,
        PLAN_WIRE_VERSION,
        env_sig_digest(env_sig),
        _sig_digest_bytes(sig_digest) if sig_digest else _UNBOUND_SIG,
        len(payload),
        hashlib.sha256(payload).digest(),
    ) + payload


def decode_plan(
    blob: bytes, env_sig: Any = (), expect_digest: str | None = None
) -> Any:
    """Decode + integrity-check one blob. Raises a typed
    :class:`PlanDecodeError` subclass on ANY corruption; the caller
    (plan_store / plan_broadcast) turns that into a cache miss. With
    ``expect_digest``, a blob bound to a different plan-signature digest
    is a :class:`PlanSigMismatchError` — the guard against a store file
    served under the wrong key or a broadcast blob delivered for the
    wrong resolution (unbound blobs skip the check)."""
    if len(blob) < HEADER.size:
        raise PlanChecksumError(
            f"blob shorter than header ({len(blob)} < {HEADER.size})"
        )
    magic, version, env_digest, sig_digest, length, digest = (
        HEADER.unpack_from(blob)
    )
    if magic != MAGIC:
        raise PlanSchemaError(f"bad magic {magic!r}")
    if version != PLAN_WIRE_VERSION:
        raise PlanSchemaError(
            f"wire version {version} != supported {PLAN_WIRE_VERSION}"
        )
    if env_digest != env_sig_digest(env_sig):
        raise PlanEnvMismatchError(
            "plan encoded under a different env signature"
        )
    if (
        expect_digest is not None
        and sig_digest != _UNBOUND_SIG
        and sig_digest != _sig_digest_bytes(expect_digest)
    ):
        raise PlanSigMismatchError(
            "plan blob is bound to a different plan signature"
        )
    payload = blob[HEADER.size:]
    if len(payload) != length:
        raise PlanChecksumError(
            f"payload length {len(payload)} != header {length} (truncated?)"
        )
    if hashlib.sha256(payload).digest() != digest:
        raise PlanChecksumError("payload sha256 mismatch (bit flip?)")
    return decode_value(payload)
