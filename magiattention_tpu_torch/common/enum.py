"""Core enums (the port's copy of ``magiattention_tpu/common/enum.py``).

Integer codes for
``AttnMaskType`` match the reference kernel contract
(0=FULL, 1=CAUSAL, 2=INVCAUSAL, 3=BICAUSAL) so slice metadata arrays are
interchangeable.
"""

from enum import Enum
from typing import Literal, TypeAlias

GroupReduceOp: TypeAlias = Literal["sum", "avg", "lse"]

AttnSinkLayout: TypeAlias = Literal["sh", "shd", "ssh"]


class AttnType(Enum):
    """Type of attention computation."""

    SELF_ATTN = "self_attn"
    CROSS_ATTN = "cross_attn"


class AttnRole(Enum):
    """Tensor role in attention."""

    QUERY = "query"
    KEY = "key"
    VALUE = "value"


class AttnMaskType(Enum):
    """Unit mask type of an attention slice.

    Semantics over a slice ``(q_range=[qs,qe), k_range=[ks,ke))`` for global
    coordinates ``(i, j)``:

    - ``FULL``:      all pairs in the rectangle are unmasked.
    - ``CAUSAL``:    bottom-right aligned lower-triangle: ``j - i <= ke - qe``.
    - ``INVCAUSAL``: top-left aligned upper-triangle:     ``j - i >= ks - qs``.
    - ``BICAUSAL``:  both constraints (a diagonal band).
    """

    FULL = "full"
    CAUSAL = "causal"
    BICAUSAL = "bi_causal"
    INVCAUSAL = "inv_causal"

    @classmethod
    def from_int_type(cls, int_type: int) -> "AttnMaskType":
        return _INT_TO_MASK_TYPE[int_type]

    def to_int_type(self) -> int:
        return _MASK_TYPE_TO_INT[self]

    @classmethod
    def normalize(
        cls, value: "AttnMaskType | str | int"
    ) -> "AttnMaskType":
        """Accept enum / str / int forms uniformly (incl. numpy integer
        scalars — mask metadata routinely arrives as np.int32 arrays)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, int) or (
            hasattr(value, "__index__") and not isinstance(value, str)
        ):
            return cls.from_int_type(int(value))
        return cls(value)


_INT_TO_MASK_TYPE = {
    0: AttnMaskType.FULL,
    1: AttnMaskType.CAUSAL,
    2: AttnMaskType.INVCAUSAL,
    3: AttnMaskType.BICAUSAL,
}
_MASK_TYPE_TO_INT = {v: k for k, v in _INT_TO_MASK_TYPE.items()}


class AttnOverlapMode(Enum):
    """Overlap mode for multi-stage compute/comm overlapping."""

    STATIC = "static"
    DYNAMIC = "dynamic"


class DispatchAlgType(Enum):
    """Algorithm for load-balanced chunk->rank dispatching."""

    # AUTO is this build's addition (no reference analogue): solve with a
    # small candidate set and pick by a modeled compute/comm trade-off —
    # see meta/_make_dispatch_meta.py:_auto_select_partitions
    AUTO = "auto"
    LOWER_BOUND = "lower_bound"
    DYNAMIC_PROGRAMMING = "dynamic_programming"
    BINARY_SEARCH = "binary_search"
    MIN_HEAP = "min_heap"
    TOPP_HEAP = "topp_heap"
    BACKTRACKING_PRUNING = "backtracing_pruning"
    RANDOM_SELECT = "random_select"
    SEQUENTIAL_SELECT = "sequential_select"
    BATCH_TOPP_HEAP = "batch_topp_heap"
    SORTED_SEQUENTIAL_SELECT = "sorted_sequential_select"


class OverlapAlgType(Enum):
    """Algorithm for multi-stage overlap planning."""

    UNIFORM = "uniform"
    GREEDY = "greedy"


class DynamicAttnAlgType(Enum):
    """Algorithm for the dynamic (qo-comm) attention solver."""

    NON_COMMUNICATION_QO = "ncq"
    GREEDY_RANDOM_GRID = "grg"
    SIMPLEX_NETWORK_FLOW = "snf"
    FAST_SNF = "fast_snf"
    BINARY_GREEDY = "binary_greedy"
    BINARY_GREEDY_PARALLEL = "binary_greedy_parallel"


class AttnKernelBackend(Enum):
    """Which attention kernel backend executes an AttnArg.

    - ``FFA``: the Pallas-TPU flex-flash-attention kernel (production path).
    - ``SDPA``: dense jnp reference backend, fp32/fp64 (testing path).
    - ``SDPA_ONLINE``: blockwise-online jnp backend (low-memory testing path).
    """

    FFA = "ffa"
    SDPA = "sdpa"
    SDPA_ONLINE = "sdpa_online"


class AttnPrecision(Enum):
    """Precision override for attention compute."""

    DEFAULT = "default"
    FP32 = "fp32"
    BF16 = "bf16"
