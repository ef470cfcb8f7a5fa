"""Meta/solver layer: host-side planning from slice metadata to device args.

The port's copy of ``magiattention_tpu/meta/__init__.py`` (numpy only, imports
rewired).

Pipeline (ref: SURVEY §3.1):
  make_dispatch_meta_from_qk_ranges  -> DispatchMeta (chunk->rank assignment)
  make_attn_meta_from_dispatch_meta  -> CommMeta + CalcMeta (per-rank plans)
"""

from ._make_dispatch_meta import (  # noqa: F401
    make_dispatch_meta_from_qk_ranges,
    make_global_bucket_from_qk_ranges,
)
from ._make_attn_meta import make_attn_meta_from_dispatch_meta  # noqa: F401
from .collection.dispatch_meta import DispatchMeta  # noqa: F401
from .collection.calc_meta import AttnArg, CalcMeta  # noqa: F401
from .collection.comm_meta import CommMeta, GroupCollectiveArg  # noqa: F401
