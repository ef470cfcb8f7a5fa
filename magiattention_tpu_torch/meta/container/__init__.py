"""Planning containers: slices, chunks, buckets (ref: magi_attention/meta/container/).

The port's copy of ``magiattention_tpu/meta/container/__init__.py`` (numpy only, imports
rewired).
"""

from .slice import AttnSlice, band_area  # noqa: F401
from .bucket import AttnBucket, AttnChunk  # noqa: F401
