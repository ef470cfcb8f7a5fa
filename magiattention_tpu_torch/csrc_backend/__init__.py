"""Native host backend: the planning hot loops in C++ (a copy of the JAX
package's ``csrc/magi_host.cpp`` at ``magiattention_tpu_torch/csrc/``),
built with ``g++`` at first use and bound through ctypes (the port's
counterpart of ``magiattention_tpu/csrc_backend``).

``CppAttnRange`` / ``CppAttnRanges`` conform to ``common.protocols`` and
are swapped in by ``common/__init__`` when ``MAGI_ATTENTION_CPP_BACKEND=1``
(default). The native paths: ``meta/container/slice.py``'s band area, the
dispatch min-heap solve (``meta/_make_dispatch_meta.py``), the
binary-greedy dynamic solve (``meta/solver/algorithms/binary_greedy.py``)
and the FFA work-list builder (``kernels/ffa_plan.py``, under
``MAGI_ATTENTION_NATIVE_FFA_PLAN``). Each falls back to Python where
``g++`` is missing; the plans are the same arrays either way (the
binary-greedy solve's stable tile order, the one change from the JAX
package's library, makes it place tiles as the numpy path does). This is
host planning: the kernels' inputs do not change.
"""

from .build import NativeBuildError, available, get_lib  # noqa: F401
from .ops import band_area_native, chunk_areas_native, minheap_solve_native  # noqa: F401
from .ranges import CppAttnRange, CppAttnRanges  # noqa: F401
