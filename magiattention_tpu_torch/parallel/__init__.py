"""Attention baselines beside the CP runtime.

The port's counterpart of ``magiattention_tpu/parallel`` (ref
exps/dist_attn/baselines/): the context-parallel baselines the reference
compares MagiAttention against (Ulysses, Ring P2P and AllGather, USP,
LoongTrain, HybridCP, AllGather), built on the FFA kernels and the
differentiable subgroup collectives of :mod:`..comm.functional` over a
:class:`ProcessMesh`; NSA (native sparse attention) on one device and
USP-sharded (:func:`usp_nsa_attn`).
"""

from ._mesh import ProcessMesh, local_shard  # noqa: F401
from .hybrid import allgather_attn, hybrid_cp_attn  # noqa: F401
from .loongtrain import loongtrain_attn, make_loongtrain_mesh  # noqa: F401
from .nsa import init_nsa_params, nsa_attn, params_from_numpy, usp_nsa_attn  # noqa: F401
from .ring import ring_attn, ring_attn_allgather, ring_dispatch, ring_undispatch  # noqa: F401
from .ulysses import ulysses_attn  # noqa: F401
from .usp import usp_attn  # noqa: F401

__all__ = [
    "ProcessMesh",
    "allgather_attn",
    "hybrid_cp_attn",
    "init_nsa_params",
    "local_shard",
    "loongtrain_attn",
    "make_loongtrain_mesh",
    "nsa_attn",
    "params_from_numpy",
    "ring_attn",
    "ring_attn_allgather",
    "ring_dispatch",
    "ring_undispatch",
    "ulysses_attn",
    "usp_attn",
    "usp_nsa_attn",
]
