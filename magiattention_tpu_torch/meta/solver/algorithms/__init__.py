"""Dynamic (qo-comm) solver algorithms (ref: magi_attention/meta/algorithms/).

The port's copy of ``magiattention_tpu/meta/solver/algorithms/__init__.py`` (numpy only, imports
rewired).

Six algorithms matching the reference inventory
(`DynamicAttnAlgType`, common/enum.py): NCQ, GRG, SNF, FastSNF,
BinaryGreedy, BinaryGreedyParallel.
"""

from __future__ import annotations

from ....common.enum import DynamicAttnAlgType
from .base import (
    DynamicAttnAlgorithm,
    DynSolveContext,
    Tile,
    buckets_from_assignment,
    cut_to_tiles,
    marginal_comm_cost,
)
from .binary_greedy import BinaryGreedyAlg, BinaryGreedyParallelAlg
from .grg import GRGAlg
from .ncq import NCQAlg
from .snf import FastSNFAlg, SNFAlg

_REGISTRY = {
    DynamicAttnAlgType.NON_COMMUNICATION_QO: NCQAlg,
    DynamicAttnAlgType.GREEDY_RANDOM_GRID: GRGAlg,
    DynamicAttnAlgType.SIMPLEX_NETWORK_FLOW: SNFAlg,
    DynamicAttnAlgType.FAST_SNF: FastSNFAlg,
    DynamicAttnAlgType.BINARY_GREEDY: BinaryGreedyAlg,
    DynamicAttnAlgType.BINARY_GREEDY_PARALLEL: BinaryGreedyParallelAlg,
}


def get_dynamic_alg(
    alg: DynamicAttnAlgType | str, **kwargs
) -> DynamicAttnAlgorithm:
    if isinstance(alg, str):
        alg = DynamicAttnAlgType(alg)
    return _REGISTRY[alg](**kwargs)


__all__ = [
    "DynamicAttnAlgorithm",
    "DynSolveContext",
    "Tile",
    "NCQAlg",
    "GRGAlg",
    "SNFAlg",
    "FastSNFAlg",
    "BinaryGreedyAlg",
    "BinaryGreedyParallelAlg",
    "get_dynamic_alg",
    "cut_to_tiles",
    "marginal_comm_cost",
    "buckets_from_assignment",
]
