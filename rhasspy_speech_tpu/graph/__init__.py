"""Decode-graph layer: topology, HCLG expansion, dense device graph tensors."""

from .dense import NEG_INF_F32, DenseGraph, dense_from_hclg, viterbi_numpy
from .hclg import make_hclg
from .topology import HmmState, PhoneTopology, Topology, TransitionModel

__all__ = [
    "DenseGraph",
    "HmmState",
    "NEG_INF_F32",
    "PhoneTopology",
    "Topology",
    "TransitionModel",
    "dense_from_hclg",
    "make_hclg",
    "viterbi_numpy",
]
