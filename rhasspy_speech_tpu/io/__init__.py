"""Kaldi model-file I/O: binary stream format, final.mdl, extractor files.

Parsers for the pre-trained artifacts the reference downloads from
HuggingFace (final.mdl, final.mat, final.ie, final.dubm, conf files) so the
framework can load them unchanged. Pure Python + NumPy; the parsed
weights feed the JAX forward paths.
"""

from .kaldi_io import KaldiReader, KaldiWriter, read_kaldi_object
from .transition_model import (
    KaldiHmmTopology,
    KaldiTransitionModel,
    TopologyEntry,
    TopologyState,
)
from .nnet3_file import (
    ComponentSpec,
    Descriptor,
    NodeSpec,
    Nnet3Spec,
    parse_descriptor,
    read_am_nnet3,
    read_nnet3,
    write_nnet3,
)

__all__ = [
    "ComponentSpec",
    "Descriptor",
    "KaldiHmmTopology",
    "KaldiReader",
    "KaldiTransitionModel",
    "KaldiWriter",
    "NodeSpec",
    "Nnet3Spec",
    "TopologyEntry",
    "TopologyState",
    "parse_descriptor",
    "read_am_nnet3",
    "read_kaldi_object",
    "read_nnet3",
    "write_nnet3",
]
