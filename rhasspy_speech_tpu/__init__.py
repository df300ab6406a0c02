"""rhasspy_speech_tpu: accelerator-native template-grammar speech-to-text.

A from-scratch JAX/XLA framework with the capabilities of rhasspy-speech
(template grammars -> decode graphs; MFCC + nnet3 TDNN acoustic model +
WFST decoding -> transcripts), redesigned for a GPU: batched streams, one
jitted program per serving step, dense Viterbi decoding.

Public API mirrors the reference package
(/root/reference/rhasspy_speech/__init__.py:1-6: train_model, LangSuffix,
KaldiNnet3WavTranscriber; tools paths are replaced by in-process
runtime configuration).
"""

from .const import LangSuffix, ModelType, WordCasing
from .tools import KaldiTools
from .pipeline import (
    KaldiNnet3WavTranscriber,
    Nnet3WavTranscriber,
    train_model,
)
from .pipeline.stream import Nnet3StreamTranscriber
from .parallel import ShardedWavTranscriber

# Reference-compatible alias
KaldiNnet3StreamTranscriber = Nnet3StreamTranscriber

__version__ = "0.2.0"

__all__ = [
    "KaldiNnet3StreamTranscriber",
    "KaldiNnet3WavTranscriber",
    "KaldiTools",
    "LangSuffix",
    "ModelType",
    "Nnet3StreamTranscriber",
    "Nnet3WavTranscriber",
    "ShardedWavTranscriber",
    "WordCasing",
    "train_model",
    "__version__",
]
