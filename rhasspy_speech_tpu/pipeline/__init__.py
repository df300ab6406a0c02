"""Training + transcription pipelines (the reference's L5 layer, in-process).

train_model compiles per-user decode artifacts (grammar FST, lexicon,
n-gram LM, dense HCLG tensors); the transcribers run WAVs / PCM streams
through MFCC -> nnet3 forward -> dense Viterbi -> n-best -> fuzzy match /
rescore -> decode_meta, all in-process (the reference shells out to ~10
Kaldi/OpenFST binaries per utterance: rhasspy_speech/transcribe_wav.py:35-202).
"""

from .artifacts import LangArtifacts, lang_dir_name
from .train import train_model
from .fuzzy import get_fuzzy_text, rescore_nbest
from .transcribe import AcousticModel, Nnet3WavTranscriber

# Reference-compatible alias (rhasspy_speech.KaldiNnet3WavTranscriber)
KaldiNnet3WavTranscriber = Nnet3WavTranscriber

__all__ = [
    "AcousticModel",
    "KaldiNnet3WavTranscriber",
    "LangArtifacts",
    "Nnet3WavTranscriber",
    "get_fuzzy_text",
    "lang_dir_name",
    "rescore_nbest",
    "train_model",
]
