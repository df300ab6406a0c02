#!/usr/bin/env python
"""Dual-graph OOV flow: decode with one lang dir, rescore with another.

The reference's headline design (README.md:50-55) pairs a rigid grammar
graph with an ARPA graph so out-of-vocabulary audio can be rejected, and
rescoring against a higher-order (or different-lexicon) lang dir can
recover hypotheses the first pass never ranked. This example shows the
strongest form: the first-pass graph does not even CONTAIN the correct
word ("read"), yet the lattice rescore recovers it through the new
lexicon, because the rescore remaps the decode lattice at the phone
level (pipeline/rescore.py) instead of re-weighting an n-best list.

Run (CPU): JAX_PLATFORMS=cpu python examples/rescore_oov.py
"""

import os
import sys
import tempfile
import wave
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence

LEXICON = {
    "turn": ["t", "er", "n"],
    "red": ["r", "eh", "d"],
    "read": ["r", "eh", "d"],  # homophone
    "page": ["p", "ey", "jh"],
}


def main() -> None:
    root = Path(tempfile.mkdtemp(prefix="rstpu_rescore_"))
    profile = build_synthetic_profile(root / "model", LEXICON)

    def intents(*sentences):
        return {
            "language": "en",
            "intents": {"Demo": {"data": [{"sentences": list(sentences)}]}},
        }

    # First pass: a rigid grammar that only knows "turn red".
    train_model_sync(
        "en", intents("turn red"), root / "train_old", profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    # Rescore lang: an ARPA LM over "turn read [page]" — different vocab.
    train_model_sync(
        "en", intents("turn read [page]"), root / "train_new",
        profile.model_dir,
        lang_suffixes=[LangSuffix.ARPA, LangSuffix.ARPA_RESCORE],
    )

    t = Nnet3WavTranscriber(
        profile.model_dir, root / "train_old" / lang_dir_name(LangSuffix.GRAMMAR)
    )
    pcm = synthesize_sentence(profile, "turn red", seed=7)
    wav_path = root / "utt.wav"
    with wave.open(str(wav_path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())

    first = t.transcribe_pcm_batch([pcm], nbest=5)[0]
    print(f"first pass (grammar graph): {first}")

    rescored = t.transcribe_rescore(
        wav_path,
        old_lang_dir=root / "train_old" / lang_dir_name(LangSuffix.GRAMMAR),
        new_lang_dir=root / "train_new" / lang_dir_name(LangSuffix.ARPA_RESCORE),
        nbest=5,
    )
    print(f"lattice rescore (new lexicon + LM): {rescored}")
    assert rescored and rescored[0] == "turn read"
    print("the rescore recovered a word the decode graph does not contain")


if __name__ == "__main__":
    main()
