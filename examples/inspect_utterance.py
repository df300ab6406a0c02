"""Inspect one utterance: transcript, confidence, n-best rivals, lattice ark.

Usage (CPU):
    JAX_PLATFORMS=cpu python examples/inspect_utterance.py

Builds a synthetic profile (no model download needed), decodes one
utterance, and prints everything a production service would log per
request: the transcript, the decoder-native confidence, the lattice's
distinct n-best rivals, and writes the lattice to a Kaldi-format ark.
"""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.io.lattice_io import write_lattice_ark
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence


def main() -> None:
    root = Path(tempfile.mkdtemp(prefix="rss_inspect_"))
    lexicon = {
        "turn": ["t", "er", "n"],
        "on": ["aa", "n"],
        "off": ["ao", "f"],
        "light": ["l", "ay", "t"],
    }
    profile = build_synthetic_profile(root / "model", lexicon)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"Main": {"data": [
            {"sentences": ["turn (on|off) light"]}]}}},
        root / "train",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang = root / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    t = Nnet3WavTranscriber(profile.model_dir, lang)

    pcm = synthesize_sentence(profile, "turn off light", seed=3)
    text = t.transcribe_pcm_batch([pcm])[0]
    conf = t.confidence_pcm(pcm)
    print(f"transcript : {text[0]!r}")
    print(f"confidence : {conf:.4f}")

    import wave

    import numpy as np

    wav = root / "utt.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())

    lat = t.get_lattice(wav)
    rivals = lat.nbest(t.artifacts.graph, 5)
    words = t.artifacts.words
    print("n-best     :")
    for ids, cost in rivals:
        s = " ".join(words.find_id(w) for w in ids if words.find_id(w) != "<eps>")
        print(f"  {cost:8.3f}  {s}")

    clat = t.get_compact_lattice(wav)
    ark = root / "lat.ark"
    write_lattice_ark(ark, [("utt-0", clat)])
    print(f"lattice ark: {ark} ({clat.num_states} states, "
          f"{clat.num_arcs()} arcs)")


if __name__ == "__main__":
    main()
