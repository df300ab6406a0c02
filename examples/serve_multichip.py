#!/usr/bin/env python
"""Multi-chip serving example: one batch decode sharded over a device mesh.

Builds a synthetic profile, trains a grammar graph, then decodes a batch
of utterances with `parallel.ShardedWavTranscriber` — the same API as the
single-chip transcriber, with the MFCC/i-vector/TDNN-F/Viterbi device
programs partitioned over a 1-D stream mesh (each chip decodes B/n
streams; there are no cross-chip collectives in the decode).

On this machine the mesh is virtual: run with

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/serve_multichip.py [num_utts]

On a multi-GPU host the same code shards over the cards.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.parallel import ShardedWavTranscriber, make_stream_mesh
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence

LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "the": ["dh", "ah"],
    "light": ["l", "ay", "t"],
    "fan": ["f", "ae", "n"],
    "never": ["n", "eh", "v", "er"],
    "mind": ["m", "ay", "n", "d"],
}
SENTENCES = ["turn (on|off) [the] (light|fan)", "never mind"]
UTTS = ["turn on the light", "turn off the fan", "never mind", "turn on fan"]


def main() -> int:
    n_utts = int(sys.argv[1]) if len(sys.argv) > 1 else 12

    tmp = tempfile.mkdtemp(prefix="rstpu_multichip_")
    profile = build_synthetic_profile(os.path.join(tmp, "model"), LEXICON)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [{"sentences": SENTENCES}]}}},
        os.path.join(tmp, "train"),
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = os.path.join(tmp, "train", lang_dir_name(LangSuffix.GRAMMAR))

    mesh = make_stream_mesh()
    n_dev = int(np.prod(mesh.devices.shape))
    print(f"mesh: {n_dev} x {mesh.devices.ravel()[0].platform} devices")

    texts = [UTTS[i % len(UTTS)] for i in range(n_utts)]
    pcms = [synthesize_sentence(profile, t, seed=i) for i, t in enumerate(texts)]
    audio_s = sum(p.shape[0] for p in pcms) / 16000.0

    sharded = ShardedWavTranscriber(profile.model_dir, lang_dir, mesh=mesh)
    sharded.transcribe_pcm_batch(pcms)  # compile at the timed batch shape
    t0 = time.time()
    got = sharded.transcribe_pcm_batch(pcms)
    wall = time.time() - t0

    ok = sum(1 for g, t in zip(got, texts) if g == [t])
    print(f"{ok}/{n_utts} exact; {audio_s:.1f}s audio in {wall:.2f}s wall "
          f"({audio_s / wall:.1f}x realtime aggregate) across {n_dev} shards")

    single = Nnet3WavTranscriber(profile.model_dir, lang_dir)
    assert single.transcribe_pcm_batch(pcms) == got, "sharded != single-chip"
    print("sharded results identical to single-chip")
    return 0 if ok == n_utts else 1


if __name__ == "__main__":
    sys.exit(main())
