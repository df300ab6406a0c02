#!/usr/bin/env python
"""Serving example: many concurrent PCM streams through the batched
scheduler with endpointing.

Builds a synthetic voice-assistant profile, trains decode graphs, then
simulates N concurrent realtime microphones feeding 64 ms chunks. One
StreamScheduler.step() per tick drives every stream through a single
device program; endpointing closes utterances without explicit EOFs.

Run: python examples/serve_streams.py [num_streams]
(RSTPU_WIRE=mulaw serves over the 8-bit G.711 wire — half the per-tick
H2D bytes; see ops/mulaw.py for the lossy-wire/exact-pipeline contract)
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.pipeline import lang_dir_name
from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig
from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_tpu.utils.metrics import get_metrics, reset_metrics

LEXICON = {
    "turn": ["t", "er", "n"], "on": ["aa", "n"], "off": ["ao", "f"],
    "the": ["dh", "ah"], "light": ["l", "ay", "t"], "fan": ["f", "ae", "n"],
    "never": ["n", "eh", "v", "er"], "mind": ["m", "ay", "n", "d"],
}
SENTENCES = ["turn (on|off) [the] (light|fan)", "never mind"]
UTTERANCES = [
    "turn on the light", "turn off the fan", "never mind",
    "turn on fan", "turn off light",
]


def main(num_streams: int = 16) -> None:
    root = tempfile.mkdtemp()
    profile = build_synthetic_profile(os.path.join(root, "model"), LEXICON)
    train_dir = os.path.join(root, "train")
    train_model_sync(
        "en",
        {"language": "en",
         "intents": {"Main": {"data": [{"sentences": SENTENCES}]}}},
        train_dir, profile.model_dir, lang_suffixes=[LangSuffix.GRAMMAR],
    )

    sched = StreamScheduler(
        profile.model_dir,
        os.path.join(train_dir, lang_dir_name(LangSuffix.GRAMMAR)),
        max_streams=num_streams,
        endpointing=EndpointConfig(),
        wire=os.environ.get("RSTPU_WIRE", "i16"),
    )
    reset_metrics()

    texts = [UTTERANCES[i % len(UTTERANCES)] for i in range(num_streams)]
    pcms = [synthesize_sentence(profile, t, seed=i) for i, t in enumerate(texts)]
    sids = [sched.open_stream() for _ in range(num_streams)]
    offsets = [0] * num_streams

    t0 = time.time()
    chunk = 1024  # 64 ms
    finished = [False] * num_streams
    while any(sched.poll(s) is None for s in sids):
        for i, sid in enumerate(sids):
            if offsets[i] < pcms[i].shape[0]:
                sched.feed(sid, pcms[i][offsets[i] : offsets[i] + chunk])
                offsets[i] += chunk
            elif not finished[i]:
                sched.finish(sid)
                finished[i] = True
        sched.step()
    wall = time.time() - t0

    correct = 0
    for i, sid in enumerate(sids):
        result = sched.poll(sid)
        ok = result == [texts[i]]
        correct += ok
        print(f"stream {sid:3d}: {'OK ' if ok else 'ERR'} {result}")
    audio_sec = sum(p.shape[0] for p in pcms) / 16000.0
    print(f"\n{correct}/{num_streams} exact; {audio_sec:.1f}s audio in "
          f"{wall:.2f}s wall ({audio_sec / wall:.1f}x realtime aggregate)")
    print("metrics:", get_metrics().summary())


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
