"""Decode-kernel auto-selection (VERDICT item 6).

max_active maps onto the sparse frontier's K (the per-frame active-state
cap of LatticeFasterDecoderConfig, lattice-faster-decoder.h:38-66), and the
transcriber picks dense / checkpointed / frontier from the backpointer
footprint so huge graphs never materialize [T, B, S] tensors.
"""

import numpy as np
import pytest

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.graph.dense import NEG_INF_F32, DenseGraph
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.pipeline.transcribe import (
    DEFAULT_DECODE_BUDGET,
    select_decoder,
)
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence

LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "the": ["dh", "ah"],
    "light": ["l", "ay", "t"],
}


def test_select_decoder_thresholds():
    # Small graph: dense, whole batch at once
    assert select_decoder(1500, 8, 300, 5, 7000) == ("dense", 8)
    # Bigger graph/batch: still dense, but in sub-batches that fit
    # (budget is BYTES; int32 backpointers without num_arcs)
    mode, sub = select_decoder(20_000, 4096, 100, 1, 7000)
    assert mode == "dense" and 1 <= sub < 4096
    assert sub == DEFAULT_DECODE_BUDGET // (100 * 20_000 * 4)
    # A graph small enough for uint16 backpointers fits twice the streams
    mode, sub2 = select_decoder(20_000, 4096, 100, 1, 7000, num_arcs=60_000)
    assert mode == "dense" and sub2 == DEFAULT_DECODE_BUDGET // (100 * 20_000 * 2)
    # ... but only for 1-best (k-best backpointers stay int32, and the
    # per-frame [B, A, k] candidate tensor is charged per stream too)
    mode, sub3 = select_decoder(20_000, 4096, 100, 2, 7000, num_arcs=60_000)
    assert mode == "dense"
    assert sub3 == DEFAULT_DECODE_BUDGET // (100 * 20_000 * 2 * 4 + 60_000 * 2 * 4)
    # An arc-heavy graph that passes the bp test alone must not pass k-best:
    # [B, A, k] candidates dominate and shrink the sub-batch accordingly
    mode, sub4 = select_decoder(
        2_000, 64, 100, 4, 7000, budget=1 << 24, num_arcs=500_000
    )
    assert mode == "dense"
    assert sub4 == (1 << 24) // (100 * 2_000 * 4 * 4 + 500_000 * 4 * 4)
    assert sub4 == 1
    # Per-stream dense footprint over budget, 1-best: checkpointed
    mode, sub = select_decoder(300_000, 2, 10_000, 1, 7000)
    assert mode == "checkpointed" and sub >= 1
    # n-best on a graph too big for per-stream dense: frontier, K=max_active
    mode, k = select_decoder(3_000_000, 2, 1000, 5, 7000)
    assert mode == "frontier" and k == 7000
    # The [T, B, K] trellis triple must also fit: K is memory-clamped
    mode, k = select_decoder(
        3_000_000, 64, 100, 5, max_active=10**9, budget=1 << 20
    )
    assert mode == "frontier" and k == (1 << 20) // (100 * 64 * 3 * 4)
    # The per-frame [B, K, D] expansion clamps K further
    mode, k = select_decoder(
        3_000_000, 64, 100, 5, max_active=10**9, budget=1 << 20,
        out_degree=1000,
    )
    assert mode == "frontier" and k == (1 << 20) // (64 * 1000 * 4) == 4


def test_select_decoder_min_sub_batch():
    # One shard's worth of streams must fit the budget at once, or the
    # forced shard-multiple rounding would exceed it: with min_sub_batch=8
    # the dense plan that fits only 2 streams falls through to checkpointed
    per_stream_dense = 100 * 20_000 * 4  # uint16 needs num_arcs; this is i32
    budget = 30_000_000  # fits 3 dense streams, or 10 checkpointed
    mode, sub = select_decoder(20_000, 64, 100, 1, 7000, budget=budget)
    assert (mode, sub) == ("dense", budget // per_stream_dense)
    mode, sub = select_decoder(
        20_000, 64, 100, 1, 7000, budget=budget, min_sub_batch=8
    )
    assert mode == "checkpointed" and sub >= 8
    # ... and checkpointed falls through to frontier the same way
    n_seg = -(-100 // 32)
    per_stream_ckpt = (n_seg + 32) * 20_000 * 4
    budget2 = per_stream_ckpt * 2
    mode, _ = select_decoder(
        20_000, 64, 10_000, 1, 7000, budget=budget2, min_sub_batch=8
    )
    assert mode == "frontier"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("decsel")
    profile = build_synthetic_profile(root / "model", LEXICON)
    train_dir = root / "train"
    train_model_sync(
        "en",
        {
            "language": "en",
            "intents": {
                "M": {"data": [{"sentences": ["turn (on|off) [the] light"]}]}
            },
        },
        train_dir,
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    return profile, train_dir / lang_dir_name(LangSuffix.GRAMMAR)


def test_checkpointed_and_frontier_match_dense(trained):
    """A starved memory budget flips the kernel; transcripts must not
    change (checkpointed is exact; frontier is exact while K >= reachable
    states, which holds for this graph)."""
    profile, lang_dir = trained
    pcm = synthesize_sentence(profile, "turn off the light", seed=13)

    dense_t = Nnet3WavTranscriber(profile.model_dir, lang_dir)
    # A budget below the dense backpointer footprint flips the kernel; the
    # frontier K it leaves (budget / (T*B*3)) still covers this graph's
    # simultaneously-reachable states, so decodes stay exact.
    starved_t = Nnet3WavTranscriber(
        profile.model_dir, lang_dir, decode_memory_budget=20_000
    )

    want = dense_t.transcribe_pcm_batch([pcm])[0]
    assert want == ["turn off the light"]
    assert starved_t.transcribe_pcm_batch([pcm])[0] == want

    # n-best: top hypothesis agrees between exact k-best and frontier n-best
    dense_nbest = dense_t.transcribe_pcm_batch([pcm], nbest=3)[0]
    frontier_nbest = starved_t.transcribe_pcm_batch([pcm], nbest=3)[0]
    assert frontier_nbest and frontier_nbest[0] == dense_nbest[0]

    # mixed-length batches stay masked correctly off the dense path
    pcm2 = synthesize_sentence(profile, "turn on light", seed=4)
    got = starved_t.transcribe_pcm_batch([pcm, pcm2])
    assert got[0] == ["turn off the light"] and got[1] == ["turn on light"]


def test_huge_graph_decodes_without_dense_backpointers(trained, tmp_path):
    """A >=1e5-state graph decodes through the guardrail paths (the round-1
    failure mode: the dense [T, B, S] path would OOM with no fallback)."""
    profile, lang_dir = trained

    big_dir = tmp_path / "lang_big"
    big_dir.mkdir()
    for name in ("words.txt", "g.fst", "g_fuzzy.fst", "phones.txt", "ldet.fst"):
        src = lang_dir / name
        if src.exists():
            (big_dir / name).write_bytes(src.read_bytes())

    # Inflate the decode graph with unreachable padding states: S >= 1e5,
    # arcs/behavior unchanged — exactly the memory profile of a big LM graph.
    g = DenseGraph.load(str(lang_dir / "graph.npz"))
    S = 120_000
    pad = S - g.num_states
    assert pad > 0
    g.num_states = S
    g.final_weight = np.concatenate(
        [g.final_weight, np.full(pad, NEG_INF_F32, dtype=np.float32)]
    )
    g.init_weight = np.concatenate(
        [g.init_weight, np.full(pad, NEG_INF_F32, dtype=np.float32)]
    )
    g.final_wseq = np.concatenate([g.final_wseq, np.zeros(pad, np.int32)])
    g.init_wseq = np.concatenate([g.init_wseq, np.zeros(pad, np.int32)])
    g.save(str(big_dir / "graph.npz"))

    t = Nnet3WavTranscriber(
        profile.model_dir, big_dir, decode_memory_budget=1 << 22
    )
    pcm = synthesize_sentence(profile, "turn on the light", seed=21)

    T_frames = 1 + pcm.shape[0] // 160  # upper bound on decode frames
    mode, _ = select_decoder(120_000, 1, T_frames, 1, 7000, budget=1 << 22)
    assert mode != "dense"

    assert t.transcribe_pcm_batch([pcm])[0] == ["turn on the light"]
    nbest = t.transcribe_pcm_batch([pcm], nbest=3)[0]
    assert nbest and nbest[0] == "turn on the light"


def test_dense_sub_batching_matches_whole_batch(trained):
    """A budget that forces dense sub-batches of ~1 stream (the
    double-buffered dispatch/harvest path) decodes identically to the
    whole-batch program."""
    profile, lang_dir = trained
    whole = Nnet3WavTranscriber(profile.model_dir, lang_dir)
    g = whole.artifacts.graph

    texts = ["turn on the light", "turn off light", "turn on light"]
    pcms = [
        synthesize_sentence(profile, t, seed=400 + i)
        for i, t in enumerate(texts)
    ]
    want = whole.transcribe_pcm_batch(pcms)
    assert want == [[t] for t in texts]

    # compute the real per-stream footprints the selector will see, then
    # pick budgets that keep the dense mode but force sub-batches of 1
    from rhasspy_speech_tpu.ops.frontend import num_frames

    cfg = whole.am.frontend_config
    sub = whole.am.subsampling
    t_out = max(-(-num_frames(cfg, p.shape[0]) // sub) for p in pcms)
    bucket_out = -(-t_out // 16) * 16
    per_stream_1best = bucket_out * g.num_states * 2  # u16 bp
    # int32 bp, k=2, plus the per-frame [B, A, k] candidate charge
    per_stream_kbest = bucket_out * g.num_states * 2 * 4 + g.num_arcs * 2 * 4

    small = Nnet3WavTranscriber(
        profile.model_dir, lang_dir,
        decode_memory_budget=per_stream_1best + 1,
    )
    mode, arg = select_decoder(
        g.num_states, len(pcms), bucket_out, 1, 7000,
        per_stream_1best + 1, num_arcs=g.num_arcs,
    )
    assert (mode, arg) == ("dense", 1)
    assert small.transcribe_pcm_batch(pcms) == want

    small_k = Nnet3WavTranscriber(
        profile.model_dir, lang_dir,
        decode_memory_budget=per_stream_kbest + 1,
    )
    mode, arg = select_decoder(
        g.num_states, len(pcms), bucket_out, 2, 7000,
        per_stream_kbest + 1, num_arcs=g.num_arcs,
    )
    assert (mode, arg) == ("dense", 1)
    want_n = whole.transcribe_pcm_batch(pcms, nbest=2)
    assert small_k.transcribe_pcm_batch(pcms, nbest=2) == want_n


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats, budget",
    [
        ({"bytes_limit": 80 * 2**30, "bytes_in_use": 0}, 15 * 2**30),
        ({"bytes_limit": 16 * 2**30}, 3 * 2**30),
        (None, DEFAULT_DECODE_BUDGET),
        ({}, DEFAULT_DECODE_BUDGET),
    ],
)
def test_decode_budget_follows_reported_memory(stats, budget):
    """3/16 of the device's reported memory limit; the 16 GiB device's
    share where the device reports none (the CPU backend)."""
    from rhasspy_speech_tpu.pipeline.transcribe import default_decode_budget

    assert default_decode_budget(_Device(stats)) == budget
