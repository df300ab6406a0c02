"""End-to-end pipeline tests: train_model + synthetic audio -> transcripts.

This is the hermetic equivalent of the reference's model tests
(tests/test_en_US-zamia.py:16-59: train on templates, decode each WAV,
assert exact transcript match) using the synthetic acoustic profile.
"""

import asyncio

import numpy as np
import pytest

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.pipeline import (
    Nnet3WavTranscriber,
    lang_dir_name,
    train_model,
)
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import build_synthetic_profile, synthesize_sentence
from rhasspy_speech_tpu.testing.flagship import flagship_intents_dict

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


@pytest.fixture(scope="module")
def profile_and_train(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_profile")
    model_dir = root / "model"
    train_dir = root / "train"
    profile = build_synthetic_profile(model_dir, LEXICON)
    intents = {
        "language": "en",
        "intents": {"Main": {"data": [{"sentences": SENTENCES}]}},
    }
    train_model_sync(
        "en",
        intents,
        train_dir,
        model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR, LangSuffix.ARPA, LangSuffix.ARPA_RESCORE],
    )
    return profile, train_dir


def test_train_artifacts_exist(profile_and_train):
    _profile, train_dir = profile_and_train
    for suffix in (LangSuffix.GRAMMAR, LangSuffix.ARPA):
        d = train_dir / lang_dir_name(suffix)
        assert (d / "words.txt").exists()
        assert (d / "g.fst").exists()
        assert (d / "g_fuzzy.fst").exists()
        assert (d / "graph.npz").exists()
    rescore = train_dir / lang_dir_name(LangSuffix.ARPA_RESCORE)
    assert (rescore / "g.fst").exists()
    assert not (rescore / "graph.npz").exists()


def test_transcribe_grammar_exact(profile_and_train):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    for i, text in enumerate(
        ["turn on the light", "turn off the fan", "never mind", "turn on fan"]
    ):
        pcm = synthesize_sentence(profile, text, seed=i)
        got = t.transcribe_pcm_batch([pcm], nbest=1)[0]
        assert got, f"no transcript for {text!r}"
        assert got[0] == text, (got, text)


def test_transcribe_batch_mixed_lengths(profile_and_train):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    texts = ["never mind", "turn on the light", "turn off light"]
    pcms = [synthesize_sentence(profile, s, seed=7 + i) for i, s in enumerate(texts)]
    got = t.transcribe_pcm_batch(pcms, nbest=1)
    assert [g[0] for g in got] == texts


def test_transcribe_arpa_graph(profile_and_train):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )
    pcm = synthesize_sentence(profile, "turn on the light", seed=42)
    got = t.transcribe_pcm_batch([pcm], nbest=3)[0]
    assert got
    assert got[0] == "turn on the light"


def test_fuzzy_accept_and_reject(profile_and_train):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )
    grammar_lang = train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    pcm = synthesize_sentence(profile, "turn on the fan", seed=5)
    # Dual-model OOV design (README.md:50-55): decode with the ARPA graph,
    # fuzzy-match the n-best against the rigid grammar lang.
    got = t.transcribe_pcm_batch(
        [pcm], lang_dir=grammar_lang, nbest=3, max_fuzzy_cost=2.0
    )[0]
    assert got == ["turn on the fan"]
    # require_fuzzy with impossible budget: rejection ("")
    got = t.transcribe_pcm_batch(
        [pcm], lang_dir=grammar_lang, nbest=3, max_fuzzy_cost=-1.0,
        require_fuzzy=True,
    )[0]
    assert got == []


def test_async_api(profile_and_train):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    pcm = synthesize_sentence(profile, "never mind", seed=9)
    import wave as wave_mod

    wav_path = str(profile.model_dir.parent / "never_mind.wav")
    with wave_mod.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())

    # asyncio.run (not get_event_loop): another test's asyncio.run may
    # have cleared the main thread's loop, and the legacy accessor then
    # raises depending on test order
    result = asyncio.run(t.async_transcribe(wav_path))
    assert result == ["never mind"]


def test_rescore(profile_and_train):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )
    pcm = synthesize_sentence(profile, "turn off the light", seed=11)
    import wave as wave_mod

    wav_path = str(profile.model_dir.parent / "rescore.wav")
    with wave_mod.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())

    got = asyncio.new_event_loop().run_until_complete(
        t.async_transcribe_rescore(
            wav_path,
            old_lang_dir=train_dir / lang_dir_name(LangSuffix.ARPA),
            new_lang_dir=train_dir / lang_dir_name(LangSuffix.ARPA_RESCORE),
            nbest=5,
        )
    )
    assert got
    assert got[0] == "turn off the light"


def test_stream_transcriber(profile_and_train):
    from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber

    profile, train_dir = profile_and_train
    t = Nnet3StreamTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    for i, text in enumerate(["turn on the light", "never mind"]):
        pcm = synthesize_sentence(profile, text, seed=20 + i)
        got = t.transcribe_pcm(pcm, chunk_samples=1024)
        assert got == [text], (got, text)


def test_stream_async_matches_batch(profile_and_train):
    from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber

    profile, train_dir = profile_and_train
    t = Nnet3StreamTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    pcm = synthesize_sentence(profile, "turn off the fan", seed=33)

    async def stream():
        data = pcm.astype(np.int16).tobytes()
        for off in range(0, len(data), 2048):
            yield data[off : off + 2048]

    async def run():
        return await t.async_transcribe(stream())

    got = asyncio.new_event_loop().run_until_complete(run())
    assert got == ["turn off the fan"]


def test_metrics_accumulate(profile_and_train):
    from rhasspy_speech_tpu.utils.metrics import get_metrics, reset_metrics

    profile, train_dir = profile_and_train
    reset_metrics()
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    pcm = synthesize_sentence(profile, "never mind", seed=50)
    t.transcribe_pcm_batch([pcm])
    m = get_metrics()
    s = m.summary()
    assert s["utterances"] == 1
    assert s["audio_seconds"] > 0
    assert set(s["stages"]) >= {"frontend", "acoustic", "decode", "backtrace"}
    assert m.rtf > 0


def test_stream_nbest_and_rescore(profile_and_train):
    from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber

    profile, train_dir = profile_and_train
    t = Nnet3StreamTranscriber(
        profile.model_dir,
        train_dir / lang_dir_name(LangSuffix.ARPA),
        nbest=4,
    )
    pcm = synthesize_sentence(profile, "turn on the light", seed=60)
    state = t.start_stream()
    for off in range(0, pcm.shape[0], 1024):
        t.process_chunk(state, pcm[off : off + 1024])
    got = t.finish_stream_rescore(
        state,
        old_lang_dir=train_dir / lang_dir_name(LangSuffix.ARPA),
        new_lang_dir=train_dir / lang_dir_name(LangSuffix.ARPA_RESCORE),
    )
    assert got
    assert got[0] == "turn on the light"


def test_oov_rejection_dual_model(profile_and_train):
    """The reference's dual-model design (README.md:50-55): in-grammar
    audio is accepted via the grammar fuzzy match; audio of a sentence the
    grammar cannot produce (but whose words exist acoustically) is
    rejected ('')."""
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )
    grammar_lang = train_dir / lang_dir_name(LangSuffix.GRAMMAR)

    # in-grammar: accepted with the exact text
    pcm = synthesize_sentence(profile, "turn off the light", seed=90)
    got = t.transcribe_pcm_batch(
        [pcm], lang_dir=grammar_lang, nbest=3, max_fuzzy_cost=1.0,
        require_fuzzy=True,
    )[0]
    assert got == ["turn off the light"]

    # out-of-grammar word order: "light the turn on" uses known words but
    # no grammar path produces it; the fuzzy compose fails -> rejection
    pcm_oov = synthesize_sentence(profile, "light the never on", seed=91)
    got = t.transcribe_pcm_batch(
        [pcm_oov], lang_dir=grammar_lang, nbest=3, max_fuzzy_cost=1.0,
        require_fuzzy=True,
    )[0]
    assert got == []


def test_sentences_db_scoring_flow(profile_and_train):
    """Reference test flow (test_en.py:45-65): decode, score against
    sentences.db, accept at norm_score <= 0.15."""
    from rhasspy_speech_tpu.grammar.sentences_db import (
        best_matching_score,
        build_sentences_db,
        load_sentences,
    )

    profile, train_dir = profile_and_train
    db = train_dir / "sentences.db"
    build_sentences_db({"sentences": SENTENCES}, db)
    rows = load_sentences(db)

    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )
    pcm = synthesize_sentence(profile, "turn on the fan", seed=92)
    texts = t.transcribe_pcm_batch([pcm], nbest=1)[0]
    assert texts
    score, output = best_matching_score(texts[0], rows)
    assert score <= 0.15
    assert output == "turn on the fan"


def test_edge_cases(profile_and_train):
    """Short/empty audio and unusual inputs don't crash the pipeline."""
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    # sub-frame audio: no frames -> no transcript, no crash
    tiny = np.zeros(100, dtype=np.float32)
    got = t.transcribe_pcm_batch([tiny])[0]
    assert isinstance(got, list)
    # pure silence: decodes to something in-grammar or nothing; no crash
    silence = np.zeros(16000, dtype=np.float32)
    got = t.transcribe_pcm_batch([silence], nbest=2)
    assert isinstance(got[0], list)
    # mixed batch of tiny + real audio
    pcm = synthesize_sentence(profile, "never mind", seed=70)
    got = t.transcribe_pcm_batch([tiny, pcm])
    assert got[1] == ["never mind"]


def test_retrain_overwrites(profile_and_train, tmp_path):
    """Training twice into the same dir keeps working (reference wipes
    data/graph dirs, kaldi.py:91-99)."""
    profile, _ = profile_and_train
    train_dir = tmp_path / "train2"
    intents = {"language": "en",
               "intents": {"M": {"data": [{"sentences": ["never mind"]}]}}}
    train_model_sync("en", intents, train_dir, profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    # second train with a different grammar replaces the artifacts
    intents2 = {"language": "en",
                "intents": {"M": {"data": [{"sentences": ["turn on the light"]}]}}}
    train_model_sync("en", intents2, train_dir, profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    pcm = synthesize_sentence(profile, "turn on the light", seed=80)
    assert t.transcribe_pcm_batch([pcm])[0] == ["turn on the light"]


def test_full_scale_grammar_decode(tmp_path):
    """The committed flagship grammar (3,701 sentences) -> dense graph ->
    decode synthesized sentences exactly."""
    import io as _io
    import re

    from rhasspy_speech_tpu.grammar import Intents, compile_intents
    from rhasspy_speech_tpu.lexicon import LexiconDatabase
    from rhasspy_speech_tpu.testing import build_synthetic_profile

    intents_dict = flagship_intents_dict()
    ctx = compile_intents(
        Intents.from_dict(intents_dict), _io.StringIO(), LexiconDatabase(),
        number_language="en",
    )
    lexicon = {
        w: [f"p{ord(c)}" for c in re.sub(r"\s", "", w)] or ["px"]
        for w in sorted(ctx.vocab)
    }
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_dir = tmp_path / "train"
    train_model_sync("en", intents_dict, train_dir, profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR])
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    for i, text in enumerate(
        ["turn on the kitchen lights", "what time is it"]
    ):
        pcm = synthesize_sentence(profile, text, seed=95 + i)
        got = t.transcribe_pcm_batch([pcm])[0]
        assert got == [text], (got, text)


def test_full_scale_arpa_decode(tmp_path):
    """The committed flagship grammar's ARPA graph: decode + fuzzy accept."""
    import io as _io
    import re

    from rhasspy_speech_tpu.grammar import Intents, compile_intents
    from rhasspy_speech_tpu.lexicon import LexiconDatabase
    from rhasspy_speech_tpu.testing import build_synthetic_profile

    intents_dict = flagship_intents_dict()
    ctx = compile_intents(
        Intents.from_dict(intents_dict), _io.StringIO(), LexiconDatabase(),
        number_language="en",
    )
    lexicon = {
        w: [f"p{ord(c)}" for c in re.sub(r"\s", "", w)] or ["px"]
        for w in sorted(ctx.vocab)
    }
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_dir = tmp_path / "train"
    train_model_sync("en", intents_dict, train_dir, profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR, LangSuffix.ARPA])
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )
    text = "turn off the kitchen lights"
    pcm = synthesize_sentence(profile, text, seed=99)
    got = t.transcribe_pcm_batch(
        [pcm],
        lang_dir=train_dir / lang_dir_name(LangSuffix.GRAMMAR),
        nbest=3, max_fuzzy_cost=1.5, require_fuzzy=True,
    )[0]
    assert got == [text], got


def test_get_lattice(profile_and_train, tmp_path):
    profile, train_dir = profile_and_train
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    pcm = synthesize_sentence(profile, "turn on the light", seed=44)
    import wave as wave_mod

    wav = tmp_path / "lat.wav"
    with wave_mod.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    lat = t.get_lattice(wav)
    assert lat is not None and lat.num_arcs() > 0
    words, cost = lat.shortest_path_words(t.artifacts.graph)
    text = " ".join(
        t.artifacts.words.find_id(w) for w in words
        if t.artifacts.words.find_id(w) not in ("<eps>",)
    )
    assert text == "turn on the light"


def test_confidence(profile_and_train):
    """Confidence is ~1.0 for clean in-grammar audio; with the acoustic
    evidence scaled away, grammar rivals tie and confidence collapses."""
    profile, train_dir = profile_and_train
    lang = train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    pcm = synthesize_sentence(profile, "turn on the light", seed=7)

    hi = Nnet3WavTranscriber(profile.model_dir, lang)
    lo = Nnet3WavTranscriber(profile.model_dir, lang, acoustic_scale=1e-5)
    c_hi = hi.confidence_pcm(pcm)
    c_lo = lo.confidence_pcm(pcm)
    assert c_hi > 0.99, c_hi
    assert 0.0 < c_lo < 0.9, c_lo


def test_recurrent_profile_end_to_end(tmp_path):
    """A profile whose AM carries a real LSTM-style back-edge at delay 3
    (ring depth 3 at subsampling 1) decodes exactly through the batch,
    streaming, and batched-scheduler paths."""
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
    from rhasspy_speech_tpu.pipeline.stream import Nnet3StreamTranscriber

    lex = {k: LEXICON[k] for k in ("turn", "on", "off", "light")}
    profile = build_synthetic_profile(tmp_path / "m", lex, recurrent_delay=3)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [
            {"sentences": ["turn (on|off) light"]}]}}},
        tmp_path / "t",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang = tmp_path / "t" / lang_dir_name(LangSuffix.GRAMMAR)

    t = Nnet3WavTranscriber(profile.model_dir, lang)
    m = t.am.compiled(16).model
    assert m.recurrent and m.recurrence == 3 and m.carry_depths == (3,)
    pcm = synthesize_sentence(profile, "turn off light", seed=5)
    assert t.transcribe_pcm_batch([pcm])[0] == ["turn off light"]

    st = Nnet3StreamTranscriber(profile.model_dir, lang)
    assert st.transcribe_pcm(pcm, chunk_samples=1024) == ["turn off light"]

    sched = StreamScheduler(profile.model_dir, lang, max_streams=4)
    texts = ["turn on light", "turn off light"]
    sids = [sched.open_stream() for _ in texts]
    pcms = [synthesize_sentence(profile, s, seed=10 + i)
            for i, s in enumerate(texts)]
    offs = [0, 0]
    while any(o < p.shape[0] for o, p in zip(offs, pcms)):
        for i, sid in enumerate(sids):
            if offs[i] < pcms[i].shape[0]:
                sched.feed(sid, pcms[i][offs[i] : offs[i] + 1600])
                offs[i] += 1600
        sched.step()
    for sid in sids:
        sched.finish(sid)
    sched.run_until_idle()
    for want, sid in zip(texts, sids):
        got = sched.poll(sid)
        assert got and got[0] == want, (want, got)


def test_silence_weighted_ivector_decode(tmp_path):
    """Decoder-driven silence weighting (OnlineSilenceWeighting equivalent):
    a first-pass alignment downweights silence frames in the i-vector
    stats; the weighted second pass still decodes exactly."""
    import jax.numpy as jnp

    from rhasspy_speech_tpu.ops.frontend import num_frames
    from rhasspy_speech_tpu.ops.ivector import extract_ivectors
    from rhasspy_speech_tpu.testing.synthetic import _silence_wave

    lex = {k: LEXICON[k] for k in ("turn", "on", "off", "light")}
    profile = build_synthetic_profile(tmp_path / "m", lex, with_ivector=True)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [
            {"sentences": ["turn (on|off) light"]}]}}},
        tmp_path / "t",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang = tmp_path / "t" / lang_dir_name(LangSuffix.GRAMMAR)

    pcm = synthesize_sentence(profile, "turn on light", seed=1)
    sil = _silence_wave(16000, np.random.RandomState(0))[:8000]
    pcm_sil = np.concatenate([sil, pcm, sil])

    t = Nnet3WavTranscriber(profile.model_dir, lang)
    assert t.am.ivector_params is not None
    assert t.transcribe_pcm_batch([pcm_sil])[0] == ["turn on light"]

    tw = Nnet3WavTranscriber(profile.model_dir, lang, silence_weight=0.0)
    assert tw.transcribe_pcm_batch([pcm_sil])[0] == ["turn on light"]

    # weights from the first-pass alignment: silence edges 0, speech 1
    cfg = tw.am.frontend_config
    sub = tw.am.subsampling
    n_out = -(-num_frames(cfg, pcm_sil.shape[0]) // sub)
    feats = tw.am.features(pcm_sil[None])
    lp = tw.am.log_probs(feats, n_out)
    w = np.asarray(
        tw._silence_frame_weights(lp, jnp.asarray([n_out]), feats.shape[1])
    )
    assert w.shape == (1, feats.shape[1])
    assert w[0, :10].mean() < 0.5
    assert w[0, w.shape[1] // 2] == 1.0

    # and the weights genuinely change the extracted i-vector
    iv_plain = np.asarray(extract_ivectors(feats, tw.am.ivector_params))
    iv_weighted = np.asarray(
        extract_ivectors(feats, tw.am.ivector_params,
                         frame_weights=jnp.asarray(w))
    )
    assert np.abs(iv_plain - iv_weighted).max() > 1e-3


def test_train_with_kneser_ney(tmp_path):
    """smoothing='kneser_ney' trains a working ARPA decode graph."""
    lex = {k: LEXICON[k] for k in ("turn", "on", "off", "light", "fan")}
    profile = build_synthetic_profile(tmp_path / "m", lex)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [
            {"sentences": ["turn (on|off) (light|fan)"]}]}}},
        tmp_path / "t",
        profile.model_dir,
        lang_suffixes=[LangSuffix.ARPA],
        smoothing="kneser_ney",
    )
    t = Nnet3WavTranscriber(
        profile.model_dir, tmp_path / "t" / lang_dir_name(LangSuffix.ARPA)
    )
    pcm = synthesize_sentence(profile, "turn off fan", seed=2)
    assert t.transcribe_pcm_batch([pcm], nbest=3)[0][0] == "turn off fan"


def test_real_wavs_through_full_scale_graph(tmp_path):
    """The reference's real speech fixtures (tests/wav/*.wav, incl. the
    out-of-grammar 'spell' negatives) run through the full-scale flagship
    grammar pipeline without crashing, and fuzzy-gated output is closed
    over the grammar: every non-empty transcript uses only grammar
    vocabulary (test_en.py:40-65's acceptance/rejection structure; exact
    transcripts need the real acoustic model, which is not downloadable
    here). The WAVs come from RSTPU_FIXTURES_DIR/wav."""
    import os
    import wave as wave_mod

    fixtures = os.environ.get("RSTPU_FIXTURES_DIR")
    wav_dir = os.path.join(fixtures, "wav") if fixtures else None
    if wav_dir is None or not os.path.isdir(wav_dir):
        pytest.skip("RSTPU_FIXTURES_DIR/wav (reference WAV fixtures) not set")

    import io as _io
    import re

    from rhasspy_speech_tpu.grammar import Intents, compile_intents
    from rhasspy_speech_tpu.lexicon import LexiconDatabase

    intents_dict = flagship_intents_dict()
    ctx = compile_intents(
        Intents.from_dict(intents_dict), _io.StringIO(), LexiconDatabase(),
        number_language="en",
    )
    lexicon = {
        w: [f"p{ord(c)}" for c in re.sub(r"\s", "", w)] or ["px"]
        for w in sorted(ctx.vocab)
    }
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_dir = tmp_path / "train"
    train_model_sync("en", intents_dict, train_dir, profile.model_dir,
                     lang_suffixes=[LangSuffix.GRAMMAR, LangSuffix.ARPA])
    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.ARPA)
    )

    names = ["avada-kedavra.wav", "lumioso.wav", "what-time-is-it.wav",
             "turn-off-basement-light.wav", "nevermind.wav"]
    pcms = []
    for name in names:
        with wave_mod.open(os.path.join(wav_dir, name), "rb") as w:
            assert w.getframerate() == 16000 and w.getnchannels() == 1
            pcms.append(
                np.frombuffer(w.readframes(w.getnframes()), np.int16)
                .astype(np.float32)
            )

    results = t.transcribe_pcm_batch(
        pcms,
        lang_dir=train_dir / lang_dir_name(LangSuffix.GRAMMAR),
        nbest=3, max_fuzzy_cost=0.5, require_fuzzy=True,
    )
    vocab = set(ctx.vocab)
    for name, texts in zip(names, results):
        assert isinstance(texts, list), name
        for text in texts:
            for tok in text.split():
                assert tok in vocab, (name, text, tok)


def test_transcribe_non_16k_wav_resampled(profile_and_train, tmp_path):
    """A 22.05 kHz stereo WAV decodes to the right text: read_wav routes
    through the native decoder + windowed-sinc resampler (the job the
    reference delegates to sox, tests/resample.py)."""
    import wave as _wave

    from rhasspy_speech_tpu.native import resample
    from rhasspy_speech_tpu.pipeline.transcribe import read_wav

    profile, train_dir = profile_and_train
    pcm16k = synthesize_sentence(profile, "turn on the light", seed=77)
    pcm22k = resample(pcm16k, 16000, 22050)
    stereo = np.stack([pcm22k, pcm22k], axis=-1)
    path = tmp_path / "in22k.wav"
    with _wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(
            np.clip(stereo, -32768, 32767).astype("<i2").tobytes()
        )

    back = read_wav(path)
    # round-trip 16k -> 22.05k -> 16k keeps length within one frame
    assert abs(back.shape[0] - pcm16k.shape[0]) < 160

    t = Nnet3WavTranscriber(
        profile.model_dir, train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    )
    assert t.transcribe(path) == ["turn on the light"]
