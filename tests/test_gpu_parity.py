"""GPU parity against the plain references: MFCC, i-vectors, the f32 AM,
dense decoding and bf16 transcripts, computed on the card.

Each test takes the ``gpu_device`` fixture, so it skips where JAX sees no
GPU; ``python chip_smoke.py`` runs them on the card. Tolerances: MFCC
1e-4 of the largest magnitude (cuFFT sums in another order than NumPy's
FFT), i-vectors rtol = atol = 2e-3 (as on the CPU), the f32 AM 1e-3
relative (matmuls at Precision.HIGHEST), decode costs 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rhasspy_speech_tpu.graph.dense import viterbi_numpy
from rhasspy_speech_tpu.ops.decoder import DeviceGraph, backtrace_words, viterbi
from rhasspy_speech_tpu.ops.frontend import (
    FrontendConfig,
    make_frontend_params,
    mfcc_batch,
    mfcc_numpy,
)
from rhasspy_speech_tpu.ops.ivector import (
    OnlineIvectorConfig,
    extract_ivectors,
    ivector_numpy,
    make_ivector_params,
)

pytestmark = pytest.mark.gpu


def _on(device, x):
    return jax.device_put(jnp.asarray(x), device)


def test_mfcc_matches_numpy_reference(gpu_device):
    cfg = FrontendConfig(num_mel_bins=40, num_ceps=40)
    rng = np.random.RandomState(0)
    pcm = (1000.0 * rng.randn(4, 16000)).astype(np.float32)
    with jax.default_device(gpu_device):
        got = np.asarray(mfcc_batch(make_frontend_params(cfg), _on(gpu_device, pcm)))
    for b in range(pcm.shape[0]):
        want = mfcc_numpy(cfg, pcm[b])
        err = np.abs(got[b] - want).max() / np.abs(want).max()
        assert err <= 1e-4, err


def test_ivector_matches_numpy_reference(gpu_device):
    from test_ivector import _synthetic_system

    rng = np.random.RandomState(3)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = OnlineIvectorConfig(ivector_period=5)
    feats = rng.randn(3, 40, 6).astype(np.float32)
    with jax.default_device(gpu_device):
        params = make_ivector_params(dubm, extractor, lda, cfg)
        got = np.asarray(extract_ivectors(_on(gpu_device, feats), params))
    for b in range(feats.shape[0]):
        want = ivector_numpy(
            feats[b].astype(np.float64), dubm, extractor, lda, cfg
        )
        np.testing.assert_allclose(got[b], want, rtol=2e-3, atol=2e-3)


def test_am_f32_matches_cpu(gpu_device):
    from rhasspy_speech_tpu.models import compile_nnet3
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    spec = build_tdnnf_spec(
        num_pdfs=512, input_dim=40, ivector_dim=100, hidden_dim=768,
        num_tdnnf_layers=3,
    )
    model = compile_nnet3(spec, num_out_frames=20, subsampling=3)
    lo, hi = model.ranges["input"]
    rng = np.random.RandomState(1)
    feats = rng.randn(4, hi - lo, 40).astype(np.float32)
    ivec = rng.randn(4, 100).astype(np.float32)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(gpu_device):
        got = np.asarray(jax.jit(model.forward)(feats, ivec))
    with jax.default_device(cpu):
        want = np.asarray(
            jax.jit(compile_nnet3(spec, 20, subsampling=3).forward)(feats, ivec)
        )
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-3


def test_decode_matches_numpy_reference(gpu_device):
    from test_decoder import _random_graph

    rng = np.random.RandomState(0)
    graph = _random_graph(rng, num_states=40, num_pdfs=12, extra_arcs=120)
    log_probs = np.log(
        rng.dirichlet(np.ones(graph.num_pdfs), size=(6, 25))
    ).astype(np.float32)
    with jax.default_device(gpu_device):
        dev = DeviceGraph.from_dense(graph)
        alpha, bp = viterbi(dev, _on(gpu_device, log_probs), acoustic_scale=0.8)
    alpha, bp = np.asarray(alpha), np.asarray(bp)
    for b in range(log_probs.shape[0]):
        want_words, want_cost = viterbi_numpy(graph, log_probs[b], 0.8)
        got_words, got_cost = backtrace_words(graph, alpha, bp, b)
        np.testing.assert_allclose(got_cost, want_cost, rtol=1e-4, atol=1e-4)
        assert got_words == want_words


def test_bf16_transcripts_equal_f32(gpu_device, tmp_path):
    from test_bf16 import LEXICON, SENTENCES

    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )

    profile = build_synthetic_profile(
        tmp_path / "model", LEXICON, with_ivector=True
    )
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [
            {"sentences": ["turn (on|off) [the] (light|fan)"]}]}}},
        tmp_path / "train", profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    pcms = [synthesize_sentence(profile, s, seed=30 + i)
            for i, s in enumerate(SENTENCES)]
    with jax.default_device(gpu_device):
        t32 = Nnet3WavTranscriber(profile.model_dir, lang_dir)
        t16 = Nnet3WavTranscriber(
            profile.model_dir, lang_dir, compute_dtype="bfloat16"
        )
        got32 = t32.transcribe_pcm_batch(pcms)
        got16 = t16.transcribe_pcm_batch(pcms)
    assert got32 == [[s] for s in SENTENCES]
    assert got16 == got32
