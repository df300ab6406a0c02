"""i-vector subsystem tests: parser roundtrips + JAX vs NumPy reference."""

import io

import numpy as np

import jax.numpy as jnp

from rhasspy_speech_tpu.io.ivector import (
    DiagGmm,
    IvectorExtractor,
    OnlineIvectorConfig,
    parse_conf,
)
from rhasspy_speech_tpu.io.kaldi_io import KaldiReader, KaldiWriter
from rhasspy_speech_tpu.ops.ivector import (
    extract_ivectors,
    extract_ivectors_online,
    ivector_numpy,
    make_ivector_params,
    splice_frames,
)


def _synthetic_system(rng, num_gauss=16, lda_out=12, ivec_dim=8, base_dim=6,
                      splice=3):
    spliced_dim = base_dim * (2 * splice + 1)
    means = rng.randn(num_gauss, lda_out) * 2.0
    variances = 0.5 + rng.rand(num_gauss, lda_out)
    weights = rng.dirichlet(np.ones(num_gauss))
    dubm = DiagGmm.from_means_vars(weights, means, variances)

    M = (rng.randn(num_gauss, lda_out, ivec_dim) * 0.3).astype(np.float64)
    sigma_inv = np.zeros((num_gauss, lda_out, lda_out))
    for i in range(num_gauss):
        a = rng.randn(lda_out, lda_out) * 0.1
        sigma_inv[i] = np.eye(lda_out) + a @ a.T
    extractor = IvectorExtractor(
        w=np.zeros((0, 0), dtype=np.float32),
        w_vec=weights.astype(np.float32),
        M=M.astype(np.float32),
        sigma_inv=sigma_inv.astype(np.float32),
        prior_offset=4.0,
    )
    lda = (rng.randn(lda_out, spliced_dim + 1) * 0.2).astype(np.float32)
    return dubm, extractor, lda


def test_diag_gmm_roundtrip():
    rng = np.random.RandomState(0)
    dubm, _, _ = _synthetic_system(rng)
    buf = io.BytesIO()
    dubm.write(KaldiWriter(buf))
    buf.seek(0)
    dubm2 = DiagGmm.read(KaldiReader(buf))
    np.testing.assert_allclose(dubm2.gconsts, dubm.gconsts, rtol=1e-6)
    np.testing.assert_allclose(dubm2.inv_vars, dubm.inv_vars, rtol=1e-6)


def test_extractor_roundtrip():
    rng = np.random.RandomState(1)
    _, extractor, _ = _synthetic_system(rng)
    buf = io.BytesIO()
    extractor.write(KaldiWriter(buf))
    buf.seek(0)
    ex2 = IvectorExtractor.read(KaldiReader(buf))
    np.testing.assert_allclose(ex2.M, extractor.M, rtol=1e-6)
    np.testing.assert_allclose(ex2.sigma_inv, extractor.sigma_inv, atol=1e-6)
    assert ex2.prior_offset == extractor.prior_offset


def test_parse_conf():
    conf = parse_conf(
        "--num-gselect=5\n--min-post=0.025\n# comment\n--posterior-scale=0.1\n",
        is_text=True,
    )
    cfg = OnlineIvectorConfig.from_conf(conf)
    assert cfg.num_gselect == 5
    assert cfg.min_post == 0.025


def test_splice_clamps_edges():
    feats = jnp.asarray(np.arange(12, dtype=np.float32).reshape(1, 4, 3))
    out = np.asarray(splice_frames(feats, 1, 1))
    assert out.shape == (1, 4, 9)
    # first frame: left context clamped to frame 0
    np.testing.assert_array_equal(out[0, 0, :3], out[0, 0, 3:6])


# f32 device results against the float64 NumPy reference: the matmuls run
# at Precision.HIGHEST, so what remains is f32 summation order in the
# posterior stats and the Cholesky solve (~1e-4 relative), with headroom.
_IV_TOL = 2e-3


def test_ivector_matches_numpy_reference():
    rng = np.random.RandomState(3)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = OnlineIvectorConfig(ivector_period=5)
    params = make_ivector_params(dubm, extractor, lda, cfg)

    B, T, D = 3, 40, 6
    feats = rng.randn(B, T, D).astype(np.float32)
    got = np.asarray(extract_ivectors(jnp.asarray(feats), params))
    assert got.shape == (B, extractor.ivector_dim)
    for b in range(B):
        want = ivector_numpy(feats[b].astype(np.float64), dubm, extractor, lda, cfg)
        np.testing.assert_allclose(got[b], want, rtol=_IV_TOL, atol=_IV_TOL)


def test_ivector_online_final_matches_whole():
    """The last periodic estimate equals the whole-utterance estimate when
    T is a multiple of the period."""
    rng = np.random.RandomState(4)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = OnlineIvectorConfig(ivector_period=10)
    params = make_ivector_params(dubm, extractor, lda, cfg)
    feats = rng.randn(2, 30, 6).astype(np.float32)
    whole = np.asarray(extract_ivectors(jnp.asarray(feats), params))
    online = np.asarray(extract_ivectors_online(jnp.asarray(feats), params))
    assert online.shape[1] == 3
    np.testing.assert_allclose(online[:, -1], whole, rtol=_IV_TOL, atol=_IV_TOL)


def test_ivector_lengths_masking():
    rng = np.random.RandomState(5)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = OnlineIvectorConfig()
    params = make_ivector_params(dubm, extractor, lda, cfg)
    feats = rng.randn(1, 20, 6).astype(np.float32)
    full = np.asarray(extract_ivectors(jnp.asarray(feats[:, :12]), params))
    # Masked frames must not leak... note splice context at the boundary
    # differs (clamp vs real frames), so compare against a clamped copy.
    padded = np.concatenate(
        [feats[:, :12], np.repeat(feats[:, 11:12], 8, axis=1)], axis=1
    )
    masked = np.asarray(
        extract_ivectors(
            jnp.asarray(padded), params, lengths=jnp.asarray([12])
        )
    )
    np.testing.assert_allclose(masked, full, rtol=1e-3, atol=1e-3)


def test_acoustic_model_uses_extractor(tmp_path):
    """AcousticModel wires model_dir/extractor/ into the forward pass."""
    from rhasspy_speech_tpu.io import write_nnet3
    from rhasspy_speech_tpu.io.kaldi_io import KaldiWriter
    from rhasspy_speech_tpu.io.transition_model import KaldiTransitionModel
    from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    rng = np.random.RandomState(7)
    # AM expecting an 8-dim ivector; frontend must be 6-dim MFCC to match
    # the synthetic extractor's base_dim
    spec = build_tdnnf_spec(
        num_pdfs=20, input_dim=6, ivector_dim=8,
        hidden_dim=32, bottleneck_dim=8, num_tdnnf_layers=2,
    )
    tm = KaldiTransitionModel.from_monophone_chain(10)
    (tmp_path / "model").mkdir()
    with open(tmp_path / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=tm)
    import json

    with open(tmp_path / "model" / "frontend.json", "w") as f:
        json.dump({"num_mel_bins": 7, "num_ceps": 6}, f)

    dubm, extractor, lda = _synthetic_system(rng, ivec_dim=8, base_dim=6)
    ext = tmp_path / "extractor"
    ext.mkdir()
    with open(ext / "final.dubm", "wb") as f:
        dubm.write(KaldiWriter(f))
    with open(ext / "final.ie", "wb") as f:
        extractor.write(KaldiWriter(f))
    with open(ext / "final.mat", "wb") as f:
        KaldiWriter(f).write_matrix(lda)

    am = AcousticModel(tmp_path)
    assert am.ivector_params is not None
    pcm = (1000 * rng.randn(2, 8000)).astype(np.float32)
    feats = am.features(pcm)
    out = am.log_probs(feats, num_out_frames=8)
    assert out.shape == (2, 8, 20)
    assert np.isfinite(np.asarray(out)).all()


def test_frame_weights_silence_downweighting():
    """Frames with zero weight contribute nothing to the ivector
    (OnlineSilenceWeighting effect)."""
    rng = np.random.RandomState(9)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = OnlineIvectorConfig()
    params = make_ivector_params(dubm, extractor, lda, cfg)
    speech = rng.randn(1, 10, 6).astype(np.float32)
    noise = 5.0 + rng.randn(1, 10, 6).astype(np.float32)
    both = np.concatenate([speech, noise], axis=1)

    iv_speech_only = np.asarray(extract_ivectors(jnp.asarray(speech), params))
    weights = np.concatenate(
        [np.ones((1, 10), np.float32), np.zeros((1, 10), np.float32)], axis=1
    )
    iv_weighted = np.asarray(
        extract_ivectors(
            jnp.asarray(both), params, frame_weights=jnp.asarray(weights)
        )
    )
    iv_unweighted = np.asarray(extract_ivectors(jnp.asarray(both), params))
    # splice context at the 10-frame boundary leaks a little; the weighted
    # estimate must sit far closer to the speech-only one
    d_weighted = np.abs(iv_weighted - iv_speech_only).max()
    d_unweighted = np.abs(iv_unweighted - iv_speech_only).max()
    assert d_weighted < 0.5 * d_unweighted, (d_weighted, d_unweighted)


def test_acoustic_model_ivector_cmvn(tmp_path):
    """global_cmvn.stats in the extractor dir changes the ivector input."""
    import json

    from rhasspy_speech_tpu.io import write_nnet3
    from rhasspy_speech_tpu.io.kaldi_io import KaldiWriter
    from rhasspy_speech_tpu.io.transition_model import KaldiTransitionModel
    from rhasspy_speech_tpu.ops.cmvn import matrix_from_stats
    from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    rng = np.random.RandomState(11)
    spec = build_tdnnf_spec(
        num_pdfs=20, input_dim=6, ivector_dim=8,
        hidden_dim=32, bottleneck_dim=8, num_tdnnf_layers=2,
    )
    tm = KaldiTransitionModel.from_monophone_chain(10)
    (tmp_path / "model").mkdir()
    with open(tmp_path / "model" / "final.mdl", "wb") as f:
        write_nnet3(f, spec, transition_model=tm)
    with open(tmp_path / "model" / "frontend.json", "w") as f:
        json.dump({"num_mel_bins": 7, "num_ceps": 6}, f)

    dubm, extractor, lda = _synthetic_system(rng, ivec_dim=8, base_dim=6)
    ext = tmp_path / "extractor"
    ext.mkdir()
    with open(ext / "final.dubm", "wb") as f:
        dubm.write(KaldiWriter(f))
    with open(ext / "final.ie", "wb") as f:
        extractor.write(KaldiWriter(f))
    with open(ext / "final.mat", "wb") as f:
        KaldiWriter(f).write_matrix(lda)
    stats = matrix_from_stats(
        np.full(6, 500.0), np.full(6, 2600.0), 100.0
    )
    with open(ext / "global_cmvn.stats", "wb") as f:
        KaldiWriter(f).write_matrix(stats.astype(np.float64))

    am = AcousticModel(tmp_path)
    assert am.ivector_cmvn_stats is not None
    pcm = (1000 * rng.randn(1, 8000)).astype(np.float32)
    out = am.log_probs(am.features(pcm), num_out_frames=8)
    assert np.isfinite(np.asarray(out)).all()


def test_ivector_padding_independence():
    """lengths masking makes a padded batch member's i-vector equal its
    unpadded solo i-vector (mixed-length transcribe batches)."""
    rng = np.random.RandomState(11)
    dubm, extractor, lda = _synthetic_system(rng)
    cfg = OnlineIvectorConfig()
    params = make_ivector_params(dubm, extractor, lda, cfg)

    short = rng.randn(1, 12, 6).astype(np.float32)
    padded = np.concatenate([short, np.zeros((1, 20, 6), np.float32)], axis=1)

    iv_solo = np.asarray(extract_ivectors(jnp.asarray(short), params))
    iv_masked = np.asarray(
        extract_ivectors(
            jnp.asarray(padded), params, lengths=jnp.asarray([12])
        )
    )
    iv_unmasked = np.asarray(extract_ivectors(jnp.asarray(padded), params))
    # masked == solo up to splice-context edge effects; unmasked differs more
    d_masked = np.abs(iv_masked - iv_solo).max()
    d_unmasked = np.abs(iv_unmasked - iv_solo).max()
    assert d_masked < 0.35 * d_unmasked, (d_masked, d_unmasked)
