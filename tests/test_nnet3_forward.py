"""nnet3 forward compiler tests vs a hand-written NumPy evaluation."""

import io

import numpy as np

import jax
import jax.numpy as jnp

from rhasspy_speech_tpu.io import KaldiReader, read_nnet3, write_nnet3
from rhasspy_speech_tpu.models import compile_nnet3
from tests.test_kaldi_io import _synthetic_tdnnf_spec


def _relu(x):
    return np.maximum(x, 0.0)


def _manual_forward(spec, feats, ivec, out_ts):
    """Independent NumPy evaluation of the synthetic tdnnf spec at absolute
    input times out_ts. feats is indexed by absolute time (0-based array);
    caller guarantees needed context exists."""
    c = spec.components
    lda_w = c["lda"].attrs["LinearParams"]
    lda_b = c["lda"].attrs["BiasParams"]
    a1_w = c["tdnn1.affine"].attrs["LinearParams"]
    a1_b = c["tdnn1.affine"].attrs["BiasParams"]
    bn = c["tdnn1.batchnorm"].attrs
    bn_scale = bn["TargetRms"] / np.sqrt(bn["StatsVar"] + bn["Epsilon"])
    lin_w = c["tdnnf2.linear"].attrs["LinearParams"]
    aff_w = c["tdnnf2.affine"].attrs["LinearParams"]
    aff_b = c["tdnnf2.affine"].attrs["BiasParams"]
    out_w = c["output.affine"].attrs["LinearParams"]
    out_b = c["output.affine"].attrs["BiasParams"]

    def lda(t):
        x = np.concatenate([feats[t - 1], feats[t], feats[t + 1], ivec])
        return lda_w @ x + lda_b

    def bn1(t):
        h = _relu(a1_w @ lda(t) + a1_b)
        return (h - bn["StatsMean"]) * bn_scale

    def lin(t):
        return lin_w @ np.concatenate([bn1(t - 1), bn1(t)])

    def aff(t):
        return aff_w @ np.concatenate([lin(t), lin(t + 1)]) + aff_b

    return np.stack([out_w @ aff(t) + out_b for t in out_ts])


def test_context_computation():
    rng = np.random.RandomState(0)
    spec = _synthetic_tdnnf_spec(rng)
    model = compile_nnet3(spec, num_out_frames=4, subsampling=3)
    # lda: +-1; tdnnf2.linear: -1; tdnnf2.affine: +1  => left 2+1=3? No:
    # left = 1 (lda) + 1 (linear offset -1) = 2; right = 1 (lda) + 1 (affine +1) = 2
    assert model.left_context == 2
    assert model.right_context == 2
    assert model.num_input_frames == 2 + (3 * 3 + 1) + 2  # lo..last_t+rc


def test_forward_matches_manual():
    rng = np.random.RandomState(3)
    spec = _synthetic_tdnnf_spec(rng)
    model = compile_nnet3(spec, num_out_frames=4, subsampling=3)

    B = 2
    T_in = model.num_input_frames
    feats = rng.randn(B, T_in, 16).astype(np.float32)
    ivec = rng.randn(B, 8).astype(np.float32)

    got = np.asarray(model.forward(jnp.asarray(feats), jnp.asarray(ivec)))
    assert got.shape == (B, 4, 20)

    # Manual evaluation: absolute array index of output time t is
    # t + left_context
    lc = model.left_context
    out_ts = [t * 3 + lc for t in range(4)]
    for b in range(B):
        want = _manual_forward(spec, feats[b].astype(np.float64),
                               ivec[b].astype(np.float64), out_ts)
        # rtol 2e-4: the TdnnComponent forward sums one matmul per time
        # offset (not concat-then-matmul), so f32 accumulation order
        # differs from the f64 reference by ~1e-4 relative
        np.testing.assert_allclose(got[b], want, rtol=2e-4, atol=1e-4)


def test_forward_after_file_roundtrip():
    """Parse-from-bytes model produces identical outputs."""
    rng = np.random.RandomState(4)
    spec = _synthetic_tdnnf_spec(rng)
    buf = io.BytesIO()
    write_nnet3(buf, spec)
    buf.seek(0)
    spec2 = read_nnet3(KaldiReader(buf))

    m1 = compile_nnet3(spec, num_out_frames=3, subsampling=3)
    m2 = compile_nnet3(spec2, num_out_frames=3, subsampling=3)
    B = 1
    feats = rng.randn(B, m1.num_input_frames, 16).astype(np.float32)
    ivec = rng.randn(B, 8).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(m1.forward(jnp.asarray(feats), jnp.asarray(ivec))),
        np.asarray(m2.forward(jnp.asarray(feats), jnp.asarray(ivec))),
        rtol=1e-6,
    )


def test_forward_jit():
    rng = np.random.RandomState(5)
    spec = _synthetic_tdnnf_spec(rng)
    model = compile_nnet3(spec, num_out_frames=4, subsampling=3)
    fwd = jax.jit(model.forward)
    B = 3
    feats = jnp.asarray(rng.randn(B, model.num_input_frames, 16).astype(np.float32))
    ivec = jnp.asarray(rng.randn(B, 8).astype(np.float32))
    out1 = np.asarray(fwd(feats, ivec))
    out2 = np.asarray(model.forward(feats, ivec))
    # XLA fuses the per-offset matmul sums differently under jit; ~1e-5
    # relative drift is reorder noise, not a semantic difference
    np.testing.assert_allclose(out1, out2, rtol=1e-4, atol=1e-4)


def test_subsampling_one():
    rng = np.random.RandomState(6)
    spec = _synthetic_tdnnf_spec(rng)
    model = compile_nnet3(spec, num_out_frames=5, subsampling=1)
    assert model.num_input_frames == 5 + 4  # chunk + lc + rc
    feats = jnp.asarray(rng.randn(1, model.num_input_frames, 16).astype(np.float32))
    ivec = jnp.asarray(rng.randn(1, 8).astype(np.float32))
    out = model.forward(feats, ivec)
    assert out.shape == (1, 5, 20)


def _lstmp_spec(rng, D=6, C=5, R=4, delay=-1):
    """Minimal Kaldi-style LSTMP layer: W_all affine over (input, r_{t-1}),
    LstmNonlinearityComponent over (4C gates, c_{t-1}), dim-range c/m,
    recurrent projection r, output affine."""
    from rhasspy_speech_tpu.io import ComponentSpec, NodeSpec, Nnet3Spec, parse_descriptor

    comps = {
        "W_all": ComponentSpec(
            "W_all", "NaturalGradientAffineComponent",
            {"LearningRate": 1e-3,
             "LinearParams": (rng.randn(4 * C, D + R) * 0.3).astype(np.float32),
             "BiasParams": (rng.randn(4 * C) * 0.1).astype(np.float32),
             "RankIn": 20, "RankOut": 80, "UpdatePeriod": 4,
             "NumSamplesHistory": 2000.0, "Alpha": 4.0},
        ),
        "lstm_nonlin": ComponentSpec(
            "lstm_nonlin", "LstmNonlinearityComponent",
            {"LearningRate": 1e-3,
             "Params": (rng.randn(3, C) * 0.2).astype(np.float32),
             "ValueAvg": np.zeros((0, 0), np.float32),
             "DerivAvg": np.zeros((0, 0), np.float32),
             "Count": 0.0},
        ),
        "W_r": ComponentSpec(
            "W_r", "NaturalGradientAffineComponent",
            {"LearningRate": 1e-3,
             "LinearParams": (rng.randn(R, C) * 0.4).astype(np.float32),
             "BiasParams": np.zeros(R, np.float32),
             "RankIn": 20, "RankOut": 80, "UpdatePeriod": 4,
             "NumSamplesHistory": 2000.0, "Alpha": 4.0},
        ),
        "W_out": ComponentSpec(
            "W_out", "NaturalGradientAffineComponent",
            {"LearningRate": 1e-3,
             "LinearParams": (rng.randn(3, R) * 0.5).astype(np.float32),
             "BiasParams": np.zeros(3, np.float32),
             "RankIn": 20, "RankOut": 80, "UpdatePeriod": 4,
             "NumSamplesHistory": 2000.0, "Alpha": 4.0},
        ),
    }
    nodes = [
        NodeSpec(kind="input", name="input", dim=D),
        NodeSpec(kind="component", name="W_all", component="W_all",
                 input=parse_descriptor(
                     f"Append(input, IfDefined(Offset(r_t, {delay})))")),
        NodeSpec(kind="component", name="lstm_nonlin", component="lstm_nonlin",
                 input=parse_descriptor(
                     f"Append(W_all, IfDefined(Offset(c_t, {delay})))")),
        NodeSpec(kind="dim-range", name="c_t", input_node="lstm_nonlin",
                 dim=5, dim_offset=0),
        NodeSpec(kind="dim-range", name="m_t", input_node="lstm_nonlin",
                 dim=5, dim_offset=5),
        NodeSpec(kind="component", name="r_t", component="W_r",
                 input=parse_descriptor("m_t")),
        NodeSpec(kind="component", name="W_out", component="W_out",
                 input=parse_descriptor("r_t")),
        NodeSpec(kind="output", name="output", input=parse_descriptor("W_out")),
    ]
    return Nnet3Spec(nodes=nodes, components=comps)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def test_lstm_recurrent_forward():
    rng = np.random.RandomState(8)
    spec = _lstmp_spec(rng)
    model = compile_nnet3(spec, num_out_frames=6, subsampling=1)
    assert model.recurrent
    assert model.recurrence == 1
    assert set(model.carried) == {"c_t", "r_t"}

    B, D, C, R = 2, 6, 5, 4
    feats = rng.randn(B, model.num_input_frames, D).astype(np.float32)
    got = np.asarray(model.forward(jnp.asarray(feats)))
    assert got.shape == (B, 6, 3)

    # NumPy reference loop
    c = spec.components
    w_all = c["W_all"].attrs["LinearParams"]
    b_all = c["W_all"].attrs["BiasParams"]
    w_lstm = c["lstm_nonlin"].attrs["Params"]
    w_r = c["W_r"].attrs["LinearParams"]
    w_out = c["W_out"].attrs["LinearParams"]
    for b in range(B):
        c_prev = np.zeros(C)
        r_prev = np.zeros(R)
        for t in range(6):
            gates = w_all @ np.concatenate([feats[b, t], r_prev]) + b_all
            i_t = _sigmoid(gates[0:C] + w_lstm[0] * c_prev)
            f_t = _sigmoid(gates[C:2*C] + w_lstm[1] * c_prev)
            c_t = f_t * c_prev + i_t * np.tanh(gates[2*C:3*C])
            o_t = _sigmoid(gates[3*C:4*C] + w_lstm[2] * c_t)
            m_t = o_t * np.tanh(c_t)
            r_t = w_r @ m_t
            out = w_out @ r_t
            np.testing.assert_allclose(got[b, t], out, rtol=2e-4, atol=2e-4)
            c_prev, r_prev = c_t, r_t


def test_lstm_file_roundtrip_and_jit():
    rng = np.random.RandomState(9)
    spec = _lstmp_spec(rng)
    buf = io.BytesIO()
    write_nnet3(buf, spec)
    buf.seek(0)
    spec2 = read_nnet3(KaldiReader(buf))
    m1 = compile_nnet3(spec, num_out_frames=4, subsampling=1)
    m2 = compile_nnet3(spec2, num_out_frames=4, subsampling=1)
    feats = jnp.asarray(rng.randn(1, m1.num_input_frames, 6).astype(np.float32))
    f2 = jax.jit(m2.forward)
    np.testing.assert_allclose(
        np.asarray(m1.forward(feats)), np.asarray(f2(feats)),
        rtol=1e-5, atol=1e-5,
    )


def test_recurrence_delay_not_multiple_of_subsampling():
    """delay -1 at subsampling 3: the evaluator drops its scan stride to
    gcd(3, 1) = 1 and emits every 3rd step — outputs must equal the
    subsampling-1 model's outputs at the subsampled frame times (Kaldi's
    looped compiler computes at the input frame rate for any delay,
    decodable-simple-looped.cc)."""
    rng = np.random.RandomState(10)
    spec = _lstmp_spec(rng)  # delay -1
    N = 5
    m3 = compile_nnet3(spec, num_out_frames=N, subsampling=3)
    assert m3.recurrent and m3.rec_stride == 1
    T1 = 3 * (N - 1) + 1
    m1 = compile_nnet3(spec, num_out_frames=T1, subsampling=1)

    B, D = 2, 6
    lo1, hi1 = m1.ranges["input"]
    feats1 = rng.randn(B, hi1 - lo1, D).astype(np.float32)
    lo3, hi3 = m3.ranges["input"]
    assert lo3 == lo1  # same step window start
    pad = (hi3 - lo3) - feats1.shape[1]
    feats3 = np.concatenate(
        [feats1, np.zeros((B, pad, D), np.float32)], axis=1
    )
    out1 = np.asarray(m1.forward(jnp.asarray(feats1)))
    out3 = np.asarray(m3.forward(jnp.asarray(feats3)))
    np.testing.assert_allclose(out3, out1[:, ::3], rtol=2e-4, atol=2e-4)


def test_recurrence_substride_chunked_matches_whole():
    """delay -1 at subsampling 3, decoded in chunks with carried state:
    the trailing sub-steps past each chunk's last output land the carry
    on the next chunk's step grid — chunked == whole."""
    rng = np.random.RandomState(11)
    spec = _lstmp_spec(rng)  # delay -1
    whole = compile_nnet3(spec, num_out_frames=12, subsampling=3)
    chunk = compile_nnet3(spec, num_out_frames=4, subsampling=3)
    assert whole.rec_stride == 1 and chunk.rec_stride == 1

    B, D = 2, 6
    lo, hi = whole.ranges["input"]
    T_in = hi - lo
    feats = rng.randn(B, T_in, D).astype(np.float32)
    want = np.asarray(whole.forward(jnp.asarray(feats)))

    clo, chi = chunk.ranges["input"]
    win_total = chi - clo
    state = chunk.init_state(B)
    outs = []
    for c in range(3):
        t0 = c * 4 * 3  # 4 outputs per chunk at subsampling 3
        idx = np.clip(np.arange(t0, t0 + win_total), 0, T_in - 1)
        window = feats[:, idx]
        out, state = chunk.forward_with_state(jnp.asarray(window), state)
        outs.append(np.asarray(out))
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_lstm_chunked_state_matches_whole():
    """forward_with_state over consecutive chunks == one whole forward."""
    rng = np.random.RandomState(12)
    spec = _lstmp_spec(rng)
    whole = compile_nnet3(spec, num_out_frames=12, subsampling=1)
    chunk = compile_nnet3(spec, num_out_frames=4, subsampling=1)
    assert whole.recurrent and chunk.recurrent

    B, D = 2, 6
    T_in = whole.num_input_frames
    feats = rng.randn(B, T_in, D).astype(np.float32)
    want = np.asarray(whole.forward(jnp.asarray(feats)))

    lo, hi = chunk.step_input_range
    win_total = chunk.ranges["input"][1] - chunk.ranges["input"][0]
    state = chunk.init_state(B)
    outs = []
    for c in range(3):
        t0 = c * 4  # 4 outputs per chunk at stride 1
        idx = np.clip(np.arange(t0 + chunk.ranges["input"][0],
                                t0 + chunk.ranges["input"][0] + win_total),
                      0, T_in - 1)
        # feats array is already aligned so that index 0 = global time lo
        window = feats[:, t0 : t0 + win_total]
        out, state = chunk.forward_with_state(jnp.asarray(window), state)
        outs.append(np.asarray(out))
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_lstm_delay3_deinterleaves():
    """A delay -3 recurrence at subsampling 1 runs 3 independent interleaved
    sequences: output[:, j::3] must equal the delay -1 model applied to the
    deinterleaved stream feats[:, j::3] (same weights)."""
    spec3 = _lstmp_spec(np.random.RandomState(13), delay=-3)
    spec1 = _lstmp_spec(np.random.RandomState(13), delay=-1)

    m3 = compile_nnet3(spec3, num_out_frames=12, subsampling=1)
    assert m3.recurrent and m3.recurrence == 3
    assert m3.carry_depths == (3, 3)
    m1 = compile_nnet3(spec1, num_out_frames=4, subsampling=1)

    rng = np.random.RandomState(14)
    B, D = 2, 6
    feats = rng.randn(B, m3.num_input_frames, D).astype(np.float32)
    got = np.asarray(m3.forward(jnp.asarray(feats)))

    for j in range(3):
        want_j = np.asarray(m1.forward(jnp.asarray(feats[:, j::3])))
        np.testing.assert_allclose(got[:, j::3], want_j, rtol=2e-4, atol=2e-4)


def test_lstm_delay3_chunked_state_matches_whole():
    """Cross-chunk state carry works with a depth-3 recurrence ring."""
    spec = _lstmp_spec(np.random.RandomState(15), delay=-3)
    whole = compile_nnet3(spec, num_out_frames=12, subsampling=1)
    chunk = compile_nnet3(spec, num_out_frames=4, subsampling=1)

    rng = np.random.RandomState(16)
    B, D = 2, 6
    T_in = whole.num_input_frames
    feats = rng.randn(B, T_in, D).astype(np.float32)
    want = np.asarray(whole.forward(jnp.asarray(feats)))

    win_total = chunk.ranges["input"][1] - chunk.ranges["input"][0]
    state = chunk.init_state(B)
    outs = []
    for c in range(3):
        t0 = c * 4
        window = feats[:, t0 : t0 + win_total]
        out, state = chunk.forward_with_state(jnp.asarray(window), state)
        outs.append(np.asarray(out))
    got = np.concatenate(outs, axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_switch_descriptor():
    """Switch(a, b): frame t takes branch t mod 2 (nnet-descriptor.h
    SwitchingForwardingDescriptor semantics)."""
    from rhasspy_speech_tpu.io import (
        ComponentSpec,
        NodeSpec,
        Nnet3Spec,
        parse_descriptor,
    )

    rng = np.random.RandomState(21)
    D, H = 5, 4
    wa = (rng.randn(H, D) * 0.5).astype(np.float32)
    wb = (rng.randn(H, D) * 0.5).astype(np.float32)
    comps = {
        "a": ComponentSpec("a", "FixedAffineComponent",
                           {"LinearParams": wa,
                            "BiasParams": np.zeros(H, np.float32)}),
        "b": ComponentSpec("b", "FixedAffineComponent",
                           {"LinearParams": wb,
                            "BiasParams": np.zeros(H, np.float32)}),
    }
    nodes = [
        NodeSpec(kind="input", name="input", dim=D),
        NodeSpec(kind="component", name="a", component="a",
                 input=parse_descriptor("input")),
        NodeSpec(kind="component", name="b", component="b",
                 input=parse_descriptor("input")),
        NodeSpec(kind="output", name="output",
                 input=parse_descriptor("Switch(a, b)")),
    ]
    model = compile_nnet3(Nnet3Spec(nodes=nodes, components=comps),
                          num_out_frames=6, subsampling=1)
    feats = rng.randn(2, model.num_input_frames, D).astype(np.float32)
    got = np.asarray(model.forward(jnp.asarray(feats)))
    for t in range(6):
        w = wa if t % 2 == 0 else wb
        want = feats[:, t] @ w.T
        np.testing.assert_allclose(got[:, t], want, rtol=1e-5, atol=1e-5)


def test_switch_descriptor_recurrent():
    """Switch works inside the stepwise recurrent evaluator (selection by
    the absolute step time, which is traced)."""
    from rhasspy_speech_tpu.io import ComponentSpec, NodeSpec, parse_descriptor

    spec = _lstmp_spec(np.random.RandomState(22))
    plain = compile_nnet3(spec, num_out_frames=8, subsampling=1)

    import copy

    spec2 = _lstmp_spec(np.random.RandomState(22))
    spec2.components["W_zero"] = ComponentSpec(
        "W_zero", "NaturalGradientAffineComponent",
        {"LearningRate": 1e-3,
         "LinearParams": np.zeros((3, 4), np.float32),
         "BiasParams": np.zeros(3, np.float32),
         "RankIn": 20, "RankOut": 80, "UpdatePeriod": 4,
         "NumSamplesHistory": 2000.0, "Alpha": 4.0},
    )
    nodes = list(spec2.nodes)
    out_idx = next(i for i, nd in enumerate(nodes) if nd.kind == "output")
    nodes.insert(out_idx, NodeSpec(kind="component", name="W_zero",
                                   component="W_zero",
                                   input=parse_descriptor("r_t")))
    nodes[out_idx + 1] = NodeSpec(kind="output", name="output",
                                  input=parse_descriptor("Switch(W_out, W_zero)"))
    spec2.nodes = nodes
    switched = compile_nnet3(spec2, num_out_frames=8, subsampling=1)
    assert switched.recurrent

    rng = np.random.RandomState(23)
    feats = rng.randn(2, plain.num_input_frames, 6).astype(np.float32)
    want = np.asarray(plain.forward(jnp.asarray(feats)))
    got = np.asarray(switched.forward(jnp.asarray(feats)))
    for t in range(8):
        if t % 2 == 0:
            np.testing.assert_allclose(got[:, t], want[:, t], rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(got[:, t], 0.0, atol=1e-6)


def test_bfloat16_compute_dtype(tmp_path):
    """compute_dtype='bfloat16' runs the AM in bf16 precision with
    f32 outputs; decodes stay correct and the forward stays close to f32."""
    import numpy as np
    import jax.numpy as jnp

    from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )

    lexicon = {"yes": ["y", "eh", "s"], "no": ["n", "ow"]}
    profile = build_synthetic_profile(tmp_path / "m", lexicon)
    train_model_sync(
        "en",
        {"language": "en",
         "intents": {"M": {"data": [{"sentences": ["yes", "no"]}]}}},
        tmp_path / "t", profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "t" / lang_dir_name(LangSuffix.GRAMMAR)

    t32 = Nnet3WavTranscriber(profile.model_dir, lang_dir)
    t16 = Nnet3WavTranscriber(
        profile.model_dir, lang_dir, compute_dtype="bfloat16"
    )
    for i, text in enumerate(["yes", "no"]):
        pcm = synthesize_sentence(profile, text, seed=i)
        assert t16.transcribe_pcm_batch([pcm])[0] == [text]
        lp32 = np.asarray(
            t32.am.log_probs(t32.am.features(pcm[None]), 8)
        )
        lp16 = np.asarray(
            t16.am.log_probs(t16.am.features(pcm[None]), 8)
        )
        assert lp16.dtype == np.float32
        # bf16 carries ~8 mantissa bits: relative error ~0.4%
        rel = np.abs(lp16 - lp32) / (np.abs(lp32) + 1.0)
        assert np.median(rel) < 0.01 and rel.max() < 0.1


def test_collapse_batchnorms_fold():
    """CollapseModel semantics (nnet-utils.h CollapseModel, run at load by
    online2-wav-nnet3-latgen-faster.cc:169-171): single-consumer batchnorms
    fold into the next linear component — fewer components, same outputs,
    same context."""
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    spec = build_tdnnf_spec(
        num_pdfs=64, input_dim=8, ivector_dim=4, hidden_dim=32,
        num_tdnnf_layers=3,
    )
    m0 = compile_nnet3(spec, num_out_frames=4, subsampling=3, collapse=False)
    m1 = compile_nnet3(spec, num_out_frames=4, subsampling=3)
    assert len(m1.spec.components) < len(m0.spec.components)
    assert not any(
        c.type == "BatchNormComponent" for c in m1.spec.components.values()
    )
    assert m0.num_input_frames == m1.num_input_frames

    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, m0.num_input_frames, 8).astype(np.float32))
    iv = jnp.asarray(rng.randn(2, 4).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(m0.forward(x, iv)),
        np.asarray(m1.forward(x, iv)),
        rtol=5e-4, atol=5e-4,
    )


def test_collapse_skips_shared_components():
    """nnet3 allows one ComponentSpec to back several nodes; folding such
    a batchnorm would corrupt (or orphan) the other node — collapse must
    leave shared components alone and still compile."""
    from rhasspy_speech_tpu.io import ComponentSpec, NodeSpec, Nnet3Spec, parse_descriptor
    from rhasspy_speech_tpu.models.nnet3 import collapse_batchnorms

    rng = np.random.RandomState(9)
    D = 6
    comps = {
        "aff": ComponentSpec(
            "aff", "FixedAffineComponent",
            {"LinearParams": rng.randn(D, D).astype(np.float32),
             "BiasParams": rng.randn(D).astype(np.float32)},
        ),
        "bn": ComponentSpec(
            "bn", "BatchNormComponent",
            {"Dim": D, "BlockDim": D, "Epsilon": 1e-3, "TargetRms": 1.0,
             "StatsMean": rng.randn(D).astype(np.float32),
             "StatsVar": (1.0 + rng.rand(D)).astype(np.float32),
             "Count": 10.0},
        ),
        "lin": ComponentSpec(
            "lin", "LinearComponent",
            {"Params": rng.randn(D, D).astype(np.float32)},
        ),
    }
    nodes = [
        NodeSpec(kind="input", name="input", dim=D),
        NodeSpec(kind="component", name="a", component="aff",
                 input=parse_descriptor("input")),
        NodeSpec(kind="component", name="bn_a", component="bn",
                 input=parse_descriptor("a")),
        NodeSpec(kind="component", name="bn_b", component="bn",
                 input=parse_descriptor("input")),
        NodeSpec(kind="component", name="l", component="lin",
                 input=parse_descriptor("bn_a")),
        NodeSpec(kind="output", name="output",
                 input=parse_descriptor("Sum(l, bn_b)")),
    ]
    spec = Nnet3Spec(nodes=nodes, components=comps)
    folded = collapse_batchnorms(spec)
    assert folded is spec  # shared 'bn' component: nothing foldable

    m = compile_nnet3(spec, num_out_frames=3, subsampling=1)
    x = jnp.asarray(rng.randn(2, m.num_input_frames, D).astype(np.float32))
    out = m.forward(x)
    assert out.shape == (2, 3, D)


def test_collapse_protects_output_name():
    """Requesting an internal batchnorm node as the output must not let
    collapse delete it."""
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    spec = build_tdnnf_spec(
        num_pdfs=32, input_dim=8, ivector_dim=0, hidden_dim=16,
        num_tdnnf_layers=2,
    )
    bn_names = [n.name for n in spec.nodes if n.name.endswith(".batchnorm")]
    assert bn_names
    m = compile_nnet3(
        spec, num_out_frames=2, subsampling=3, output_name=bn_names[0]
    )
    x = np.random.RandomState(1).randn(1, m.num_input_frames, 8).astype(np.float32)
    out = m.forward(jnp.asarray(x))
    assert out.shape[0] == 1
