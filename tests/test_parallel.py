"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from rhasspy_speech_tpu.parallel import make_stream_mesh, shard_streams


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return make_stream_mesh(8)


def test_mesh_shape(mesh):
    assert mesh.shape == {"streams": 8}


def test_shard_streams_placement(mesh):
    x = np.random.randn(16, 4).astype(np.float32)
    xs = shard_streams(mesh, x)
    assert xs.sharding.spec == P("streams", None)
    np.testing.assert_array_equal(np.asarray(xs), x)


def test_sharded_decode_equals_unsharded(mesh):
    """The full decode program gives identical results when the stream batch
    is sharded across the mesh (pure data parallelism, no collectives)."""
    from tests.test_decoder import _random_graph
    from rhasspy_speech_tpu.ops.decoder import (
        DeviceGraph,
        traces_to_words_batch,
        viterbi_decode,
    )

    rng = np.random.RandomState(0)
    graph = _random_graph(rng)
    dev = DeviceGraph.from_dense(graph)
    B, T = 16, 10
    lp = np.log(rng.dirichlet(np.ones(graph.num_pdfs), size=(B, T))).astype(
        np.float32
    )

    f = jax.jit(lambda x: viterbi_decode(dev, x))
    plain = [np.asarray(v) for v in f(jnp.asarray(lp))]

    lp_sharded = shard_streams(mesh, lp)
    sharded = [np.asarray(v) for v in f(lp_sharded)]

    np.testing.assert_allclose(plain[2], sharded[2], rtol=1e-6)
    w1 = traces_to_words_batch(graph, *plain)
    w2 = traces_to_words_batch(graph, *sharded)
    assert [w for w, _ in w1] == [w for w, _ in w2]


def test_sharded_am_forward(mesh):
    """TDNN-F forward under batch sharding matches the replicated run."""
    from rhasspy_speech_tpu.models import compile_nnet3
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    spec = build_tdnnf_spec(num_pdfs=12, input_dim=8, hidden_dim=32,
                            bottleneck_dim=8, num_tdnnf_layers=2)
    model = compile_nnet3(spec, num_out_frames=4, subsampling=3)
    rng = np.random.RandomState(1)
    feats = rng.randn(8, model.num_input_frames, 8).astype(np.float32)

    f = jax.jit(model.forward)
    plain = np.asarray(f(jnp.asarray(feats)))
    sharded = np.asarray(f(shard_streams(mesh, feats)))
    np.testing.assert_allclose(plain, sharded, rtol=1e-5, atol=1e-5)


def test_sharded_transcriber_matches_single_chip(mesh, tmp_path):
    """ShardedWavTranscriber over the 8-CPU mesh returns the same
    transcripts as the single-device transcriber, including a batch that
    is not a multiple of the mesh size (padded with empty streams)."""
    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.parallel import ShardedWavTranscriber
    from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )

    lexicon = {
        "turn": ["t", "er", "n"],
        "on": ["aa", "n"],
        "off": ["ao", "f"],
        "light": ["l", "ay", "t"],
        "fan": ["f", "ae", "n"],
    }
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_model_sync(
        "en",
        {
            "language": "en",
            "intents": {
                "M": {"data": [{"sentences": ["turn (on|off) (light|fan)"]}]}
            },
        },
        tmp_path / "train",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)

    texts = ["turn on light", "turn off fan", "turn on fan"]  # B=3, pads to 8
    pcms = [synthesize_sentence(profile, t, seed=100 + i) for i, t in enumerate(texts)]

    single = Nnet3WavTranscriber(profile.model_dir, lang_dir)
    sharded = ShardedWavTranscriber(profile.model_dir, lang_dir, mesh=mesh)
    assert sharded._shard_count == 8

    want = single.transcribe_pcm_batch(pcms)
    got = sharded.transcribe_pcm_batch(pcms)
    assert got == want
    assert [g[0] if g else None for g in got] == texts

    # n-best (the k-best kernel partitions over the mesh too) + fuzzy
    want_n = single.transcribe_pcm_batch(pcms, nbest=3, max_fuzzy_cost=2.0)
    got_n = sharded.transcribe_pcm_batch(pcms, nbest=3, max_fuzzy_cost=2.0)
    assert got_n == want_n
    assert [g[0] if g else None for g in got_n] == texts


def test_sharded_scheduler_matches_unsharded(mesh, tmp_path):
    """StreamScheduler(mesh=...) over the 8-CPU mesh streams to the same
    transcripts as the unsharded scheduler."""
    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.pipeline import lang_dir_name
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )

    lexicon = {
        "turn": ["t", "er", "n"],
        "on": ["aa", "n"],
        "off": ["ao", "f"],
        "light": ["l", "ay", "t"],
    }
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_model_sync(
        "en",
        {
            "language": "en",
            "intents": {
                "M": {"data": [{"sentences": ["turn (on|off) light"]}]}
            },
        },
        tmp_path / "train",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)

    import pytest as _pytest

    with _pytest.raises(ValueError):
        StreamScheduler(profile.model_dir, lang_dir, max_streams=6, mesh=mesh)

    texts = ["turn on light", "turn off light", "turn on light"]
    pcms = [synthesize_sentence(profile, t, seed=300 + i) for i, t in enumerate(texts)]

    def run(sched):
        sids = [sched.open_stream() for _ in texts]
        for i, sid in enumerate(sids):
            sched.feed(sid, pcms[i])
            sched.finish(sid)
        for _ in range(200):
            if all(sched.poll(sid) is not None for sid in sids):
                break
            sched.step()
        return [sched.poll(sid) for sid in sids]

    plain = run(StreamScheduler(profile.model_dir, lang_dir, max_streams=8))
    sharded = run(
        StreamScheduler(profile.model_dir, lang_dir, max_streams=8, mesh=mesh)
    )
    assert sharded == plain == [[t] for t in texts]
    # the 8-bit mu-law wire shards across the mesh the same way (the
    # uint8 PCM batch rides the identical lane-dim sharding spec)
    sharded_mulaw = run(
        StreamScheduler(
            profile.model_dir, lang_dir, max_streams=8, mesh=mesh,
            wire="mulaw",
        )
    )
    assert sharded_mulaw == plain
    # ... and so does the 4-bit block-ADPCM wire
    sharded_adpcm = run(
        StreamScheduler(
            profile.model_dir, lang_dir, max_streams=8, mesh=mesh,
            wire="adpcm",
        )
    )
    assert sharded_adpcm == plain


def test_sharded_scheduler_endpoint_and_silence_weighting(mesh, tmp_path):
    """Endpointing + silence weighting ride the device lanes under a
    stream mesh too: the per-state DP columns, [N, 3] endpoint stats, and
    silence fold weights are lane-sharded, and transcripts match the
    unsharded scheduler; a never-finished stream still endpoints."""
    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.pipeline import lang_dir_name
    from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )
    from rhasspy_speech_tpu.testing.synthetic import _silence_wave

    lexicon = {
        "turn": ["t", "er", "n"],
        "on": ["aa", "n"],
        "light": ["l", "ay", "t"],
    }
    profile = build_synthetic_profile(
        tmp_path / "model", lexicon, with_ivector=True, with_context=True
    )
    train_model_sync(
        "en",
        {"language": "en",
         "intents": {"M": {"data": [{"sentences": ["turn on light"]}]}}},
        tmp_path / "train",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)

    import numpy as np

    speech = synthesize_sentence(profile, "turn on light", seed=11)
    pcm = np.concatenate(
        [speech, _silence_wave(16000 * 3, np.random.RandomState(2))]
    )

    def run(sched):
        assert sched._ep_device and sched._sw_device and sched._device_feats
        sid = sched.open_stream()
        sched.feed(sid, pcm)
        # never finish(): the endpoint must close the utterance
        for _ in range(150):
            if sched.poll(sid) is not None:
                break
            sched.step()
        return sched.poll(sid)

    kw = dict(
        max_streams=8,
        endpointing=EndpointConfig(),
        silence_weight=0.01,
    )
    plain = run(StreamScheduler(profile.model_dir, lang_dir, **kw))
    sharded = run(
        StreamScheduler(profile.model_dir, lang_dir, mesh=mesh, **kw)
    )
    assert sharded == plain == ["turn on light"]


def test_mesh_balanced_admission(mesh, tmp_path):
    """At partial occupancy, lanes must spread one-per-shard (contiguous
    lane blocks map to devices; first-free admission would pile work on
    shard 0 while other chips tick masked lanes)."""
    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.pipeline import lang_dir_name
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import build_synthetic_profile

    lexicon = {"on": ["aa", "n"]}
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [{"sentences": ["on"]}]}}},
        tmp_path / "train",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    sched = StreamScheduler(
        profile.model_dir, lang_dir, max_streams=16, mesh=mesh
    )
    per = 16 // 8
    sids = [sched.open_stream() for _ in range(8)]
    assert sorted(s // per for s in sids) == list(range(8)), sids
    # next 8 fill the second slot of each shard
    more = [sched.open_stream() for _ in range(8)]
    assert sorted(s // per for s in more) == list(range(8)), more
    # close one mid-shard lane; the next admission reuses that shard
    sched.close(sids[3])
    reopened = sched.open_stream()
    assert reopened // per == sids[3] // per


def test_mesh_quarantine_does_not_stall_other_shards(mesh, tmp_path):
    """A lane force-finalized by the ring-capacity quarantine on one
    shard must not break the other shards' ticks: their utterances
    still decode exactly."""
    import numpy as np

    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.pipeline import lang_dir_name
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )

    lexicon = {"turn": ["t", "er", "n"], "on": ["aa", "n"], "light": ["l", "ay", "t"]}
    profile = build_synthetic_profile(tmp_path / "model", lexicon)
    train_model_sync(
        "en",
        {
            "language": "en",
            "intents": {"M": {"data": [{"sentences": ["turn on light"]}]}},
        },
        tmp_path / "train",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = tmp_path / "train" / lang_dir_name(LangSuffix.GRAMMAR)
    # pool sized for ~1 s: a 3x-longer stream overflows its device rings
    sched = StreamScheduler(
        profile.model_dir,
        lang_dir,
        max_streams=8,
        mesh=mesh,
        pool_capacity_samples=16000,
    )
    text = "turn on light"
    good = [synthesize_sentence(profile, text, seed=400 + i) for i in range(3)]
    runaway = np.tile(synthesize_sentence(profile, text, seed=499), 4)

    bad_sid = sched.open_stream()
    good_sids = [sched.open_stream() for _ in good]
    # distinct shards (balanced admission)
    assert len({s // 1 for s in [bad_sid] + good_sids}) == 4
    off_b = 0
    offs = [0] * len(good)
    for _ in range(600):
        if off_b < runaway.shape[0]:
            off_b += sched.feed(bad_sid, runaway[off_b : off_b + 4096])
            if off_b >= runaway.shape[0]:
                sched.finish(bad_sid)
        for i, sid in enumerate(good_sids):
            if offs[i] < good[i].shape[0]:
                offs[i] += sched.feed(sid, good[i][offs[i] : offs[i] + 4096])
                if offs[i] >= good[i].shape[0]:
                    sched.finish(sid)
        sched.step()
        done = all(
            sched.poll(s, block=False) is not None for s in good_sids
        ) and sched.poll(bad_sid, block=False) is not None
        if done and off_b >= runaway.shape[0]:
            break
    assert sched.error(bad_sid) is not None, "runaway lane must quarantine"
    for sid in good_sids:
        assert sched.poll(sid) == [text], sched.poll(sid)


@pytest.mark.parametrize("n_devices, devices", [(9, None), (2, 1)])
def test_make_stream_mesh_raises_on_too_few_devices(n_devices, devices):
    """Too few devices is an error: the mesh never falls back to another
    platform's devices."""
    if devices is not None:
        devices = jax.devices()[:devices]
    with pytest.raises(ValueError, match="need"):
        make_stream_mesh(n_devices, devices=devices)
