"""AOT program store: serve without re-tracing (utils/aot.py).

Kaldi's binaries are ahead-of-time compiled; a second decoder start pays
no compilation. save_aot() gives the JAX pipeline the same property:
serialized StableHLO for the serving programs, reloaded by a fresh
transcriber with no tracing/lowering."""

import numpy as np
import pytest

from rhasspy_speech_tpu.const import LangSuffix
from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
from rhasspy_speech_tpu.pipeline.train import train_model_sync
from rhasspy_speech_tpu.testing import (
    build_synthetic_profile,
    synthesize_sentence,
)

LEX = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "light": ["l", "ay", "t"],
}


@pytest.fixture(scope="module")
def aot_profile(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aot")
    profile = build_synthetic_profile(tmp / "m", LEX)
    train_model_sync(
        "en",
        {"language": "en", "intents": {"M": {"data": [
            {"sentences": ["turn (on|off) light"]}]}}},
        tmp / "t",
        profile.model_dir,
        lang_suffixes=[LangSuffix.GRAMMAR],
    )
    return profile, tmp / "t" / lang_dir_name(LangSuffix.GRAMMAR)


def test_save_aot_roundtrip(aot_profile):
    """save_aot() writes program blobs; a FRESH transcriber decodes the
    same shapes through them — proven by breaking the traced paths."""
    profile, lang = aot_profile
    pcms = [
        synthesize_sentence(profile, "turn on light", seed=3),
        synthesize_sentence(profile, "turn off light", seed=4),
    ]
    # identical shapes across processes: pad to a fixed length
    n = max(p.shape[0] for p in pcms) + 160
    pcms = [np.pad(p, (0, n - p.shape[0])) for p in pcms]

    t1 = Nnet3WavTranscriber(profile.model_dir, lang)
    want = t1.transcribe_pcm_batch(pcms)
    aot_dir = t1.save_aot(pcms)
    blobs = list(aot_dir.glob("*.jaxexport"))
    assert len(blobs) >= 3, blobs  # features, logprobs, decode1

    t2 = Nnet3WavTranscriber(profile.model_dir, lang)
    # break the traced paths: if the AOT programs are not used, these
    # poisoned methods raise
    t2.am.features = _boom
    t2.am.features_traceable = _boom
    t2.am.log_probs = _boom
    got = t2.transcribe_pcm_batch(pcms)
    assert got == want
    assert got[0] == ["turn on light"]

    # a DIFFERENT shape falls back to tracing (poison fires)
    other = [p[: n - 320] for p in pcms]
    with pytest.raises(RuntimeError, match="poisoned"):
        t2.transcribe_pcm_batch(other)


def _boom(*_a, **_k):
    raise RuntimeError("poisoned: traced path used despite AOT store")


def test_aot_store_shape_keying(tmp_path):
    """Blobs key on shape+dtype; a mismatch loads nothing."""
    import jax.numpy as jnp

    from rhasspy_speech_tpu.utils.aot import AotStore

    store = AotStore(tmp_path / "aot")
    x = jnp.arange(8, dtype=jnp.float32)
    store.save("double", lambda v: v * 2.0, (x,))
    fn = store.load("double", (x,))
    assert fn is not None
    np.testing.assert_allclose(np.asarray(fn(x)), np.asarray(x) * 2.0)
    y = jnp.arange(16, dtype=jnp.float32)
    assert store.load("double", (y,)) is None


def test_scheduler_save_aot_roundtrip(aot_profile):
    """StreamScheduler.save_aot() exports the serving-tick programs; a
    FRESH scheduler serves the same shapes through the restored programs
    — proven by poisoning the traced jits."""
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler

    profile, lang = aot_profile
    CHUNK = 21 * 160

    pcm = synthesize_sentence(profile, "turn on light", seed=6)
    # same arrival shape as the export drive: whole chunks of int16-exact
    # samples, utterance length matching the exported finalize bucket
    n = pcm.shape[0] // CHUNK * CHUNK
    pcm = np.round(pcm[:n])

    s1 = StreamScheduler(profile.model_dir, lang, max_streams=2)
    assert s1._aot is not None
    aot_dir = s1.save_aot(seconds=n / 16000.0)
    blobs = list(aot_dir.glob("sched_*.jaxexport"))
    # fused tick + features-only feed + >=1 finalize bucket
    assert len(blobs) >= 3, blobs

    s2 = StreamScheduler(profile.model_dir, lang, max_streams=2)
    s2._batch_chunk_fused = _boom
    s2._feed_only = _boom
    s2._finalize_trace = _boom
    sid = s2.open_stream()
    for off in range(0, n, CHUNK):
        s2.feed(sid, pcm[off : off + CHUNK])
        s2.step()
    s2.finish(sid)
    s2.run_until_idle()
    assert s2.poll(sid) == ["turn on light"]


@pytest.mark.parametrize(
    "backend, platform", [("gpu", "cuda"), ("cpu", "cpu")]
)
def test_export_platform_names_the_lowering_platform(backend, platform):
    """jax.export lowers a GPU program for "cuda"; the blob key carries the
    lowering platform, so a CPU blob never serves a GPU process."""
    import jax
    import jax.numpy as jnp

    from rhasspy_speech_tpu.utils.aot import (
        AotStore,
        _args_platform,
        export_platform,
    )

    assert export_platform(backend) == platform
    store = AotStore("/nonexistent")
    specs = (jax.ShapeDtypeStruct((2, 3), jnp.float32),)
    assert store._path("f", specs, platform) != store._path(
        "f", specs, "rocm" if platform == "cuda" else "cuda"
    )
    assert _args_platform((jnp.zeros(3),)) == export_platform(
        jax.default_backend()
    )


def test_aot_export_for_cuda_lowers_here():
    """The "cuda" lowering works without a card (jax.export cross-lowers);
    the old "gpu" name does not."""
    import jax
    import jax.numpy as jnp
    from jax import export as jax_export

    spec = jax.ShapeDtypeStruct((4,), jnp.float32)
    exp = jax_export.export(jax.jit(lambda x: x * 2.0), platforms=["cuda"])(spec)
    assert exp.platforms == ("cuda",)
    with pytest.raises(Exception):
        jax_export.export(jax.jit(lambda x: x), platforms=["gpu"])(spec)


def test_store_round_trip_needs_no_flatbuffers(tmp_path):
    """jax.export's own serializer needs the optional flatbuffers package;
    the store must save and load without it (serving hosts may lack it)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    script = f"""
import sys
sys.modules["flatbuffers"] = None
sys.path.insert(0, {str(repo)!r})
import jax.numpy as jnp
from rhasspy_speech_tpu.utils.aot import AotStore
args = (jnp.arange(4.0),)
AotStore({str(tmp_path)!r}).save("f", lambda x: (x * 2.0, x + 1.0), args)
fn = AotStore({str(tmp_path)!r}).load("f", args)
a, b = fn(*args)
assert a.tolist() == [0.0, 2.0, 4.0, 6.0] and b.tolist() == [1.0, 2.0, 3.0, 4.0]
print("ROUND_TRIP_OK")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=300,
    )
    assert "ROUND_TRIP_OK" in proc.stdout, proc.stderr[-3000:]
