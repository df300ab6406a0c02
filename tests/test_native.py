"""Native runtime tests: WAV parse, resampler, stream pool."""

import wave

import numpy as np
import pytest

from rhasspy_speech_tpu.native import StreamPool, get_runtime, load_wav, resample


def _write_wav(path, pcm, rate=16000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(pcm, dtype=np.int16).tobytes())


def test_native_library_builds():
    assert get_runtime().lib is not None, "g++ build of librss_runtime failed"


def test_load_wav_mono(tmp_path):
    t = np.arange(16000) / 16000.0
    pcm = (8000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)
    path = tmp_path / "tone.wav"
    _write_wav(path, pcm)
    got = load_wav(str(path))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, pcm.astype(np.float32), atol=0.5)


def test_load_wav_stereo_mixdown(tmp_path):
    left = np.full(1000, 1000, dtype=np.int16)
    right = np.full(1000, 3000, dtype=np.int16)
    inter = np.empty(2000, dtype=np.int16)
    inter[0::2] = left
    inter[1::2] = right
    path = tmp_path / "stereo.wav"
    _write_wav(path, inter, channels=2)
    got = load_wav(str(path))
    assert got.shape[0] == 1000
    np.testing.assert_allclose(got, 2000.0, atol=1.0)


@pytest.mark.parametrize("in_rate", [8000, 22050, 44100, 48000])
def test_resample_preserves_tone(in_rate):
    """A 440 Hz tone resampled to 16 kHz stays a 440 Hz tone."""
    dur = 0.5
    t_in = np.arange(int(in_rate * dur)) / in_rate
    tone = np.sin(2 * np.pi * 440 * t_in).astype(np.float32)
    out = resample(tone, in_rate, 16000)
    expected_len = int(len(tone) * 16000 / in_rate)
    assert abs(out.shape[0] - expected_len) <= 1

    # dominant frequency via FFT
    spec = np.abs(np.fft.rfft(out * np.hanning(out.shape[0])))
    freq = np.fft.rfftfreq(out.shape[0], 1 / 16000.0)
    peak = freq[np.argmax(spec)]
    assert abs(peak - 440) < 5, peak
    # amplitude roughly preserved (ignore edges)
    mid = out[out.shape[0] // 4 : -out.shape[0] // 4]
    assert 0.9 < np.abs(mid).max() < 1.1


def test_resample_wav_to_16k(tmp_path):
    rate = 44100
    t = np.arange(rate) / rate
    pcm = (8000 * np.sin(2 * np.pi * 220 * t)).astype(np.int16)
    path = tmp_path / "hi.wav"
    _write_wav(path, pcm, rate=rate)
    got = load_wav(str(path))
    assert abs(got.shape[0] - 16000) <= 1


def test_stream_pool_lifecycle():
    pool = StreamPool(num_slots=2, capacity_samples=1000)
    a = pool.open()
    b = pool.open()
    assert {a, b} == {0, 1}
    assert pool.open() == -1  # full

    data = np.arange(300, dtype=np.float32)
    assert pool.feed(a, data) == 300
    assert pool.available(a) == 300
    out = pool.read(a, 100)
    np.testing.assert_array_equal(out, data[:100])
    assert pool.available(a) == 200

    # ring wrap: feed more than remaining capacity in pieces
    assert pool.feed(a, np.arange(700, dtype=np.float32)) == 700
    assert pool.available(a) == 900
    rest = pool.read(a, 900)
    np.testing.assert_array_equal(rest[:200], data[100:])
    np.testing.assert_array_equal(rest[200:], np.arange(700, dtype=np.float32))

    assert not pool.is_finished(a)
    pool.finish(a)
    assert pool.is_finished(a)
    pool.close(a)
    assert pool.open() == a  # slot recycled


def test_stream_pool_backpressure():
    pool = StreamPool(num_slots=1, capacity_samples=100)
    s = pool.open()
    taken = pool.feed(s, np.zeros(150, dtype=np.float32))
    assert taken == 100  # ring full: partial accept


def test_stream_pool_snapshot_and_batched_drain():
    """One-call drain plan + batched read (the serving tick's fast path):
    counts/finished/int16-exactness from rss_pool_snapshot, rows written
    at per-lane offsets by rss_pool_read_all, exactness tracked at feed
    time and reset on slot reuse, ring wraparound preserved."""
    pool = StreamPool(num_slots=3, capacity_samples=200)
    a, b = pool.open(), pool.open()
    pool.feed(a, np.array([1.0, 2.0, 3.0], np.float32))
    pool.feed(b, np.array([4.5, 5.0], np.float32))  # 4.5 not int16-exact
    pool.finish(b)

    counts, finished, exact = pool.snapshot()
    assert counts.tolist()[:2] == [3, 2] and counts[2] == 0
    assert not finished[a] and finished[b]
    if pool.has_batched_drain:  # NumPy fallback reports exactness False
        assert exact[a] and not exact[b]

    out = np.zeros((3, 8), np.float32)
    pool.read_into(out, np.array([2, 0, 0]), counts)
    assert out[a, 2:5].tolist() == [1.0, 2.0, 3.0]
    assert out[b, :2].tolist() == [4.5, 5.0]
    counts2, _, _ = pool.snapshot()
    assert counts2[a] == 0 and counts2[b] == 0

    # exactness resets when the slot is recycled
    pool.close(b)
    c = pool.open()
    pool.feed(c, np.array([7.0, -32767.0], np.float32))
    _, _, exact = pool.snapshot()
    if pool.has_batched_drain:
        assert exact[c]


def test_stream_pool_batched_drain_int16_wraparound():
    """int16 rows drained across many overfill/drain cycles stay sample-
    exact through the ring wrap."""
    pool = StreamPool(num_slots=2, capacity_samples=100)
    s = pool.open()
    rng = np.random.RandomState(3)
    for it in range(9):
        chunk = np.round(rng.randn(60) * 1000.0).astype(np.float32)
        chunk = np.clip(chunk, -32767, 32767)
        assert pool.feed(s, chunk) == 60
        counts, _, exact = pool.snapshot()
        dtype = np.int16 if (pool.has_batched_drain and exact[s]) else np.float32
        out = np.zeros((2, 64), dtype)
        pool.read_into(out, np.zeros(2, np.int64), counts)
        np.testing.assert_array_equal(
            out[s, :60].astype(np.float32), chunk, err_msg=str(it)
        )


def test_stream_pool_numpy_fallback_snapshot_and_drain(monkeypatch):
    """The NumPy StreamPool fallback (no native library) must support the
    batched-drain API too — including snapshot() over never-opened and
    closed slots (regression: available() crashed on None buffers)."""
    from rhasspy_speech_tpu.native import runtime as rt

    monkeypatch.setattr(rt._RUNTIME, "_lib", None)
    monkeypatch.setattr(rt._RUNTIME, "_tried", True)
    pool = StreamPool(3, 100)
    assert not pool.has_batched_drain
    s = pool.open()
    pool.feed(s, np.array([1.0, 2.5], np.float32))
    counts, finished, exact = pool.snapshot()  # slots 1,2 never opened
    assert counts.tolist() == [2, 0, 0]
    assert not exact.any()  # fallback always takes the float32 path
    assert not finished[s]
    out = np.zeros((3, 4), np.float32)
    pool.read_into(out, np.zeros(3, np.int64), counts)
    assert out[s, :2].tolist() == [1.0, 2.5]
    pool.finish(s)
    pool.close(s)
    counts2, _, _ = pool.snapshot()  # closed slot must not crash
    assert counts2.tolist() == [0, 0, 0]


def test_stream_pool_int16_feed_exact_and_equal():
    """int16 feeds (the wire format) take the native widening path: the
    slot stays i16-exact without any per-sample scan, reads return the
    same f32 samples as an equivalent float feed, and ring wraparound
    converts both segments."""
    pool = StreamPool(2, 50)
    if not pool.has_batched_drain:  # no native lib: f32 conversion path
        import pytest

        pytest.skip("native runtime unavailable")
    a = pool.open()
    b = pool.open()
    vals = np.array([0, 1, -1, 32767, -32767, 123], np.int16)
    pool.feed(a, vals)
    pool.feed(b, vals.astype(np.float32))
    _counts, _fin, exact = pool.snapshot()
    assert exact[a] and exact[b]
    ra = pool.read(a, 6)
    rb = pool.read(b, 6)
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(ra, vals.astype(np.float32))
    # wraparound: drain then overfeed past the ring end
    big = (np.arange(45, dtype=np.int16) - 20)
    pool.feed(a, big)
    assert pool.read(a, 45).tolist() == big.astype(np.float32).tolist()
    more = np.arange(30, dtype=np.int16)
    got = pool.feed(a, more)  # write wraps the 50-sample ring
    assert got == 30
    np.testing.assert_array_equal(
        pool.read(a, 30), more.astype(np.float32)
    )
    _c2, _f2, exact2 = pool.snapshot()
    assert exact2[a]


def test_stream_pool_feed_many_batched_and_fallback(monkeypatch):
    """feed_many feeds row k to slots[k] in one call: contents sample-
    exact (incl. ring wraparound), i16-exactness preserved, -1 for
    finished/out-of-range slots; the NumPy fallback matches the native
    contract."""
    for use_native in (True, False):
        from rhasspy_speech_tpu.native import runtime as rt

        if not use_native:
            monkeypatch.setattr(rt._RUNTIME, "_lib", None)
            monkeypatch.setattr(rt._RUNTIME, "_tried", True)
        pool = StreamPool(4, 100)
        if use_native and pool._lib is None:
            continue  # no native build on this host: fallback leg covers it
        s0, s1, s2 = pool.open(), pool.open(), pool.open()
        pool.finish(s2)
        pcm = (np.arange(4 * 60).reshape(4, 60) % 2000 - 1000).astype(
            np.int16
        )
        taken = pool.feed_many(np.array([s0, s1, s2, 99]), pcm)
        assert taken.tolist() == [60, 60, -1, -1]
        counts, _, exact = pool.snapshot()
        assert counts[s0] == 60 and counts[s1] == 60
        if use_native:
            assert exact[s0] and exact[s1]  # int16 by construction
        np.testing.assert_array_equal(
            pool.read(s0, 60), pcm[0].astype(np.float32)
        )
        np.testing.assert_array_equal(
            pool.read(s1, 60), pcm[1].astype(np.float32)
        )
        # wraparound leg: s0 now at read_pos 60 of a 100-ring
        taken2 = pool.feed_many(np.array([s0]), pcm[2:3])
        assert taken2.tolist() == [60]
        np.testing.assert_array_equal(
            pool.read(s0, 60), pcm[2].astype(np.float32)
        )
        monkeypatch.undo()


@pytest.mark.parametrize("part", ["source", "flags", "cpu"])
def test_library_key_changes_with_source_flags_or_host(part):
    """A build is keyed on its source, its flags and the host CPU, so a
    library built elsewhere (or from older source) is never loaded."""
    from rhasspy_speech_tpu.native.runtime import library_key

    base = dict(source=b"int f();", flags=("-O3", "-march=native"),
                cpu_flags="sse4_2 avx2")
    changed = dict(base)
    if part == "source":
        changed["source"] = b"int g();"
    elif part == "flags":
        changed["flags"] = ("-O3",)
    else:
        changed["cpu_flags"] = "sse4_2 avx2 avx512f"
    assert library_key(**base) == library_key(**base)
    assert library_key(**changed) != library_key(**base)


def test_loaded_library_is_the_keyed_build():
    from rhasspy_speech_tpu.native import runtime

    assert get_runtime().lib is not None
    path = runtime._library_path(runtime._BUILD_FLAGS[0])
    alt = runtime._library_path(runtime._BUILD_FLAGS[1])
    assert path.exists() or alt.exists()
    assert path.name.startswith("librss_runtime-") and path != alt


def test_native_entry_points_reject_bad_input():
    from rhasspy_speech_tpu.native.runtime import adpcm_encode_into

    with pytest.raises(ValueError):
        adpcm_encode_into(
            np.zeros((2, 320), np.float64), np.array([320, 320]), 160,
            np.zeros((2, 200), np.uint8),
        )
    pool = StreamPool(2, 1600)
    with pytest.raises(ValueError):
        pool.feed_many(np.array([0, 1], np.int32), np.zeros((3, 10), np.int16))
