"""Batched MFCC feature frontend (Kaldi-compatible numerics).

Replaces Kaldi's streaming MFCC pipeline (reference:
kaldi/src/feat/feature-mfcc.cc:28-110 MfccComputer::Compute,
kaldi/src/feat/feature-window.h:35-67 FrameExtractionOptions defaults,
kaldi/src/feat/mel-computations.cc MelBanks) with one batched JAX function
over ``[streams, samples]``. All per-frame work — framing, DC removal,
pre-emphasis, Povey window, rFFT, power spectrum, mel filterbank, log, DCT,
cepstral lifter — happens inside a single jitted function so XLA fuses the
elementwise stages around the rFFT and the mel and DCT matmuls.

Numerics follow Kaldi exactly (mel scale 1127*ln(1+f/700), DCT-II with
orthonormal scaling, lifter 1+Q/2*sin(pi*i/Q), eps floor before log) so that
transcripts match the reference at the text level. Dithering defaults to 0
for determinism (Kaldi default is 1.0; it only matters for log-of-zero
guards, which the eps floor covers).

A NumPy float64 reference implementation (``mfcc_numpy``) is kept for
testing the JAX path, written independently from first principles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class FrontendConfig:
    """MFCC hyperparameters.

    Defaults are Kaldi's FrameExtractionOptions/MfccOptions defaults
    (feature-window.h:53-67, feature-mfcc.h:52-61) with the hires overrides
    used by the reference's online chain models (mfcc_hires.conf:
    num_mel_bins=40, num_ceps=40, low_freq=20, high_freq=-400,
    use_energy=false).
    """

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 0.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    snip_edges: bool = True
    num_mel_bins: int = 40
    low_freq: float = 20.0
    high_freq: float = -400.0
    num_ceps: int = 40
    use_energy: bool = False
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    energy_floor: float = 0.0

    @property
    def frame_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def frame_length(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if not self.round_to_power_of_two:
            return n
        p = 1
        while p < n:
            p *= 2
        return p


def frontend_from_mfcc_conf(path) -> FrontendConfig:
    """Build a FrontendConfig from a Kaldi mfcc conf file
    (conf/mfcc_hires.conf style: --key=value lines, ParseOptions names from
    feature-window.h:68-96 / feature-mfcc.h:63-80)."""
    from ..io.ivector import parse_conf

    conf = parse_conf(str(path))
    key_map = {
        "sample-frequency": ("samp_freq", float),
        "frame-shift": ("frame_shift_ms", float),
        "frame-length": ("frame_length_ms", float),
        "dither": ("dither", float),
        "preemphasis-coefficient": ("preemph_coeff", float),
        "remove-dc-offset": ("remove_dc_offset", lambda v: v == "true"),
        "window-type": ("window_type", str),
        "round-to-power-of-two": ("round_to_power_of_two", lambda v: v == "true"),
        "snip-edges": ("snip_edges", lambda v: v == "true"),
        "num-mel-bins": ("num_mel_bins", int),
        "low-freq": ("low_freq", float),
        "high-freq": ("high_freq", float),
        "num-ceps": ("num_ceps", int),
        "use-energy": ("use_energy", lambda v: v == "true"),
        "raw-energy": ("raw_energy", lambda v: v == "true"),
        "cepstral-lifter": ("cepstral_lifter", float),
        "energy-floor": ("energy_floor", float),
    }
    kwargs = {}
    for key, value in conf.items():
        mapping = key_map.get(key)
        if mapping is not None:
            field_name, conv = mapping
            kwargs[field_name] = conv(value)
    return FrontendConfig(**kwargs)


def num_frames(cfg: FrontendConfig, num_samples: int) -> int:
    """Frame count (feature-window.cc NumFrames; snip_edges=False uses the
    flush=true count: round(num_samples / frame_shift))."""
    if not cfg.snip_edges:
        return (num_samples + cfg.frame_shift // 2) // cfg.frame_shift
    if num_samples < cfg.frame_length:
        return 0
    return 1 + (num_samples - cfg.frame_length) // cfg.frame_shift


def frame_indices(cfg: FrontendConfig, num_samples: int) -> np.ndarray:
    """[T, frame_length] sample indices per frame.

    snip_edges=True: frame f starts at f*shift, fully inside the signal.
    snip_edges=False: frame f is centered at f*shift + shift/2, with
    out-of-range samples reflected around the signal edges
    (feature-window.cc FirstSampleOfFrame:30-41, ExtractWindow:199-216)."""
    T = num_frames(cfg, num_samples)
    if cfg.snip_edges:
        starts = np.arange(T) * cfg.frame_shift
        return starts[:, None] + np.arange(cfg.frame_length)[None, :]
    starts = (
        np.arange(T) * cfg.frame_shift
        + cfg.frame_shift // 2
        - cfg.frame_length // 2
    )
    idx = starts[:, None] + np.arange(cfg.frame_length)[None, :]
    for _ in range(2):  # repeated reflection only for pathological lengths
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)
    return np.clip(idx, 0, num_samples - 1)


def _mel_scale(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def _window_function(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "povey":
        return np.power(0.5 - 0.5 * np.cos(a * i), 0.85)
    if cfg.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if cfg.window_type == "sine":
        return np.sin(0.5 * a * i)
    if cfg.window_type == "rectangular":
        return np.ones(n, dtype=np.float64)
    raise ValueError(f"unknown window type {cfg.window_type!r}")


def make_mel_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Dense mel weight matrix [num_fft_bins+1, num_mel_bins].

    Triangular filters laid out in mel space exactly as MelBanks::MelBanks
    (mel-computations.cc): num_bins+1 divisions between low and high, each
    filter spanning [left_mel, right_mel] with apex at center_mel; FFT bins
    strictly inside the open interval get a weight. The Nyquist bin (last
    row) is always zero, matching Kaldi's loop over window/2 bins.
    """
    padded = cfg.padded_window_size
    num_fft_bins = padded // 2
    nyquist = 0.5 * cfg.samp_freq
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not (0 <= cfg.low_freq < nyquist and 0 < high_freq <= nyquist):
        raise ValueError("bad low/high freq")

    fft_bin_width = cfg.samp_freq / padded
    mel_low = _mel_scale(np.array(cfg.low_freq))
    mel_high = _mel_scale(np.array(high_freq))
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)
    bin_mels = _mel_scale(bin_freqs)  # [F]

    left = mel_low + np.arange(cfg.num_mel_bins, dtype=np.float64) * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    mel = bin_mels[:, None]  # [F, 1]
    up = (mel - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - mel) / (right - center)[None, :]
    weights = np.where(mel <= center[None, :], up, down)
    inside = (mel > left[None, :]) & (mel < right[None, :])
    weights = np.where(inside, weights, 0.0)

    out = np.zeros((num_fft_bins + 1, cfg.num_mel_bins), dtype=np.float64)
    out[:num_fft_bins] = weights
    return out


def make_dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows (matrix-functions.cc ComputeDctMatrix),
    returned transposed as [num_cols(mel), num_rows(ceps)] for right-matmul."""
    n = num_cols
    k = np.arange(num_rows, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi / n * (j + 0.5) * k)
    m[0, :] = np.sqrt(1.0 / n)
    return m.T.copy()


def make_lifter_coeffs(q: float, num_ceps: int) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * q * np.sin(np.pi * i / q)


@dataclass(frozen=True)
class FrontendParams:
    """Precomputed constant tensors for the jitted MFCC path."""

    cfg: FrontendConfig
    window: jnp.ndarray  # [frame_length]
    mel_weights: jnp.ndarray  # [padded//2 + 1, num_mel_bins]
    dct: jnp.ndarray  # [num_mel_bins, num_ceps]
    lifter: jnp.ndarray  # [num_ceps]


def make_frontend_params(cfg: FrontendConfig, dtype=jnp.float32) -> FrontendParams:
    return FrontendParams(
        cfg=cfg,
        window=jnp.asarray(_window_function(cfg), dtype=dtype),
        mel_weights=jnp.asarray(make_mel_matrix(cfg), dtype=dtype),
        dct=jnp.asarray(make_dct_matrix(cfg.num_ceps, cfg.num_mel_bins), dtype=dtype),
        lifter=jnp.asarray(make_lifter_coeffs(cfg.cepstral_lifter, cfg.num_ceps), dtype=dtype),
    )


def _frames_from_samples(samples: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    """[B, S] -> [B, T, frame_length] frame gather (handles both
    snip_edges modes via frame_indices)."""
    idx = frame_indices(cfg, samples.shape[1])
    return samples[:, jnp.asarray(idx)]


def mfcc_batch(
    params: FrontendParams,
    samples: jnp.ndarray,
    dither_key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Compute MFCCs for a batch of equal-length streams.

    Args:
      params: constants from make_frontend_params.
      samples: [B, S] float32 waveform in 16-bit integer range (Kaldi
        convention: samples are the raw int16 values as floats).
      dither_key: optional PRNG key; adds N(0, dither) noise like
        feature-window.cc Dither when cfg.dither > 0.

    Returns:
      [B, T, num_ceps] float32 features, T = num_frames(cfg, S).
    """
    cfg = params.cfg
    B, S = samples.shape
    T = num_frames(cfg, S)
    if T == 0:
        return jnp.zeros((B, 0, cfg.num_ceps), dtype=samples.dtype)

    frames = _frames_from_samples(samples, cfg)

    if cfg.dither != 0.0 and dither_key is not None:
        noise = jax.random.normal(dither_key, frames.shape, dtype=frames.dtype)
        frames = frames + cfg.dither * noise

    if cfg.remove_dc_offset:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)

    eps = jnp.asarray(np.finfo(np.float32).eps, dtype=frames.dtype)
    if cfg.use_energy and cfg.raw_energy:
        raw_log_energy = jnp.log(
            jnp.maximum(jnp.sum(frames * frames, axis=-1), eps)
        )

    if cfg.preemph_coeff != 0.0:
        shifted = jnp.concatenate([frames[..., :1], frames[..., :-1]], axis=-1)
        frames = frames - cfg.preemph_coeff * shifted

    frames = frames * params.window

    if cfg.use_energy and not cfg.raw_energy:
        raw_log_energy = jnp.log(
            jnp.maximum(jnp.sum(frames * frames, axis=-1), eps)
        )

    padded = cfg.padded_window_size
    if padded != cfg.frame_length:
        frames = jnp.pad(frames, ((0, 0), (0, 0), (0, padded - cfg.frame_length)))

    spec = jnp.fft.rfft(frames, axis=-1)
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2  # [B, T, padded//2+1]

    # Small matmuls carrying feature numerics: force full f32 accumulation
    # (a default-precision f32 matmul may round its inputs to TF32 or bf16,
    # which audibly perturbs log-mel).
    mel = jax.lax.dot_general(
        power.astype(params.mel_weights.dtype),
        params.mel_weights,
        dimension_numbers=(((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    logmel = jnp.log(jnp.maximum(mel, eps))
    feats = jax.lax.dot_general(
        logmel,
        params.dct,
        dimension_numbers=(((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )

    if cfg.cepstral_lifter != 0.0:
        feats = feats * params.lifter

    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            raw_log_energy = jnp.maximum(
                raw_log_energy, jnp.log(cfg.energy_floor)
            )
        feats = feats.at[..., 0].set(raw_log_energy)

    return feats


# ---------------------------------------------------------------------------
# NumPy float64 reference (independent implementation for tests)
# ---------------------------------------------------------------------------


def mfcc_numpy(cfg: FrontendConfig, samples: np.ndarray) -> np.ndarray:
    """Reference MFCC over one waveform [S] -> [T, num_ceps] (float64)."""
    samples = np.asarray(samples, dtype=np.float64)
    T = num_frames(cfg, samples.shape[0])
    window = _window_function(cfg)
    mel_w = make_mel_matrix(cfg)
    dct = make_dct_matrix(cfg.num_ceps, cfg.num_mel_bins)
    lifter = make_lifter_coeffs(cfg.cepstral_lifter, cfg.num_ceps)
    padded = cfg.padded_window_size
    eps = float(np.finfo(np.float32).eps)

    idx = frame_indices(cfg, samples.shape[0])
    out = np.zeros((T, cfg.num_ceps), dtype=np.float64)
    for t in range(T):
        frame = samples[idx[t]].copy()
        if cfg.remove_dc_offset:
            frame -= frame.mean()
        if cfg.use_energy and cfg.raw_energy:
            log_e = np.log(max(np.dot(frame, frame), eps))
        if cfg.preemph_coeff != 0.0:
            prev = np.concatenate([frame[:1], frame[:-1]])
            frame = frame - cfg.preemph_coeff * prev
        frame = frame * window
        if cfg.use_energy and not cfg.raw_energy:
            log_e = np.log(max(np.dot(frame, frame), eps))
        buf = np.zeros(padded, dtype=np.float64)
        buf[: cfg.frame_length] = frame
        spec = np.fft.rfft(buf)
        power = spec.real**2 + spec.imag**2
        mel = power @ mel_w
        logmel = np.log(np.maximum(mel, eps))
        feats = logmel @ dct
        if cfg.cepstral_lifter != 0.0:
            feats = feats * lifter
        if cfg.use_energy:
            if cfg.energy_floor > 0.0:
                log_e = max(log_e, np.log(cfg.energy_floor))
            feats[0] = log_e
        out[t] = feats
    return out
