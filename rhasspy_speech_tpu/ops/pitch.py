"""Kaldi pitch features (compute-kaldi-pitch-feats) as batched device ops.

Implements the Ghahremani et al. 2014 pitch tracker the reference's feature
pipeline can append to MFCCs (online2/online-nnet2-feature-pipeline.cc:90-140,
feat/pitch-functions.{h,cc}):

1. Downsample to ``resample_freq`` (4 kHz) with a windowed-sinc low-pass at
   ``lowpass_cutoff`` (LinearResample; feat/resample.cc FilterFunc).
2. Per frame, NCCF over integer lags covering f0 in [min_f0, max_f0] — two
   variants: with an energy-dependent ballast (for the pitch Viterbi) and
   without (for the probability-of-voicing), pitch-functions.cc:1110-1154.
   The ballast follows nccf_ballast_online=true semantics (cumulative
   signal statistics up to each frame; :1116-1137) — a supported Kaldi
   configuration that is also deterministic per frame.
3. Windowed-sinc interpolation of the NCCF onto log-spaced lags
   (ArbitraryResample with cutoff resample_freq/2, num_zeros =
   upsample_filter_width; pitch-functions.cc:735-758) — one matmul here.
4. Viterbi over lags: local cost 1 - phi*(1 - soft_min_f0*lag) (eq. 5;
   :178-191) + transition cost (i-j)^2 * log(1+delta_pitch)^2 *
   penalty_factor (:316-319); whole-utterance traceback (max latency).
5. Post-processing (OnlineProcessPitch, :1423-1540): POV feature
   pov_scale*((1.0001-nccf)^0.15 - 1), mean-normalized log pitch over a
   sliding window weighted by p(voicing), and delta log pitch (delta
   noise disabled: deterministic inference; delta_pitch_noise_stddev is a
   training-time augmentation).

Output: [B, T, 3] = (pov_feature, normalized_log_pitch, delta_pitch),
the default 3-dim pitch feature vector appended to MFCCs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class PitchConfig:
    """PitchExtractionOptions defaults (pitch-functions.h:113-133)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5

    # ProcessPitchOptions (pitch-functions.h:235-250)
    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_window: int = 2
    normalization_left_context: int = 75
    normalization_right_context: int = 75

    @property
    def frame_shift(self) -> int:  # at resample_freq
        return int(round(self.resample_freq * self.frame_shift_ms / 1000.0))

    @property
    def frame_length(self) -> int:  # "basic frame length" at resample_freq
        return int(round(self.resample_freq * self.frame_length_ms / 1000.0))


def pitch_config_from_conf(path, samp_freq: Optional[float] = None) -> PitchConfig:
    """Parse a Kaldi pitch conf (lines of ``--kebab-key=value``) into a
    PitchConfig; unknown keys are ignored (prepare_online_decoding.sh writes
    a number of keys this implementation fixes at their defaults)."""
    fields = {f for f in PitchConfig.__dataclass_fields__}
    kwargs = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("--") or "=" not in line:
                continue
            key, val = line[2:].split("=", 1)
            key = key.replace("-", "_")
            if key in fields:
                typ = PitchConfig.__dataclass_fields__[key].type
                kwargs[key] = int(val) if "int" in str(typ) else float(val)
    if samp_freq is not None:
        kwargs.setdefault("samp_freq", samp_freq)
    return PitchConfig(**kwargs)


def _filter_func(t: np.ndarray, cutoff: float, num_zeros: int) -> np.ndarray:
    """Windowed sinc h(t) = sinc-filter * raised-cosine window
    (feat/resample.cc FilterFunc)."""
    t = np.asarray(t, dtype=np.float64)
    support = num_zeros / (2.0 * cutoff)
    window = np.where(
        np.abs(t) < support,
        0.5 * (1 + np.cos(2 * np.pi * cutoff / num_zeros * t)),
        0.0,
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        filt = np.where(
            t != 0.0,
            np.sin(2 * np.pi * cutoff * t) / (np.pi * t),
            2.0 * cutoff,
        )
    return filt * window


def _downsample_kernel(cfg: PitchConfig) -> Tuple[np.ndarray, int]:
    """Integer-ratio polyphase kernel for samp_freq -> resample_freq
    (LinearResample with cutoff lowpass_cutoff, num_zeros =
    lowpass_filter_width). Returns (taps [K], left offset in input samples)."""
    ratio = cfg.samp_freq / cfg.resample_freq
    if abs(ratio - round(ratio)) > 1e-6:
        raise ValueError("samp_freq must be an integer multiple of resample_freq")
    cutoff = cfg.lowpass_cutoff
    num_zeros = cfg.lowpass_filter_width
    half = num_zeros / (2.0 * cutoff)  # filter support in seconds
    half_samples = int(math.ceil(half * cfg.samp_freq))
    offs = np.arange(-half_samples, half_samples + 1)
    taps = _filter_func(offs / cfg.samp_freq, cutoff, num_zeros) / cfg.samp_freq
    return taps.astype(np.float32), half_samples


def make_lags(cfg: PitchConfig) -> np.ndarray:
    """Log-spaced lags in seconds (SelectLags, pitch-functions.cc:157-168)."""
    min_lag, max_lag = 1.0 / cfg.max_f0, 1.0 / cfg.min_f0
    lags = []
    lag = min_lag
    while lag <= max_lag:
        lags.append(lag)
        lag *= 1.0 + cfg.delta_pitch
    return np.asarray(lags, dtype=np.float64)


def _nccf_lag_range(cfg: PitchConfig) -> Tuple[int, int]:
    """Integer measured-lag range with upsampling margin
    (pitch-functions.cc:723-728)."""
    margin = cfg.upsample_filter_width / (2.0 * cfg.resample_freq)
    first = int(math.ceil(cfg.resample_freq * (1.0 / cfg.max_f0 - margin)))
    last = int(math.floor(cfg.resample_freq * (1.0 / cfg.min_f0 + margin)))
    return max(first, 1), last


def _upsample_matrix(cfg: PitchConfig, lags: np.ndarray) -> np.ndarray:
    """[num_lags, num_measured] windowed-sinc interpolation weights
    (ArbitraryResample; cutoff resample_freq/2, pitch-functions.cc:743)."""
    first, last = _nccf_lag_range(cfg)
    measured = np.arange(first, last + 1) / cfg.resample_freq  # seconds
    cutoff = cfg.resample_freq * 0.5
    dt = lags[:, None] - measured[None, :]
    w = _filter_func(dt, cutoff, cfg.upsample_filter_width) / cfg.resample_freq
    return w.astype(np.float32)


def num_pitch_frames(cfg: PitchConfig, num_samples: int) -> int:
    n_ds = int(num_samples * cfg.resample_freq / cfg.samp_freq)
    _first, last = _nccf_lag_range(cfg)
    full = cfg.frame_length + last
    if n_ds < full:
        return 0
    return 1 + (n_ds - full) // cfg.frame_shift


def pitch_track(
    cfg: PitchConfig,
    pcm: jnp.ndarray,  # [B, S] float32
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Raw tracker output: ([B, T] pitch in Hz, [B, T] POV-NCCF values at
    the Viterbi lag) — the (NCCF, pitch) pair OnlinePitchFeature::GetFrame
    serves (pitch-functions.cc:1431-1436 consumes it)."""
    B = pcm.shape[0]
    taps, half = _downsample_kernel(cfg)
    ratio = int(round(cfg.samp_freq / cfg.resample_freq))

    # 1. downsample (strided correlation with the sinc kernel)
    padded = jnp.pad(pcm, ((0, 0), (half, half)))
    ds = jax.lax.conv_general_dilated(
        padded[:, None, :],
        jnp.asarray(taps)[None, None, :],
        window_strides=(ratio,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :]

    first, last = _nccf_lag_range(cfg)
    basic = cfg.frame_length
    shift = cfg.frame_shift
    full = basic + last
    n_ds = ds.shape[1]
    T = max(1 + (n_ds - full) // shift, 1)
    if n_ds < full:
        ds = jnp.pad(ds, ((0, 0), (0, full - n_ds)))

    # 2. NCCF at integer lags
    starts = np.arange(T) * shift
    frame_idx = starts[:, None] + np.arange(full)[None, :]
    frames = ds[:, jnp.asarray(frame_idx)]  # [B, T, full]
    w0 = frames[:, :, :basic]
    lag_offsets = np.arange(first, last + 1)
    lag_idx = lag_offsets[:, None] + np.arange(basic)[None, :]  # [L, basic]
    wl = frames[:, :, jnp.asarray(lag_idx)]  # [B, T, L, basic]
    inner = jnp.einsum(
        "btc,btlc->btl", w0, wl, precision=jax.lax.Precision.HIGHEST
    )
    e1 = jnp.sum(w0 * w0, axis=-1)  # [B, T]
    e2 = jnp.sum(wl * wl, axis=-1)  # [B, T, L]
    norm = e1[:, :, None] * e2

    # cumulative signal variance up to each frame end (ballast, online mode)
    csum = jnp.cumsum(ds, axis=1)
    csum2 = jnp.cumsum(ds * ds, axis=1)
    end_i = np.minimum(starts + full, n_ds) - 1
    s1 = csum[:, jnp.asarray(end_i)]
    s2 = csum2[:, jnp.asarray(end_i)]
    cnt = jnp.asarray(np.minimum(starts + full, n_ds), dtype=ds.dtype)
    mean_sq = s2 / cnt - (s1 / cnt) ** 2  # [B, T]
    ballast = (mean_sq * basic) ** 2 * cfg.nccf_ballast

    eps = 1e-20
    nccf_pitch = inner / jnp.sqrt(norm + ballast[:, :, None] + eps)
    nccf_pov = inner / jnp.sqrt(norm + eps)

    # 3. interpolate onto log-spaced lags
    lags = make_lags(cfg)
    up = jnp.asarray(_upsample_matrix(cfg, lags))  # [NL, L]
    phi_pitch = jnp.einsum(
        "btl,nl->btn", nccf_pitch, up, precision=jax.lax.Precision.HIGHEST
    )
    phi_pov = jnp.einsum(
        "btl,nl->btn", nccf_pov, up, precision=jax.lax.Precision.HIGHEST
    )
    phi_pov = jnp.clip(phi_pov, -1.0, 1.0)

    # 4. Viterbi over lags
    lags_j = jnp.asarray(lags.astype(np.float32))
    local = 1.0 - phi_pitch * (1.0 - cfg.soft_min_f0 * lags_j[None, None, :])
    factor = math.log(1.0 + cfg.delta_pitch) ** 2 * cfg.penalty_factor
    idx = np.arange(lags.shape[0])
    trans = jnp.asarray(
        ((idx[:, None] - idx[None, :]) ** 2 * factor).astype(np.float32)
    )  # [i, j]

    local_t = jnp.swapaxes(local, 0, 1)  # [T, B, NL]

    def step(fwd, loc_t):
        scores = fwd[:, None, :] + trans[None, :, :]  # [B, i, j]
        best = jnp.min(scores, axis=-1)
        bp = jnp.argmin(scores, axis=-1).astype(jnp.int32)
        return loc_t + best, bp

    fwd0 = local_t[0]
    fwd_final, bps = jax.lax.scan(step, fwd0, local_t[1:])

    # traceback (reverse scan over backpointers)
    last_state = jnp.argmin(fwd_final, axis=-1).astype(jnp.int32)  # [B]

    def back(state, bp_t):
        prev = jnp.take_along_axis(bp_t, state[:, None], axis=1)[:, 0]
        return prev, prev

    _, prevs = jax.lax.scan(back, last_state, bps[::-1])
    states = jnp.concatenate([prevs[::-1], last_state[None]], axis=0)
    states = jnp.swapaxes(states, 0, 1)  # [B, T]

    pitch = 1.0 / lags_j[states]  # [B, T] Hz
    nccf_at = jnp.take_along_axis(phi_pov, states[:, :, None], axis=2)[..., 0]
    return pitch, nccf_at


def pitch_batch(
    cfg: PitchConfig,
    pcm: jnp.ndarray,  # [B, S] float32
) -> jnp.ndarray:
    """[B, S] audio -> [B, T, 3] (pov_feature, normalized_log_pitch,
    delta_pitch)."""
    B = pcm.shape[0]
    pitch, nccf_at = pitch_track(cfg, pcm)
    T = pitch.shape[1]

    # 5. post-processing
    pov_feat = cfg.pov_scale * ((1.0001 - jnp.clip(nccf_at, -1.0, 1.0)) ** 0.15 - 1.0)
    log_pitch = jnp.log(pitch)
    pov_prob = _nccf_to_pov(nccf_at)

    # sliding-window POV-weighted mean of log pitch
    lc, rc = cfg.normalization_left_context, cfg.normalization_right_context
    wsum = jnp.cumsum(pov_prob * log_pitch, axis=1)
    psum = jnp.cumsum(pov_prob, axis=1)
    zeros = jnp.zeros((B, 1), dtype=wsum.dtype)
    wsum = jnp.concatenate([zeros, wsum], axis=1)
    psum = jnp.concatenate([zeros, psum], axis=1)
    t_arr = np.arange(T)
    lo = np.maximum(0, t_arr - lc)
    hi = np.minimum(T, t_arr + rc + 1)
    wl_ = wsum[:, jnp.asarray(hi)] - wsum[:, jnp.asarray(lo)]
    pl_ = psum[:, jnp.asarray(hi)] - psum[:, jnp.asarray(lo)]
    avg = wl_ / jnp.maximum(pl_, 1e-10)
    norm_log_pitch = (log_pitch - avg) * cfg.pitch_scale

    delta = _delta_like_kaldi(log_pitch, cfg.delta_window) * cfg.delta_pitch_scale

    return jnp.stack([pov_feat, norm_log_pitch, delta], axis=-1)


def _nccf_to_pov(n: jnp.ndarray) -> jnp.ndarray:
    """NCCF -> probability of voicing (pitch-functions.cc:78-88)."""
    nd = jnp.clip(jnp.abs(n), 0.0, 1.0)
    r = (
        -5.2
        + 5.4 * jnp.exp(7.5 * (nd - 1.0))
        + 4.8 * nd
        - 2.0 * jnp.exp(-10.0 * nd)
        + 4.2 * jnp.exp(20.0 * (nd - 1.0))
    )
    return 1.0 / (1.0 + jnp.exp(-r))


def _delta_like_kaldi(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """First-order regression deltas with edge replication
    (featbin ComputeDeltas semantics). x: [B, T] -> [B, T]."""
    T = x.shape[1]
    offs = np.arange(-window, window + 1)
    denom = float(np.sum(offs**2))
    idx = np.clip(np.arange(T)[:, None] + offs[None, :], 0, T - 1)
    gathered = x[:, jnp.asarray(idx)]  # [B, T, 2w+1]
    coef = jnp.asarray((offs / denom).astype(np.float32))
    return jnp.einsum("btw,w->bt", gathered, coef)
