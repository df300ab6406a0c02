"""Batched online i-vector extraction (JAX).

Replaces Kaldi's OnlineIvectorFeature pipeline
(kaldi/src/online2/online-ivector-feature.cc + ivector/ivector-extractor.cc
GetIvectorDistMean/Prior) with batched tensor ops over [streams, frames]:

  splice(+-3) -> LDA -> diag-UBM log-likes -> top-k gselect posteriors
  (min_post prune + renorm, posterior_scale; hmm/posterior.cc:440-508)
  -> zeroth/first-order stats (max_count rescaling)
  -> per-stream linear solve: (I + sum_i gamma_i M_i^T S_i M_i)^-1
     (sum_i M_i^T S_i X_i + prior e0), then ivector[0] -= prior_offset
     (online-ivector-feature.cc:347-353).

Two modes: one whole-utterance ivector per stream (the --online=false path
used by transcribe_wav, online2-wav-nnet3-latgen-faster.cc:119-127), or
periodic estimates every ivector_period frames for streaming.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..io.ivector import DiagGmm, IvectorExtractor, OnlineIvectorConfig


def _f32_exact(fn):
    """Trace ``fn``'s matmuls at Precision.HIGHEST: a default-precision f32
    matmul may round its inputs to TF32 on the GPU, which can flip the
    top-k Gaussian selection and moves the i-vector solve."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


@dataclass(frozen=True)
class IvectorParams:
    """Device-resident constants for extraction."""

    # GMM (in LDA space)
    gconsts: jnp.ndarray  # [I]
    means_invvars: jnp.ndarray  # [I, D]
    inv_vars: jnp.ndarray  # [I, D]
    # Extractor derived tensors
    sigma_inv_m: jnp.ndarray  # [I, D, K]  == Sigma_i^-1 M_i
    U: jnp.ndarray  # [I, K, K]  == M_i^T Sigma_i^-1 M_i
    prior_offset: float
    # Front transform
    lda: jnp.ndarray  # [out_dim, spliced_dim (+1 if offset)]
    lda_offset: Optional[jnp.ndarray]  # [out_dim] or None
    splice_left: int
    splice_right: int
    num_gselect: int
    min_post: float
    posterior_scale: float
    max_count: float
    ivector_period: int

    @property
    def ivector_dim(self) -> int:
        return self.U.shape[1]


def make_ivector_params(
    dubm: DiagGmm,
    extractor: IvectorExtractor,
    lda_mat: np.ndarray,
    cfg: Optional[OnlineIvectorConfig] = None,
) -> IvectorParams:
    cfg = cfg or OnlineIvectorConfig()
    sigma_inv_m = np.einsum("ide,iek->idk", extractor.sigma_inv, extractor.M)
    U = np.einsum("idk,idl->ikl", extractor.M, sigma_inv_m)
    lda = np.asarray(lda_mat, dtype=np.float32)
    return IvectorParams(
        gconsts=jnp.asarray(dubm.gconsts),
        means_invvars=jnp.asarray(dubm.means_invvars),
        inv_vars=jnp.asarray(dubm.inv_vars),
        sigma_inv_m=jnp.asarray(sigma_inv_m, dtype=jnp.float32),
        U=jnp.asarray(U, dtype=jnp.float32),
        prior_offset=float(extractor.prior_offset),
        lda=jnp.asarray(lda),
        lda_offset=None,
        splice_left=cfg.splice_left,
        splice_right=cfg.splice_right,
        num_gselect=cfg.num_gselect,
        min_post=cfg.min_post,
        posterior_scale=cfg.posterior_scale,
        max_count=cfg.max_count,
        ivector_period=cfg.ivector_period,
    )


def splice_frames(feats: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    """[B, T, D] -> [B, T, D*(left+1+right)] with edge clamping
    (OnlineSpliceFrames, online-feature.h:458)."""
    T = feats.shape[1]
    parts = []
    for off in range(-left, right + 1):
        idx = np.clip(np.arange(T) + off, 0, T - 1)
        parts.append(feats[:, idx])
    return jnp.concatenate(parts, axis=-1)


@_f32_exact
def apply_lda(spliced: jnp.ndarray, params: IvectorParams) -> jnp.ndarray:
    """LDA/affine transform; final.mat may have a trailing offset column."""
    lda = params.lda
    in_dim = spliced.shape[-1]
    if lda.shape[1] == in_dim + 1:
        return spliced @ lda[:, :in_dim].T + lda[:, in_dim]
    return spliced @ lda.T


@_f32_exact
def splice_lda(feats: jnp.ndarray, params: IvectorParams) -> jnp.ndarray:
    """Fused splice(+-ctx) -> LDA: one matmul per splice offset, summed.

    Equivalent to apply_lda(splice_frames(feats, ...), params) but the
    [B, T, D*(l+1+r)] splice concat never materializes — each offset's
    shifted view multiplies its own D-column block of the LDA matrix
    (the same per-offset trick as the TdnnComponent forward)."""
    left, right = params.splice_left, params.splice_right
    T = feats.shape[1]
    D = feats.shape[-1]
    lda = params.lda
    n_blocks = left + 1 + right
    has_offset = lda.shape[1] == n_blocks * D + 1
    out = None
    for i, off in enumerate(range(-left, right + 1)):
        idx = np.clip(np.arange(T) + off, 0, T - 1)
        block = lda[:, i * D : (i + 1) * D].T  # [D, out]
        y = feats[:, idx] @ block
        out = y if out is None else out + y
    if has_offset:
        out = out + lda[:, n_blocks * D]
    return out


@_f32_exact
def gmm_log_likes(lda_feats: jnp.ndarray, params: IvectorParams) -> jnp.ndarray:
    """[B, T, D] -> [B, T, I] per-Gaussian log-likelihoods
    (DiagGmm::LogLikelihoods: gconst + m'Sx - 0.5 x'Sx)."""
    x = lda_feats
    lin = x @ params.means_invvars.T  # [B, T, I]
    quad = (x * x) @ params.inv_vars.T
    return params.gconsts[None, None, :] + lin - 0.5 * quad


def gselect_posteriors(
    log_likes: jnp.ndarray, params: IvectorParams
) -> jnp.ndarray:
    """Dense pruned posteriors [B, T, I] (zeros outside the top-k).

    Follows VectorToPosteriorEntry (posterior.cc:440-508): top num_gselect
    by likelihood, prune entries below min_post of the selected total,
    renormalize, then scale by posterior_scale."""
    B, T, I = log_likes.shape
    k = min(params.num_gselect, I)
    if k <= 8:
        # k rounds of argmax+mask beat lax.top_k's sort lowering for the
        # tiny k this pipeline uses (num_gselect=5). argmax takes the
        # first index on ties — the same top-k set, Kaldi-equivalent
        # pruning.
        masked = log_likes
        vals, idxs = [], []
        for _ in range(k):
            i = jnp.argmax(masked, axis=-1)
            vals.append(jnp.max(masked, axis=-1))
            idxs.append(i)
            masked = jnp.where(
                jnp.arange(I, dtype=i.dtype) == i[..., None], -jnp.inf, masked
            )
        top_ll = jnp.stack(vals, axis=-1)  # [B, T, k]
        top_idx = jnp.stack(idxs, axis=-1)
    else:
        top_ll, top_idx = jax.lax.top_k(log_likes, k)  # [B, T, k]
    p = jnp.exp(top_ll - top_ll[..., :1])
    tot = jnp.sum(p, axis=-1, keepdims=True)
    keep = p >= params.min_post * tot
    p = jnp.where(keep, p, 0.0)
    p = p / jnp.maximum(jnp.sum(p, axis=-1, keepdims=True), 1e-20)
    p = p * params.posterior_scale

    dense = jnp.zeros((B, T, I), dtype=log_likes.dtype)
    b_idx = jnp.arange(B)[:, None, None]
    t_idx = jnp.arange(T)[None, :, None]
    dense = dense.at[b_idx, t_idx, top_idx].add(p)
    return dense


@_f32_exact
def accumulate_stats(
    lda_feats: jnp.ndarray,
    post: jnp.ndarray,
    lengths: Optional[jnp.ndarray] = None,
    frame_weights: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Zeroth/first-order stats: gamma [B, I], X [B, I, D]
    (IvectorExtractorUtteranceStats::AccStats).

    frame_weights [B, T] implements OnlineSilenceWeighting's effect
    (online-ivector-feature.h:511-512): per-frame posterior scaling, e.g.
    down-weighting frames the decoder aligned to silence."""
    if lengths is not None:
        T = lda_feats.shape[1]
        mask = (jnp.arange(T)[None, :] < lengths[:, None]).astype(post.dtype)
        post = post * mask[:, :, None]
    if frame_weights is not None:
        post = post * frame_weights[:, :, None]
    gamma = jnp.sum(post, axis=1)  # [B, I]
    X = jnp.einsum("bti,btd->bid", post, lda_feats)
    return gamma, X


@_f32_exact
def solve_ivector(
    gamma: jnp.ndarray, X: jnp.ndarray, params: IvectorParams
) -> jnp.ndarray:
    """[B, I], [B, I, D] -> [B, K] i-vectors (prior offset subtracted)."""
    if params.max_count > 0:
        tot = jnp.sum(gamma, axis=-1, keepdims=True)
        scale = jnp.minimum(1.0, params.max_count / jnp.maximum(tot, 1e-10))
        gamma = gamma * scale
        X = X * scale[..., None]

    K = params.ivector_dim
    linear = jnp.einsum("bid,idk->bk", X, params.sigma_inv_m)
    linear = linear.at[:, 0].add(params.prior_offset)
    quad = jnp.einsum("bi,ikl->bkl", gamma, params.U)
    quad = quad + jnp.eye(K, dtype=quad.dtype)[None]
    # quad = I + sum_i gamma_i U_i with gamma_i >= 0 and U_i PSD, so it is
    # symmetric positive definite, so Cholesky replaces the general LU
    # solve.
    factor = jax.scipy.linalg.cho_factor(quad)
    ivec = jax.scipy.linalg.cho_solve(factor, linear[..., None])[..., 0]
    return ivec.at[:, 0].add(-params.prior_offset)


def extract_ivectors(
    feats: jnp.ndarray,
    params: IvectorParams,
    lengths: Optional[jnp.ndarray] = None,
    frame_weights: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Whole-utterance mode: [B, T, D] base features -> [B, K] ivectors."""
    lda_feats = splice_lda(feats, params)
    ll = gmm_log_likes(lda_feats, params)
    post = gselect_posteriors(ll, params)
    gamma, X = accumulate_stats(lda_feats, post, lengths, frame_weights)
    return solve_ivector(gamma, X, params)


def extract_ivectors_online(
    feats: jnp.ndarray,
    params: IvectorParams,
) -> jnp.ndarray:
    """Periodic mode: estimates at every ivector_period frames using stats
    of all frames seen so far. [B, T, D] -> [B, ceil(T/period), K]."""
    spliced = splice_frames(feats, params.splice_left, params.splice_right)
    lda_feats = apply_lda(spliced, params)
    ll = gmm_log_likes(lda_feats, params)
    post = gselect_posteriors(ll, params)

    gamma_t = jnp.cumsum(post, axis=1)  # [B, T, I]
    X_t = jnp.cumsum(post[..., None] * lda_feats[:, :, None, :], axis=1)
    T = feats.shape[1]
    period = params.ivector_period
    marks = np.minimum(np.arange(0, T, period) + period - 1, T - 1)
    gammas = gamma_t[:, marks]  # [B, P, I]
    Xs = X_t[:, marks]  # [B, P, I, D]
    B, P = gammas.shape[0], gammas.shape[1]
    flat = solve_ivector(
        gammas.reshape(B * P, -1),
        Xs.reshape(B * P, Xs.shape[2], Xs.shape[3]),
        params,
    )
    return flat.reshape(B, P, -1)


# ---------------------------------------------------------------------------
# NumPy reference (for tests)
# ---------------------------------------------------------------------------


def ivector_numpy(
    feats: np.ndarray,
    dubm: DiagGmm,
    extractor: IvectorExtractor,
    lda_mat: np.ndarray,
    cfg: OnlineIvectorConfig,
) -> np.ndarray:
    """Single-utterance float64 reference following the Kaldi code paths."""
    T, D0 = feats.shape
    left, right = cfg.splice_left, cfg.splice_right
    spliced = np.concatenate(
        [feats[np.clip(np.arange(T) + off, 0, T - 1)] for off in range(-left, right + 1)],
        axis=1,
    )
    lda = np.asarray(lda_mat, dtype=np.float64)
    if lda.shape[1] == spliced.shape[1] + 1:
        x = spliced @ lda[:, :-1].T + lda[:, -1]
    else:
        x = spliced @ lda.T

    ll = (
        dubm.gconsts[None, :]
        + x @ dubm.means_invvars.T
        - 0.5 * (x * x) @ dubm.inv_vars.T
    )
    I = dubm.num_gauss
    k = min(cfg.num_gselect, I)
    gamma = np.zeros(I)
    X = np.zeros((I, x.shape[1]))
    for t in range(T):
        order = np.argsort(-ll[t])[:k]
        p = np.exp(ll[t][order] - ll[t][order[0]])
        tot = p.sum()
        keep = p >= cfg.min_post * tot
        p = np.where(keep, p, 0.0)
        p = p / p.sum() * cfg.posterior_scale
        for j, i in enumerate(order):
            gamma[i] += p[j]
            X[i] += p[j] * x[t]

    tot = gamma.sum()
    if cfg.max_count > 0 and tot > cfg.max_count:
        scale = cfg.max_count / tot
        gamma *= scale
        X *= scale

    K = extractor.ivector_dim
    sigma_inv_m = np.einsum("ide,iek->idk", extractor.sigma_inv, extractor.M)
    linear = np.einsum("id,idk->k", X, sigma_inv_m)
    linear[0] += extractor.prior_offset
    U = np.einsum("idk,idl->ikl", extractor.M, sigma_inv_m)
    quad = np.eye(K) + np.einsum("i,ikl->kl", gamma, U)
    ivec = np.linalg.solve(quad, linear)
    ivec[0] -= extractor.prior_offset
    return ivec
