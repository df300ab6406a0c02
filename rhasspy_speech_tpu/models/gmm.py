"""Diagonal-GMM acoustic model: batched per-pdf log-likelihoods.

The reference enum carries ModelType.gmm backed by Kaldi's gmm/ tree
(am-diag-gmm.{h,cc}); the Python GMM decode path there is dead code
(transcribe_wav.py:238-484 commented out). This implements the capability
on the device: per-frame log-likelihoods for every pdf's diagonal GMM in two
matmuls over a component-padded parameter block —

    ll[b,t,p,c] = gconst[p,c] + x . (mu/var)[p,c] - 0.5 x^2 . (1/var)[p,c]
    ll[b,t,p]   = logsumexp_c ll[b,t,p,c]

(gmm/diag-gmm.cc LogLikelihoods: gconst already folds the weight,
normalizer, and -0.5 mu^2/var terms). Both contractions are [B*T, D] x
[D, P*C] matmuls; padded components carry gconst = -inf.

Feature pipeline for GMM models: MFCC + delta-deltas
(online-gmm-decoding / OnlineDeltaFeature, online-feature.h:530) — no
i-vectors, no frame subsampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

import jax.numpy as jnp

NEG_HUGE = -1.0e30


@dataclass
class GmmAm:
    """Component-padded parameters for all pdfs: [P, C, ...]."""

    gconsts: np.ndarray  # [P, C] f32, NEG_HUGE on padding
    means_invvars: np.ndarray  # [P, C, D]
    inv_vars: np.ndarray  # [P, C, D]

    @property
    def num_pdfs(self) -> int:
        return self.gconsts.shape[0]

    @property
    def dim(self) -> int:
        return self.means_invvars.shape[2]

    @staticmethod
    def from_diag_gmms(gmms: List["object"]) -> "GmmAm":
        """Pad a list of io.ivector.DiagGmm (one per pdf) to [P, Cmax]."""
        P = len(gmms)
        C = max(g.num_gauss for g in gmms)
        D = gmms[0].dim
        gconsts = np.full((P, C), NEG_HUGE, dtype=np.float32)
        miv = np.zeros((P, C, D), dtype=np.float32)
        iv = np.zeros((P, C, D), dtype=np.float32)
        for p, g in enumerate(gmms):
            n = g.num_gauss
            gconsts[p, :n] = g.gconsts
            miv[p, :n] = g.means_invvars
            iv[p, :n] = g.inv_vars
        return GmmAm(gconsts=gconsts, means_invvars=miv, inv_vars=iv)

    def log_likes(self, feats: jnp.ndarray) -> jnp.ndarray:
        """[B, T, D] -> [B, T, P] log p(x | pdf)."""
        P, C, D = self.means_invvars.shape
        miv = jnp.asarray(self.means_invvars).reshape(P * C, D)
        iv = jnp.asarray(self.inv_vars).reshape(P * C, D)
        g = jnp.asarray(self.gconsts).reshape(P * C)
        x = feats
        ll = (
            g[None, None, :]
            + x @ miv.T
            - 0.5 * (x * x) @ iv.T
        )  # [B, T, P*C]
        ll = ll.reshape(x.shape[0], x.shape[1], P, C)
        m = jnp.max(ll, axis=-1)
        safe = jnp.where(jnp.isfinite(m), m, 0.0)
        out = safe + jnp.log(
            jnp.sum(jnp.exp(ll - safe[..., None]), axis=-1)
        )
        return jnp.where(jnp.isfinite(m), out, NEG_HUGE)


class GmmChunkModel:
    """Streaming chunk-model adapter: the StreamScheduler's model
    contract (``ranges``/``recurrent``/``cast``/``forward``) over
    deltas + delta-deltas + :meth:`GmmAm.log_likes`.

    Mirrors the batch GMM path (pipeline/transcribe.py log_probs:
    add_deltas(order=2) -> per-pdf log-likelihoods, subsampling 1, no
    i-vector) on a per-chunk window: the window carries ±4 context
    frames (delta window 2 per order x order 2), so the sliced center
    chunk's deltas are exact mid-utterance, and the feature ring's
    edge clamping replicates boundary rows exactly like add_deltas'
    own std::min/max indexing (feat/delta-feats.cc semantics) at
    utterance edges. This goes beyond the reference, whose GMM
    streaming is dead code (transcribe_wav.py:238-484)."""

    recurrent = False

    def __init__(self, gmm: GmmAm, chunk_out: int, order: int = 2,
                 window: int = 2):
        self.gmm = gmm
        self._ctx = order * window
        self._chunk = chunk_out
        self.ranges = {"input": (-self._ctx, chunk_out + self._ctx)}
        self.left_context = self._ctx
        self.right_context = self._ctx
        self._order = order

    def cast(self, dtype):
        """Log-likelihoods stay f32 (no matmul-heavy stack to cast)."""
        return self

    def forward(self, windows):
        """[N, W, D] window -> [N, chunk, P] log-likelihoods."""
        from ..ops.deltas import add_deltas

        full = add_deltas(windows, order=self._order)
        return self.gmm.log_likes(
            full[:, self._ctx : self._ctx + self._chunk]
        )
