"""WAV transcription: MFCC -> nnet3 forward -> dense Viterbi -> n-best ->
fuzzy match / rescore -> decode_meta.

Replaces the reference's subprocess pipelines
(rhasspy_speech/transcribe_wav.py:35-202: online2-wav-nnet3-latgen-faster |
lattice-to-nbest | nbest-to-linear | int2sym.pl + the fuzzy/rescore FST
chains) with in-process batched device compute. The public surface mirrors
KaldiNnet3WavTranscriber: constructor (model_dir, graph_dir, decode
hyperparameters) and async_transcribe / async_transcribe_rescore returning
decoded strings.

Batching: transcribe_batch decodes many WAVs in one device program —
utterances are length-bucketed, padded, and masked (decoder `lengths`), so
the device sees [streams, frames, dim] tensors. This is the path the
throughput benchmarks use.
"""

from __future__ import annotations

import asyncio
import logging
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..grammar.fst import decode_meta
from ..io.nnet3_file import read_am_nnet3
from ..models.nnet3 import CompiledNnet3, compile_nnet3
from ..ops.decoder import (
    kbest_traces_to_nbest,
    make_decode_graph,
    trace_to_words,
    traces_to_words_batch,
    viterbi_decode,
    viterbi_decode_checkpointed,
    viterbi_kbest_decode,
)
from ..ops.frontend import FrontendConfig, make_frontend_params, mfcc_batch, num_frames
from ..utils.metrics import StageTimer, get_metrics
from .artifacts import LangArtifacts
from .fuzzy import get_fuzzy_text, rescore_nbest

_LOGGER = logging.getLogger(__name__)

_BUCKET = 16  # output-frame bucket size for compile caching


def read_wav(path: Union[str, Path]) -> np.ndarray:
    """WAV -> 16 kHz mono float32 samples (Kaldi int16 range).

    16 kHz mono s16le reads directly; other rates/channel counts go
    through the native runtime's decoder + windowed-sinc resampler (the
    job the reference delegates to sox, tests/resample.py)."""
    with wave.open(str(path), "rb") as w:
        if w.getframerate() == 16000 and w.getnchannels() == 1 and w.getsampwidth() == 2:
            return np.frombuffer(
                w.readframes(w.getnframes()), dtype=np.int16
            ).astype(np.float32)
        if w.getsampwidth() != 2:
            raise ValueError(
                f"{path}: expected 16-bit PCM, got {w.getsampwidth() * 8}-bit"
            )
    from ..native import load_wav

    return load_wav(str(path), target_rate=16000)


@dataclass
class _CompiledBucket:
    model: CompiledNnet3
    fwd: callable  # jitted forward


class AcousticModel:
    """A loaded nnet3 acoustic model + feature frontend.

    model_dir layout (export-compatible): model/final.mdl, model/phones.txt,
    optional model/frontend.json overriding MFCC hyperparameters."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        frontend: Optional[FrontendConfig] = None,
        subsampling: Optional[int] = None,
        compute_dtype: Optional[str] = None,
    ):
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        self._dither_calls = 0
        # A second serving process must not re-pay the flagship's 24-88 s
        # XLA compiles: persist compiled programs across processes.
        from ..utils.compile_cache import enable_compilation_cache

        enable_compilation_cache()
        # AM forward precision: None/f32 (the default; matmuls at
        # Precision.HIGHEST, so no TF32 rounding) or "bfloat16" — bf16
        # matmuls with f32 accumulation, output cast back to f32 for
        # decode costs. Also via RSTPU_COMPUTE_DTYPE.
        import os as _os

        self.compute_dtype = compute_dtype or _os.environ.get(
            "RSTPU_COMPUTE_DTYPE"
        )
        # our layout: model/final.mdl; exported voice2json profiles nest one
        # deeper (reference transcribe_wav.py:56: model/model/final.mdl)
        mdl_path = model_dir / "model" / "final.mdl"
        if not mdl_path.exists() and (
            model_dir / "model" / "model" / "final.mdl"
        ).exists():
            model_dir = model_dir / "model"
            mdl_path = model_dir / "model" / "final.mdl"
        self._resolved_model_dir = model_dir

        # GMM models (ModelType.gmm): final.mdl carries an AmDiagGmm after
        # the TransitionModel instead of <Nnet3>. Feature pipeline is MFCC
        # + delta-deltas, no i-vectors, no frame subsampling.
        from ..io.gmm_am import is_gmm_model

        self.gmm = None
        if is_gmm_model(str(mdl_path)):
            from ..io.gmm_am import read_am_diag_gmm
            from ..models.gmm import GmmAm

            self.transition_model, gmms = read_am_diag_gmm(str(mdl_path))
            self.gmm = GmmAm.from_diag_gmms(gmms)
            self.spec = None
            if subsampling is None:
                subsampling = 1
        else:
            self.transition_model, self.spec = read_am_nnet3(str(mdl_path))

        if subsampling is None:
            # Kaldi chain model dirs ship a frame_subsampling_factor file
            fsf = model_dir / "model" / "frame_subsampling_factor"
            subsampling = (
                int(fsf.read_text().strip()) if fsf.exists() else 3
            )

        if frontend is None:
            frontend_path = model_dir / "model" / "frontend.json"
            conf_candidates = [
                model_dir / "model" / "conf" / "mfcc_hires.conf",
                model_dir / "model" / "conf" / "mfcc.conf",
                model_dir / "model" / "online" / "conf" / "mfcc.conf",
            ]
            if frontend_path.exists():
                import json

                with open(frontend_path, "r", encoding="utf-8") as f:
                    frontend = FrontendConfig(**json.load(f))
            else:
                for conf in conf_candidates:
                    if conf.exists():
                        from ..ops.frontend import frontend_from_mfcc_conf

                        frontend = frontend_from_mfcc_conf(conf)
                        break
                else:
                    frontend = FrontendConfig()
        self.frontend_config = frontend
        self.frontend_params = make_frontend_params(frontend)
        self.subsampling = subsampling

        # Optional Kaldi pitch features appended to MFCCs, enabled the way
        # prepare_online_decoding.sh does: --add-pitch=true in online.conf
        # (online2/online-nnet2-feature-pipeline.cc:90-140).
        self.pitch_config = None
        online_conf = model_dir / "model" / "conf" / "online.conf"
        if online_conf.exists():
            text = online_conf.read_text(encoding="utf-8")
            if "--add-pitch=true" in text.replace(" ", ""):
                from ..ops.pitch import PitchConfig, pitch_config_from_conf

                pitch_conf = model_dir / "model" / "conf" / "pitch.conf"
                if pitch_conf.exists():
                    self.pitch_config = pitch_config_from_conf(
                        pitch_conf, samp_freq=frontend.samp_freq
                    )
                else:
                    self.pitch_config = PitchConfig(
                        samp_freq=frontend.samp_freq,
                        frame_shift_ms=frontend.frame_shift_ms,
                        frame_length_ms=frontend.frame_length_ms,
                    )
        self._buckets: Dict[int, _CompiledBucket] = {}
        self._has_ivector = self.spec is not None and any(
            n.kind == "input" and n.name == "ivector" for n in self.spec.nodes
        )
        self._gmm_fwd = None
        if self.gmm is not None:
            self._gmm_fwd = jax.jit(self.gmm.log_likes)

        # Online i-vector extractor (model_dir/extractor/: final.ie,
        # final.dubm, final.mat — export_voice2json_profile layout)
        self.ivector_params = None
        ext_dir = model_dir / "extractor"
        if self._has_ivector and (ext_dir / "final.ie").exists():
            from ..io.ivector import (
                DiagGmm,
                IvectorExtractor,
                OnlineIvectorConfig,
                parse_conf,
            )
            from ..io.kaldi_io import read_kaldi_object
            from ..ops.ivector import make_ivector_params

            dubm = DiagGmm.load(str(ext_dir / "final.dubm"))
            extractor = IvectorExtractor.load(str(ext_dir / "final.ie"))
            lda = read_kaldi_object(str(ext_dir / "final.mat"))
            conf_path = ext_dir / "ivector_extractor.conf"
            cfg = OnlineIvectorConfig()
            if conf_path.exists():
                cfg = OnlineIvectorConfig.from_conf(parse_conf(str(conf_path)))
            self.ivector_params = make_ivector_params(dubm, extractor, lda, cfg)
            # OnlineCmvn in the ivector branch (prepare_online_decoding.sh
            # writes global_cmvn.stats; MFCC -> cmvn -> splice -> LDA)
            self.ivector_cmvn_stats = None
            cmvn_path = ext_dir / "global_cmvn.stats"
            if cmvn_path.exists():
                self.ivector_cmvn_stats = np.asarray(
                    read_kaldi_object(str(cmvn_path))
                )

    @property
    def num_pdfs(self) -> int:
        return self.transition_model.num_pdfs

    def compiled(self, num_out_frames: int) -> _CompiledBucket:
        if self.spec is None:
            raise NotImplementedError(
                "GMM acoustic models have no nnet3 computation graph; "
                "batch decoding runs through log_probs directly and "
                "streaming through models.gmm.GmmChunkModel"
            )
        bucket = self._buckets.get(num_out_frames)
        if bucket is None:
            model = compile_nnet3(
                self.spec, num_out_frames, subsampling=self.subsampling
            )
            if self.compute_dtype in ("bfloat16", "bf16"):
                lp_model = model.cast(jnp.bfloat16)

                def fwd(feats, ivec=None, _m=lp_model):
                    feats = feats.astype(jnp.bfloat16)
                    if ivec is not None:
                        ivec = ivec.astype(jnp.bfloat16)
                        out = _m.forward(feats, ivec)
                    else:
                        out = _m.forward(feats)
                    return out.astype(jnp.float32)

                bucket = _CompiledBucket(model=model, fwd=jax.jit(fwd))
            else:
                bucket = _CompiledBucket(
                    model=model, fwd=jax.jit(model.forward)
                )
            self._buckets[num_out_frames] = bucket
        return bucket

    def features(self, pcm_batch: np.ndarray) -> jnp.ndarray:
        """[B, samples] -> [B, T, D] MFCCs.

        With cfg.dither > 0 (Kaldi's default is 1.0, feature-window.h:35-58;
        ours is 0.0 for bit-reproducible decodes) Gaussian dither is added
        with a fresh fold of the instance key per call."""
        pcm = jnp.asarray(pcm_batch)
        if self.frontend_config.dither > 0.0:
            self._dither_calls += 1
            dither_key = jax.random.fold_in(
                jax.random.PRNGKey(42), self._dither_calls
            )
            mfcc = mfcc_batch(self.frontend_params, pcm, dither_key=dither_key)
            if self.pitch_config is not None:
                mfcc = self._append_pitch(mfcc, pcm_batch)
            return mfcc
        return self.features_traceable(pcm)

    def features_traceable(self, pcm: jnp.ndarray) -> jnp.ndarray:
        """Pure dither-free frontend over [B, samples]; traces under
        jit/jax.export (the AOT store exports it)."""
        mfcc = mfcc_batch(self.frontend_params, pcm)
        if self.pitch_config is not None:
            mfcc = self._append_pitch(mfcc, pcm)
        return mfcc

    def _append_pitch(
        self, mfcc: jnp.ndarray, pcm_batch: np.ndarray
    ) -> jnp.ndarray:
        """Append 3-dim Kaldi pitch features, aligned to the MFCC frame
        count (the online pipeline repeats the last pitch frame when the
        4 kHz pitch stream yields fewer frames)."""
        from ..ops.pitch import pitch_batch

        pf = pitch_batch(self.pitch_config, jnp.asarray(pcm_batch))
        T = mfcc.shape[1]
        Tp = pf.shape[1]
        if Tp >= T:
            pf = pf[:, :T]
        else:
            pf = jnp.concatenate(
                [pf, jnp.repeat(pf[:, -1:], T - Tp, axis=1)], axis=1
            )
        return jnp.concatenate([mfcc, pf], axis=-1)

    def log_probs(
        self,
        feats: jnp.ndarray,
        num_out_frames: int,
        ivector_frame_weights: Optional[jnp.ndarray] = None,
        feat_lengths: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """[B, T, D] features -> [B, N, num_pdfs] pdf log-likelihood terms.

        Edge frames are replicated for context (Kaldi online-feature edge
        handling); chain outputs are used raw (acoustic_scale applied at
        decode), xent models subtract log-priors
        (nnet3/decodable-simple-looped.h:46-59 semantics).
        ivector_frame_weights [B, T] downweights frames in the i-vector
        stats (OnlineSilenceWeighting's effect; see
        Nnet3WavTranscriber silence_weight); feat_lengths [B] masks each
        stream's padding frames out of the i-vector stats (mixed-length
        batches)."""
        if self.gmm is not None:
            from ..ops.deltas import add_deltas

            T = feats.shape[1]
            full = add_deltas(feats, order=2)  # [B, T, 3D]
            idx = np.clip(
                np.arange(num_out_frames), 0, max(T - 1, 0)
            )
            return self._gmm_fwd(full[:, idx])
        bucket = self.compiled(num_out_frames)
        model = bucket.model
        T = feats.shape[1]
        lo, hi = model.ranges["input"]
        idx = np.clip(np.arange(lo, hi), 0, max(T - 1, 0))
        feats_in = feats[:, idx]
        ivec = None
        if self._has_ivector:
            if self.ivector_params is not None:
                from ..ops.ivector import extract_ivectors

                # the i-vector branch taps the BASE MFCC — pitch dims are
                # appended only on the nnet input side
                # (online-nnet2-feature-pipeline.cc:90-140 branch structure)
                iv_feats = feats
                if self.pitch_config is not None:
                    iv_feats = feats[..., : self.frontend_config.num_ceps]
                if getattr(self, "ivector_cmvn_stats", None) is not None:
                    from ..ops.cmvn import online_cmvn

                    iv_feats = online_cmvn(iv_feats, self.ivector_cmvn_stats)
                ivec = extract_ivectors(
                    iv_feats,
                    self.ivector_params,
                    lengths=feat_lengths,
                    frame_weights=ivector_frame_weights,
                )
            else:
                ivec = jnp.zeros(
                    (feats.shape[0], self.spec.ivector_dim), dtype=feats.dtype
                )
        out = bucket.fwd(feats_in, ivec) if ivec is not None else bucket.fwd(feats_in)
        if self.spec.priors is not None and self.spec.priors.shape[0]:
            out = out - jnp.log(jnp.asarray(self.spec.priors))[None, None, :]
        return out


# Backpointer-tensor byte budget before the dense decoder is abandoned:
# 3/16 of the device's memory, which leaves room for the AM posteriors and
# forward temporaries beside it (graphs small enough for uint16
# backpointers fit twice the streams in it). Devices that report no memory
# limit (the CPU backend) get the 16 GiB device's share.
DECODE_BUDGET_SHARE = 3 / 16
DEFAULT_DECODE_BUDGET = 3 << 30


def default_decode_budget(device=None) -> int:
    """Decode budget for ``device`` (default: the first JAX device):
    DECODE_BUDGET_SHARE of its ``memory_stats()["bytes_limit"]``, or
    DEFAULT_DECODE_BUDGET where the device reports no limit."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return DEFAULT_DECODE_BUDGET
    return int(limit * DECODE_BUDGET_SHARE)


def select_decoder(
    num_states: int,
    batch: int,
    frames: int,
    k: int,
    max_active: int,
    budget: int = DEFAULT_DECODE_BUDGET,
    segment: int = 32,
    out_degree: Optional[int] = None,
    num_arcs: Optional[int] = None,
    min_sub_batch: int = 1,
) -> Tuple[str, int]:
    """Pick the decode kernel from the backpointer footprint (bytes).

    Returns (mode, arg):

    - ("dense", sub_batch): exact and fastest; decode in sub-batches of
      that size so [T, sub_batch, S, k] backpointers fit the budget
      (sub_batch == batch when everything fits at once). 1-best graphs
      with <= 65533 arcs store uint16 backpointers (2 bytes/element), so
      pass ``num_arcs`` when known — it doubles the feasible sub-batch.
      For k > 1 the per-frame [B, num_arcs, k] candidate tensor of
      viterbi_kbest is charged against the budget too;
    - ("checkpointed", sub_batch): 1-best graphs whose [T, 1, S] tensor
      alone busts the budget — sqrt-rematerialized backtrace, still
      exact, boundary alphas + one segment resident, sub-batched too;
    - ("frontier", K): graphs too big for either — the top-K sparse
      frontier caps the active states per frame at ``max_active``, the
      LatticeFasterDecoderConfig role (lattice-faster-decoder.h:38-66),
      clamped so both the [T, B, K] trellis triple and the per-frame
      [B, K, out_degree] expansion fit the budget (a max_active the
      memory cannot honor is a beam, not a promise).

    ``min_sub_batch`` is the smallest sub-batch the caller can dispatch
    (one shard's worth of streams on a mesh); a mode is feasible only if
    that many streams fit the budget at once, so forced shard-multiple
    rounding can never exceed it.
    """
    from ..ops.decoder import _COMPACT_BP_MAX_ARC

    min_sub = max(1, min(min_sub_batch, batch))
    bp_bytes = (
        2
        if k == 1 and num_arcs is not None and num_arcs <= _COMPACT_BP_MAX_ARC
        else 4
    )
    per_stream_dense = frames * num_states * k * bp_bytes
    if k > 1 and num_arcs is not None:
        # viterbi_kbest's per-frame [B, A, k] f32 candidates live alongside
        # the backpointers; arc-heavy graphs can pass the bp test yet OOM
        # in the k-best kernel without this term.
        per_stream_dense += num_arcs * k * 4
    if per_stream_dense * min_sub <= budget:
        return "dense", max(min_sub, min(batch, budget // per_stream_dense))
    n_seg = -(-frames // segment)
    per_stream_ckpt = (n_seg + segment) * num_states * 4  # f32 alphas
    if k == 1 and per_stream_ckpt * min_sub <= budget:
        return "checkpointed", max(
            min_sub, min(batch, budget // per_stream_ckpt)
        )
    k_mem = budget // max(1, frames * batch * 3 * 4)
    if out_degree:
        k_mem = min(k_mem, budget // max(1, batch * out_degree * 4))
    return "frontier", max(1, min(max_active, num_states, k_mem))


class Nnet3WavTranscriber:
    """Reference-compatible WAV transcriber (transcribe_wav.py:15-33).

    Decode-kernel selection follows the backpointer footprint
    (:func:`select_decoder`): template-scale graphs use the exact dense
    decoder (every state active — the exact search subsumes any beam, so
    ``beam`` has no effect there); graphs too large for [T, B, S]
    backpointers fall back to sqrt-rematerialized backtraces, then to the
    top-K sparse frontier where ``max_active`` caps the active states per
    frame, ``beam`` prunes frontier slots costlier than best+beam, and
    ``min_active`` floors the survivors — the GetCutoff roles of
    LatticeFasterDecoderConfig (lattice-faster-decoder.h:38-66,
    .cc:644-712). ``lattice_beam`` prunes lattice generation
    (get_lattice)."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        graph_dir: Union[str, Path],
        tools: Optional[object] = None,  # unused; reference API parity
        max_active: int = 7000,
        lattice_beam: float = 8.0,
        acoustic_scale: float = 1.0,
        beam: float = 24.0,
        silence_weight: Optional[float] = None,
        decode_memory_budget: Optional[int] = None,
        compute_dtype: Optional[str] = None,
        min_active: int = 200,
        aot_dir: Optional[Union[str, Path]] = None,
    ):
        self.model_dir = Path(model_dir)
        self.graph_dir = Path(graph_dir)
        self.acoustic_scale = acoustic_scale
        self.max_active = max_active
        self.lattice_beam = lattice_beam
        self.beam = beam
        self.min_active = min_active
        # OnlineSilenceWeighting equivalent (online2/online-ivector-feature):
        # with a weight set and an i-vector extractor present, a first-pass
        # decode alignment downweights silence frames in the i-vector stats
        # and the batch is decoded again. None/1.0 = off (the reference's
        # default silence-weight is 1.0, a no-op, transcribe_wav.py config).
        self.silence_weight = silence_weight

        # None: a share of the device's memory (default_decode_budget)
        self.decode_memory_budget = (
            decode_memory_budget
            if decode_memory_budget is not None
            else default_decode_budget()
        )

        # Multi-chip serving (parallel.ShardedWavTranscriber): when set,
        # batch inputs are placed with this sharding and sub-batches are
        # rounded to shard multiples so XLA partitions every device program
        # over the stream mesh.
        self.input_sharding = None
        self._shard_count = 1

        self.am = AcousticModel(self.model_dir, compute_dtype=compute_dtype)
        self.artifacts = LangArtifacts.load(self.graph_dir)
        assert self.artifacts.graph is not None, f"no graph.npz in {graph_dir}"
        self.device_graph = make_decode_graph(self.artifacts.graph)
        self._frontier_graph = None  # built lazily for huge graphs
        self._out_degree: Optional[int] = None
        self._lang_cache: Dict[str, LangArtifacts] = {}
        self._silence_pdfs: Optional[frozenset] = None

        # AOT program store (utils/aot.py): serialized StableHLO for the
        # frontend/AM/decode programs at the serving shapes, so a fresh
        # process skips tracing+lowering (save_aot() writes them; the
        # default dir rides with the graph artifacts).
        from ..utils.aot import AotStore

        self._aot = AotStore(
            Path(aot_dir) if aot_dir is not None else self.graph_dir / "aot"
        )
        self._aot_export = False

    def _aot_call(self, name: str, fn, args, fallback=None):
        """Run ``fn(*args)`` through a serialized AOT program when one
        exists for these shapes (or export one during save_aot()).

        ``fn`` must be pure and traceable over ``args``; ``fallback``
        (defaults to ``fn``) runs when AOT is bypassed. Gated off under a
        stream mesh (exported programs pin shardings) and when the
        frontend dithers (the dither key folds a Python counter — not a
        pure function of the arrays)."""
        fallback = fallback or fn
        if (
            self._aot is None
            or self.input_sharding is not None
            or self.am.frontend_config.dither > 0.0
        ):
            return fallback(*args)
        loaded = self._aot.load(name, args)
        if loaded is not None:
            return loaded(*args)
        if self._aot_export:
            self._aot.save(name, fn, args)
            return self._aot.load(name, args)(*args)
        return fallback(*args)

    def save_aot(
        self, pcm_batch: List[np.ndarray], nbest: int = 1
    ) -> Path:
        """Export the serving programs (frontend, AM forward, decode) for
        THIS batch shape into the AOT store (default ``<graph_dir>/aot``).

        Run once at deploy time with a batch shaped like production
        traffic (same batch size and max utterance length); a later
        process then skips all tracing/lowering — time-to-first-transcript
        drops to artifact load + cached XLA compile. Kaldi analogue:
        binaries are AOT-compiled C++, a restart never recompiles."""
        self._aot_export = True
        try:
            self._decode_batch(pcm_batch, nbest)
        finally:
            self._aot_export = False
        return self._aot.dir

    def _get_silence_pdfs(self) -> frozenset:
        if self._silence_pdfs is None:
            from ..fst.core import SymbolTable
            from .endpoint import silence_pdfs_from_model

            pdfs = frozenset()
            phones_path = (
                self.am._resolved_model_dir / "model" / "phones.txt"
            )
            if phones_path.exists():
                with open(phones_path, "r", encoding="utf-8") as f:
                    model_phones = SymbolTable.read_text(f)
                pdfs = frozenset(
                    silence_pdfs_from_model(
                        self.am.transition_model, model_phones
                    )
                )
            self._silence_pdfs = pdfs
        return self._silence_pdfs

    def _silence_frame_weights(
        self, log_probs: jnp.ndarray, lengths: jnp.ndarray, num_in_frames: int
    ) -> Optional[jnp.ndarray]:
        """First-pass 1-best alignment -> [B, T_in] i-vector frame weights
        (silence frames get self.silence_weight, speech frames 1.0)."""
        sil_pdfs = self._get_silence_pdfs()
        if not sil_pdfs:
            return None
        trace, _fstate, _cost = viterbi_decode(
            self.device_graph,
            log_probs,
            acoustic_scale=self.acoustic_scale,
            lengths=lengths,
        )
        trace = np.asarray(trace)  # [B, T_out]; arc id, STAY, or -1
        graph = self.artifacts.graph
        B, T_out = trace.shape
        # forward-fill self-loop (STAY) frames with the last real arc
        filled = trace.copy()
        for t in range(1, T_out):
            m = filled[:, t] < 0
            filled[m, t] = filled[m, t - 1]
        pdf = np.where(filled >= 0, graph.arc_pdf[np.maximum(filled, 0)], -1)
        is_sil = np.isin(pdf, np.fromiter(sil_pdfs, dtype=np.int64))
        w_out = np.where(is_sil, float(self.silence_weight), 1.0)
        # upsample output-frame weights to the input frame rate
        sub = self.am.subsampling
        idx = np.minimum(np.arange(num_in_frames) // sub, T_out - 1)
        return jnp.asarray(w_out[:, idx].astype(np.float32))

    # -- helpers ------------------------------------------------------------

    def _lang(self, lang_dir: Optional[Union[str, Path]]) -> LangArtifacts:
        if lang_dir is None:
            return self.artifacts
        key = str(lang_dir)
        if key not in self._lang_cache:
            self._lang_cache[key] = LangArtifacts.load(lang_dir)
        return self._lang_cache[key]

    def _ids_to_text(self, word_ids: Sequence[int]) -> str:
        words = self.artifacts.words
        out = []
        for wid in word_ids:
            sym = words.find_id(wid)
            if sym is None or sym in ("<eps>", "#0", "<s>", "</s>"):
                continue
            out.append(sym)
        return " ".join(out)

    def _decode_batch(
        self,
        pcm_batch: List[np.ndarray],
        nbest: int,
    ) -> List[List[Tuple[List[int], float]]]:
        """Core batched decode: list of PCM arrays -> per-utterance n-best
        [(word ids, cost)], via one padded device program."""
        cfg = self.am.frontend_config
        sub = self.am.subsampling
        n_frames = [num_frames(cfg, p.shape[0]) for p in pcm_batch]
        # streams without a single full frame decode zero frames (masked)
        n_out = [-(-t // sub) for t in n_frames]
        max_out = max(max(n_out), 1)
        bucket_out = -(-max_out // _BUCKET) * _BUCKET

        max_samples = max(
            max(p.shape[0] for p in pcm_batch), cfg.frame_length
        )
        pcm = np.zeros((len(pcm_batch), max_samples), dtype=np.float32)
        for i, p in enumerate(pcm_batch):
            pcm[i, : p.shape[0]] = p
        if self.input_sharding is not None:
            pcm = jax.device_put(jnp.asarray(pcm), self.input_sharding)

        metrics = get_metrics()
        metrics.add_audio(
            sum(p.shape[0] for p in pcm_batch) / self.am.frontend_config.samp_freq,
            utterances=len(pcm_batch),
        )
        with StageTimer("frontend", metrics):
            feats = self._aot_call(
                "features",
                lambda p: self.am.features_traceable(jnp.asarray(p)),
                (pcm,),
                fallback=self.am.features,
            )
            feats.block_until_ready()
        feat_lengths = jnp.asarray(n_frames, dtype=jnp.int32)
        with StageTimer("acoustic", metrics):
            log_probs = self._aot_call(
                f"logprobs_b{bucket_out}",
                lambda f, l: self.am.log_probs(
                    f, bucket_out, feat_lengths=l
                ),
                (feats, feat_lengths),
            )
            log_probs.block_until_ready()
        k = max(nbest, 1)
        lengths = jnp.asarray(n_out, dtype=jnp.int32)
        if (
            self.silence_weight is not None
            and self.silence_weight != 1.0
            and self.am.ivector_params is not None
        ):
            # decoder-driven silence weighting: re-extract i-vectors with
            # first-pass silence frames downweighted, then decode again
            w = self._silence_frame_weights(log_probs, lengths, feats.shape[1])
            if w is not None:
                with StageTimer("acoustic", metrics):
                    log_probs = self.am.log_probs(
                        feats,
                        bucket_out,
                        ivector_frame_weights=w,
                        feat_lengths=feat_lengths,
                    )
                    log_probs.block_until_ready()
        graph = self.artifacts.graph
        mode, arg = select_decoder(
            graph.num_states,
            len(pcm_batch),
            bucket_out,
            k,
            self.max_active,
            self.decode_memory_budget,
            out_degree=self._graph_out_degree(),
            num_arcs=graph.num_arcs,
            min_sub_batch=self._shard_count,
        )
        if mode != "dense" or arg < len(pcm_batch):
            _LOGGER.debug(
                "decode plan %s(%d) for %d states x %d streams x %d frames "
                "(k=%d)",
                mode, arg, graph.num_states, len(pcm_batch), bucket_out, k,
            )
        if mode == "frontier":
            from ..ops.frontier import (
                FrontierGraph,
                topk_backtrace_nbest,
                viterbi_topk_cached,
            )

            if self._frontier_graph is None:
                self._frontier_graph = FrontierGraph.from_dense(graph)

            with StageTimer("decode", metrics):
                states_t, alphas_t, arcs_t = viterbi_topk_cached(
                    self._frontier_graph,
                    log_probs,
                    arg,
                    acoustic_scale=self.acoustic_scale,
                    lengths=lengths,
                    scratch_bytes=self.decode_memory_budget,
                    beam=self.beam,
                    min_active=self.min_active,
                )
                # one batched D2H for the triple
                states_t, alphas_t, arcs_t = jax.device_get(
                    (states_t, alphas_t, arcs_t)
                )
            with StageTimer("backtrace", metrics):
                return [
                    topk_backtrace_nbest(
                        graph, states_t, alphas_t, arcs_t, i, n=k
                    )
                    for i in range(len(pcm_batch))
                ]

        # Exact paths, in sub-batches of `arg` streams (the last sub-batch
        # is padded to keep one compiled shape; pad rows decode 0 frames).
        # Double-buffered: dispatch sub-batch i+1 (JAX dispatch is async)
        # BEFORE harvesting sub-batch i, so host word assembly overlaps the
        # next device execution — bounded at two in-flight programs, since
        # each one's backpointer tensor is sized to (most of) the decode
        # memory budget and an unbounded dispatch queue would stack them.
        out: List[List[Tuple[List[int], float]]] = []
        B = len(pcm_batch)
        sub = min(arg, B)
        if self._shard_count > 1:
            # sub-batch boundaries must align with shard boundaries, or the
            # log_probs slices force cross-device resharding gathers; round
            # DOWN so the budget-derived cap is respected (select_decoder's
            # min_sub_batch guarantees one shard's worth fits the budget,
            # so the max(n_sh, ...) floor cannot exceed it)
            n_sh = self._shard_count
            sub = min(B, max(n_sh, (sub // n_sh) * n_sh))
        lengths_np = np.asarray(lengths)

        def dispatch(start: int):
            stop = min(start + sub, B)
            pad = sub - (stop - start)
            lp = log_probs[start:stop]
            lens = lengths_np[start:stop]
            if pad:
                lp = jnp.concatenate(
                    [lp, jnp.zeros((pad,) + lp.shape[1:], lp.dtype)], axis=0
                )
                lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
            lens_dev = jnp.asarray(lens)

            if k != 1:
                res = self._aot_call(
                    f"decode_k{k}",
                    lambda lp_, l_: viterbi_kbest_decode(
                        self.device_graph,
                        lp_,
                        k=k,
                        acoustic_scale=self.acoustic_scale,
                        lengths=l_,
                    ),
                    (lp, lens_dev),
                )
            elif mode == "checkpointed":
                # sqrt-remat: no [T, B, S] backpointers resident (its
                # segment loop already blocks on host inside; not a single
                # device program, so no AOT form)
                res = viterbi_decode_checkpointed(
                    self.device_graph,
                    lp,
                    acoustic_scale=self.acoustic_scale,
                    lengths=lens_dev,
                )
            else:
                # 1-best fast path: on-device backtrace
                res = self._aot_call(
                    "decode1",
                    lambda lp_, l_: viterbi_decode(
                        self.device_graph,
                        lp_,
                        acoustic_scale=self.acoustic_scale,
                        lengths=l_,
                    ),
                    (lp, lens_dev),
                )
            return start, stop, res

        def harvest(entry) -> None:
            start, stop, res = entry
            if k == 1:
                with StageTimer("decode", metrics):
                    # one batched D2H (see the frontier branch note)
                    trace, fstate, cost = jax.device_get(res)
                with StageTimer("backtrace", metrics):
                    assembled = traces_to_words_batch(graph, trace, fstate, cost)
                    out.extend(
                        [] if words is None else [(words, c)]
                        for words, c in assembled[: stop - start]
                    )
            else:
                with StageTimer("decode", metrics):
                    traces, seed_states, seed_costs = jax.device_get(res)
                with StageTimer("backtrace", metrics):
                    out.extend(
                        kbest_traces_to_nbest(
                            graph, traces, seed_states, seed_costs, i, n=k
                        )
                        for i in range(stop - start)
                    )

        prev = None
        for start in range(0, B, sub):
            with StageTimer("decode", metrics):
                cur = dispatch(start)
            if prev is not None:
                harvest(prev)
            prev = cur
        if prev is not None:
            harvest(prev)
        return out

    def _graph_out_degree(self) -> int:
        """Max out-degree of the decode graph (frontier expansion width)."""
        if self._out_degree is None:
            g = self.artifacts.graph
            self._out_degree = int(
                np.bincount(g.arc_src, minlength=g.num_states).max()
            ) if g.num_arcs else 1
        return self._out_degree

    # -- public API ----------------------------------------------------------

    def transcribe(
        self,
        wav_path: Union[str, Path],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        """Synchronous core of async_transcribe (transcribe_wav.py:35-105)."""
        results = self.transcribe_batch(
            [wav_path],
            lang_dir=lang_dir,
            nbest=nbest,
            max_fuzzy_cost=max_fuzzy_cost,
            require_fuzzy=require_fuzzy,
        )
        return results[0]

    def transcribe_batch(
        self,
        wav_paths: Sequence[Union[str, Path]],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[List[str]]:
        pcm_batch = [read_wav(p) for p in wav_paths]
        return self.transcribe_pcm_batch(
            pcm_batch,
            lang_dir=lang_dir,
            nbest=nbest,
            max_fuzzy_cost=max_fuzzy_cost,
            require_fuzzy=require_fuzzy,
        )

    def transcribe_pcm_batch(
        self,
        pcm_batch: Sequence[np.ndarray],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[List[str]]:
        lang = self._lang(lang_dir)
        nbest_lists = self._decode_batch(list(pcm_batch), nbest)

        out: List[List[str]] = []
        # Streams in one batch often decode to identical n-best lists;
        # the host fuzzy compose is the expensive tail, so dedup per call.
        fuzzy_cache: Dict[tuple, Optional[Tuple[str, float]]] = {}
        for hyp_list in nbest_lists:
            texts: List[str] = []
            fuzzy_done = False
            if lang.g_fuzzy is not None and hyp_list:
                key = tuple(tuple(ids) for ids, _ in hyp_list)
                if key in fuzzy_cache:
                    fuzzy = fuzzy_cache[key]
                else:
                    fuzzy = get_fuzzy_text(
                        [ids for ids, _ in hyp_list], lang.g_fuzzy, lang.words
                    )
                    fuzzy_cache[key] = fuzzy
                if fuzzy is not None:
                    text, cost = fuzzy
                    _LOGGER.debug("Fuzzy: %r cost=%.3f", text, cost)
                    if max_fuzzy_cost is not None and cost <= max_fuzzy_cost:
                        texts = [decode_meta(text)]
                        fuzzy_done = True
            if not fuzzy_done:
                if require_fuzzy:
                    texts = []
                else:
                    texts = [
                        decode_meta(self._ids_to_text(ids)) for ids, _ in hyp_list
                    ]
            out.append(texts)
        return out

    def get_lattice(
        self,
        wav_path: Union[str, Path],
        lattice_beam: Optional[float] = None,
    ):
        """Pruned word lattice for one utterance (GetRawLattice +
        lattice-beam equivalent; see ops/lattice.py)."""
        from ..ops.lattice import build_lattice, forward_backward

        pcm = read_wav(wav_path)
        cfg = self.am.frontend_config
        T = num_frames(cfg, pcm.shape[0])
        n_out = max(1, -(-T // self.am.subsampling))
        feats = self.am.features(pcm[None])
        log_probs = self.am.log_probs(feats, n_out)
        alphas, betas = forward_backward(
            self.device_graph, log_probs, self.acoustic_scale
        )
        alphas, betas, log_probs = jax.device_get(
            (alphas, betas, log_probs)
        )
        return build_lattice(
            self.artifacts.graph,
            alphas,
            betas,
            log_probs,
            0,
            lattice_beam=(
                lattice_beam if lattice_beam is not None else self.lattice_beam
            ),
            acoustic_scale=self.acoustic_scale,
        )

    def get_compact_lattice(
        self,
        wav_path: Union[str, Path],
        lattice_beam: Optional[float] = None,
        determinize: bool = True,
    ):
        """Word-level Kaldi CompactLattice for one utterance — writable to
        lattice arks with io.lattice_io.write_lattice_ark for interchange
        with Kaldi's lattice-* tools (the ark format transcribe_wav.py pipes
        between binaries).

        ``determinize`` (the default, matching GetLattice's
        DeterminizeLatticePhonePrunedWrapper, online-nnet3-decoding.cc:66-77)
        produces the canonical form Kaldi tools expect: epsilon-free, one
        path per word sequence at its best cost."""
        from ..io.lattice_io import (
            compact_lattice_from_decode,
            determinize_lattice_phone_pruned,
        )

        lat = self.get_lattice(wav_path, lattice_beam=lattice_beam)
        if lat is None:
            return None
        clat = compact_lattice_from_decode(lat, self.artifacts.graph)
        if determinize:
            try:
                # phone-then-word two-pass; decode exports carry no
                # transition-id strings, so the phone pass degenerates
                # and this equals word-level determinization — but
                # lattices READ from Kaldi arks (read_lattice) carry
                # real tid strings and take the full two-pass path
                clat = determinize_lattice_phone_pruned(
                    clat, self.am.transition_model
                )
            except ValueError as exc:
                # Kaldi's DeterminizeLatticePhonePrunedWrapper likewise
                # degrades to the input lattice when determinization blows
                # up (determinize-lattice-pruned.cc wrapper) rather than
                # failing the utterance.
                _LOGGER.warning(
                    "lattice determinization gave up (%s); exporting the "
                    "undeterminized lattice",
                    exc,
                )
        return clat

    def confidence_pcm(self, pcm: np.ndarray, n: int = 8) -> float:
        """Posterior of the 1-best transcript over the lattice's n-best
        DISTINCT hypotheses, in [0, 1].

        exp(-c1) / sum_i exp(-ci) over deduplicated word sequences from a
        pruned lattice — near 1.0 when the winner dominates, lower when
        rivals are close (ambiguous or OOV audio). The lattice is the right
        source of rivals: raw k-best paths are crowded out by
        epsilon-closure duplicate state paths carrying the same words (see
        ops/lattice.arc_posteriors for frame-level occupancies).
        Complements the fuzzy-match cost the reference exposes
        (transcribe_wav.py:75-105) with a decoder-native score."""
        from ..ops.lattice import build_lattice, forward_backward

        cfg = self.am.frontend_config
        T = num_frames(cfg, pcm.shape[0])
        n_out = max(1, -(-T // self.am.subsampling))
        feats = self.am.features(pcm[None])
        log_probs = self.am.log_probs(feats, n_out)
        alphas, betas = forward_backward(
            self.device_graph, log_probs, self.acoustic_scale
        )
        alphas, betas, log_probs = jax.device_get(
            (alphas, betas, log_probs)
        )
        lat = build_lattice(
            self.artifacts.graph,
            alphas,
            betas,
            log_probs,
            0,
            lattice_beam=self.lattice_beam,
            acoustic_scale=self.acoustic_scale,
        )
        if lat is None:
            return 0.0
        hyps = lat.nbest(self.artifacts.graph, n, dedup=True)
        if not hyps:
            return 0.0
        costs = np.asarray([c for _, c in hyps], dtype=np.float64)
        w = np.exp(-(costs - costs.min()))
        return float(w[0] / w.sum())

    def confidence(self, wav_path: Union[str, Path], n: int = 8) -> float:
        return self.confidence_pcm(read_wav(wav_path), n=n)

    def transcribe_rescore(
        self,
        wav_path: Union[str, Path],
        old_lang_dir: Union[str, Path],
        new_lang_dir: Union[str, Path],
        nbest: int = 5,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        """Dual-graph rescore (transcribe_wav.py:107-202): decode with this
        transcriber's graph (e.g. lang_arpa), remap the pruned decode
        LATTICE through the new lang dir's lexicon and LM (phone lattice →
        Ldet → phi-composed G → transition probs → n-best), then run the
        fuzzy tail against old_lang_dir's G.fuzzy like the reference
        (:205-231). Falls back to an n-best-list LM swap — which cannot
        recover hypotheses outside the first pass — only when the artifacts
        predate lattice metadata (logged loudly)."""
        from .rescore import rescore_lattice

        old_lang = self._lang(old_lang_dir)
        new_lang = self._lang(new_lang_dir)
        assert new_lang.g_fst is not None

        graph = self.artifacts.graph
        lattice_capable = (
            graph is not None
            and graph.has_phone_info
            and new_lang.ldet is not None
        )
        if lattice_capable:
            lat = self.get_lattice(wav_path)
            hyp_list = (
                rescore_lattice(
                    lat, graph, self.artifacts.phones, new_lang, nbest=nbest
                )
                if lat is not None
                else []
            )
        else:
            _LOGGER.warning(
                "Artifacts lack lattice rescore metadata (phone tags or "
                "ldet.fst) — falling back to an n-best LM swap, which cannot "
                "recover hypotheses outside the first pass. Retrain to fix."
            )
            assert old_lang.g_fst is not None
            pcm = read_wav(wav_path)
            hyp_list = rescore_nbest(
                self._decode_batch([pcm], nbest)[0],
                old_lang.g_fst,
                new_lang.g_fst,
                self.artifacts.words,
            )

        # Fuzzy tail against the OLD lang's G.fuzzy (transcribe_wav.py:215-223)
        from .rescore import rescore_tail

        return rescore_tail(
            hyp_list, old_lang, new_lang, max_fuzzy_cost, require_fuzzy
        )

    # -- async wrappers (reference API) ---------------------------------------

    async def async_transcribe(
        self,
        wav_path: Union[str, Path],
        lang_dir: Optional[Union[str, Path]] = None,
        nbest: int = 1,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        return await asyncio.to_thread(
            lambda: self.transcribe(
                wav_path,
                lang_dir=lang_dir,
                nbest=nbest,
                max_fuzzy_cost=max_fuzzy_cost,
                require_fuzzy=require_fuzzy,
            ),
        )

    async def async_transcribe_rescore(
        self,
        wav_path: Union[str, Path],
        old_lang_dir: Union[str, Path],
        new_lang_dir: Union[str, Path],
        nbest: int = 5,
        max_fuzzy_cost: Optional[float] = None,
        require_fuzzy: bool = False,
    ) -> List[str]:
        return await asyncio.to_thread(
            lambda: self.transcribe_rescore(
                wav_path,
                old_lang_dir,
                new_lang_dir,
                nbest=nbest,
                max_fuzzy_cost=max_fuzzy_cost,
                require_fuzzy=require_fuzzy,
            ),
        )
