"""Batched streaming scheduler: many concurrent PCM streams, one device
program.

The throughput-serving design (SURVEY §7.9, BASELINE north star >=100
streams/chip): a fixed pool of stream slots backed by the native ring
buffers (native/runtime.py StreamPool). Every ``step()`` runs ONE jitted
chunk program over the whole slot batch [max_streams, ...]; slots without a
ready chunk run masked (n_valid=0), so the compiled shape never changes and
admission/retirement of utterances costs nothing on device.

Per chunk each active slot advances 21 input frames -> 7 subsampled Viterbi
frames (decodable-simple-looped.h:46-59 chunking), with per-slot device
alpha rows carried between steps.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..grammar.fst import decode_meta
from ..models.nnet3 import compile_nnet3
from ..native import StreamPool
from ..ops.decoder import backtrace_words, decode_step, make_decode_graph
from ..ops.frontend import mfcc_batch
from ..utils.metrics import StageTimer, get_metrics
from .artifacts import LangArtifacts
from .fuzzy import get_fuzzy_text
from .streaming_features import StreamFeaturizer, online_cmvn_numpy
from .transcribe import AcousticModel

_LOGGER = logging.getLogger(__name__)

CHUNK_OUT_FRAMES = 7


# Per-lane per-tick drain cap FLOOR (samples). The effective per-
# scheduler cap is max(this, 2x the chunk's audio) — larger decode
# chunks (chunk_out_frames=14/21 at high lane counts) need a
# proportionally larger catch-up budget so burst-fed lanes still drain
# at ~2x real-time consumption. The cap bounds BOTH the fused program's
# compile variants and the padded MFCC scratch-row block each feed
# writes past a lane's valid rows (the feature-ring slack is sized from
# it, see _feat_ring_frames). Leftover pool audio simply drains on
# later ticks.
_DRAIN_CAP = 12800


def _pcm_bucket(n: int, cap: int = _DRAIN_CAP) -> int:
    """Padded PCM width for the fused tick program: 800-sample (0.05 s)
    granularity with a 1600-sample floor, capped at the scheduler's
    drain cap. The PCM batch is an input of the WHOLE fused program
    (MFCC + AM + decode), so each distinct width is a full XLA compile —
    the granularity bounds the variants to cap/800 (<= 26 at the largest
    caps; steady-state serving hits exactly one), while keeping the
    upload padding under ~10% (the old pow2 buckets padded the serving
    tick's steady width 74%: 3680 -> 6400 at chunk_out=7 — and the
    per-tick H2D PCM batch is the largest transfer of the serving loop
    on a remote-dispatch transport)."""
    n = min(n, cap)
    return max(1600, -(-n // 800) * 800)


class _FetchPool:
    """Small persistent pool of daemon fetch workers.

    A steady-state serving tick issues up to three D2H copies (tick bps,
    ep stats, finalize packed); spawning a fresh thread per transfer adds
    creation overhead and unbounded thread churn at high tick rates or
    under device stalls. The workers are daemon threads on purpose: a
    wedged transport RPC at interpreter exit must not hang the process
    (an Executor's non-daemon workers would)."""

    def __init__(self, workers: int = 4):
        import queue

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        for _ in range(workers):
            threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        while True:
            dev, box, ev = self._q.get()
            try:
                box[0] = np.asarray(dev)
            except BaseException as exc:  # pragma: no cover - device failure
                box[1] = exc
            ev.set()

    def submit(self, dev):
        box: list = [None, None]  # [value, exception]
        ev = threading.Event()
        self._q.put((dev, box, ev))
        return box, ev


_FETCH_POOL: Optional[_FetchPool] = None


def _fetch_pool() -> _FetchPool:
    global _FETCH_POOL
    if _FETCH_POOL is None:
        _FETCH_POOL = _FetchPool()
    return _FETCH_POOL


class _AsyncFetch:
    """Device→host copy running on the persistent fetch pool.

    A plain ``np.asarray`` on a worker thread releases the GIL while it
    waits, so the tick loop never blocks and the data lands as soon as
    the device drains. It stands in for ``copy_to_host_async()`` +
    ``is_ready()`` polling, which stalled on a remote-dispatch transport;
    whether polling serves a local GPU better is not measured yet. On
    backends where ``is_ready()`` never flips without an explicit read
    (the virtual CPU mesh), the worker IS the read — results land
    without the tick loop ever forcing one.
    """

    __slots__ = ("_box", "_event")

    def __init__(self, dev):
        self._box, self._event = _fetch_pool().submit(dev)

    def ready(self) -> bool:
        return self._event.is_set()

    def get(self, block: bool = True) -> Optional[np.ndarray]:
        """The landed array; None when still in flight and not blocking.
        A fetch-worker exception re-raises here (device errors must not
        vanish into the background)."""
        if block:
            self._event.wait()
        elif not self._event.is_set():
            return None
        if self._box[1] is not None:
            raise self._box[1]
        return self._box[0]


# stat columns appended to the packed tick output after the [N, F] arc
# trace: [final_state, has_final, trail, nonsil, cost_lo, cost_hi,
# rel_lo, rel_hi] (f32 values as exact u16 bit halves)
_PACKED_STAT_COLS = 8


def _packed_f32(p: np.ndarray, lo_col: int) -> np.ndarray:
    """Reassemble an exact f32 column from two u16 bit-half columns."""
    bits = p[:, lo_col].astype(np.uint32) | (
        p[:, lo_col + 1].astype(np.uint32) << 16
    )
    return np.ascontiguousarray(bits).view(np.float32)


class _PackedStatsFetch:
    """Endpoint-stats view over the tick's packed u16 fetch: ``get()``
    decodes the stat columns into the [N, 3] rows the endpoint rules
    consume (trailing-silence frames, contains-nonsilence, exact f32
    relative final cost). Shares the single per-tick D2H with the
    finalize harvest instead of paying its own transport RPC."""

    __slots__ = ("_fetch",)

    def __init__(self, fetch: "_AsyncFetch"):
        self._fetch = fetch

    def ready(self) -> bool:
        return self._fetch.ready()

    def get(self, block: bool = True) -> Optional[np.ndarray]:
        p = self._fetch.get(block)
        if p is None:
            return None
        F = p.shape[1] - _PACKED_STAT_COLS
        out = np.empty((p.shape[0], 3), np.float32)
        out[:, 0] = p[:, F + 2]
        out[:, 1] = p[:, F + 3]
        out[:, 2] = _packed_f32(p, F + 6)
        return out


class _TickBps:
    """A device tensor transferred to host in the background (bps or
    alpha) via ``_AsyncFetch``; ``force()`` materializes the numpy array
    (a no-op wait when the background copy already landed) and drops the
    device reference. With endpointing/silence-weighting off, nothing
    forces the per-tick [chunk, N, S] backpointers until a stream
    finalizes — steady-state ticks never block on the largest transfer
    of the serving path, and finalizes read the tick-end alpha from one
    shared background copy instead of a per-lane device slice dispatch.

    ``encoded`` marks uint16 ``bp + 3`` packing (0 = inactive lane frame,
    1 = STAY, 2 = dead; arc ids ≤ 65532): half the transfer bytes of the
    int32 form whenever the graph fits.
    """

    __slots__ = ("_fetch", "_np", "encoded")

    def __init__(self, dev, encoded: bool = False):
        self._fetch = _AsyncFetch(dev)
        self._np = None
        self.encoded = encoded

    def force(self) -> np.ndarray:
        if self._np is None:
            arr = self._fetch.get()
            if self.encoded:
                arr = arr.astype(np.int32) - 3
            self._np = arr
            self._fetch = None
        return self._np


@dataclass
class _SlotState:
    active: bool = False
    feats: Optional[np.ndarray] = None
    feat_state: object = None  # StreamFeatState
    frames_consumed: int = 0
    out_frames: int = 0
    # Each entry is either a materialized per-lane [k, S] np array (ticks
    # older than the tick ring — holding whole [chunk, N, S] tensors per
    # slot would pin up to N times the round-2 host footprint on long
    # streams) or a live (_TickBps, k) pair for the last few ticks whose
    # async D2H copy may still be in flight.
    bps: List[Union[np.ndarray, Tuple[_TickBps, int]]] = field(
        default_factory=list
    )
    done: bool = False
    result: Optional[List[str]] = None
    # set when the stream was force-finalized by a ring-capacity
    # quarantine; result still carries the partial transcript
    error: Optional[str] = None
    flushed_feats: bool = False
    iv_pending_win: Optional[np.ndarray] = None
    iv_pending_w: Optional[np.ndarray] = None
    # bumped on open AND close: in-flight async finalizes for a previous
    # incarnation are routed to the retired-results store (see
    # StreamScheduler.close / take_result), never into the wrong stream
    gen: int = 0

    def bp_chunks(self, sid: int) -> List[np.ndarray]:
        """Materialized per-chunk [k, S] backpointers for this stream."""
        return [
            e if isinstance(e, np.ndarray) else e[0].force()[: e[1], sid]
            for e in self.bps
        ]


class StreamScheduler:
    """Admit/feed/step/poll interface over a fixed stream batch."""

    def __init__(
        self,
        model_dir: Union[str, Path],
        graph_dir: Union[str, Path],
        max_streams: int = 32,
        acoustic_scale: float = 1.0,
        max_fuzzy_cost: Optional[float] = None,
        lang_dir: Optional[Union[str, Path]] = None,
        pool_capacity_samples: int = 16000 * 60,
        endpointing: Optional["EndpointConfig"] = None,
        silence_weight: Optional[float] = None,
        mesh=None,
        chunk_out_frames: int = CHUNK_OUT_FRAMES,
        compute_dtype: Optional[str] = None,
        wire: str = "i16",
    ):
        # Larger chunks amortize the TDNN context-overlap recompute (the
        # AM re-evaluates ~±30 context frames per chunk) at the cost of
        # per-chunk latency: 7 out-frames = 0.21 s (the reference's
        # decodable chunking, decodable-simple-looped.h:46-59); 14 or 21
        # roughly halves/thirds the overlap share.
        self._chunk_out = int(chunk_out_frames)
        self.am = AcousticModel(Path(model_dir), compute_dtype=compute_dtype)
        self.artifacts = LangArtifacts.load(graph_dir)
        assert self.artifacts.graph is not None
        self.graph = self.artifacts.graph
        self.device_graph = make_decode_graph(self.graph)
        self.max_streams = max_streams
        self.acoustic_scale = acoustic_scale
        self.max_fuzzy_cost = max_fuzzy_cost
        self.silence_weight = silence_weight
        self.fuzzy_lang = (
            LangArtifacts.load(lang_dir) if lang_dir is not None else self.artifacts
        )

        self.pool = StreamPool(max_streams, pool_capacity_samples)
        self.slots: List[_SlotState] = [_SlotState() for _ in range(max_streams)]
        self._featurizer = StreamFeaturizer(self.am)

        if self.am.spec is None:
            # GMM chunk model: deltas + delta-deltas over the window,
            # per-pdf log-likelihoods — identical math to the batch GMM
            # path, chunked (the reference's own GMM streaming is dead
            # code, transcribe_wav.py:238-484)
            from ..models.gmm import GmmChunkModel

            self._chunk_model = GmmChunkModel(self.am.gmm, self._chunk_out)
        else:
            self._chunk_model = compile_nnet3(
                self.am.spec, self._chunk_out, subsampling=self.am.subsampling
            )
        self._recurrent = self._chunk_model.recurrent
        # bf16 operating point: cast the chunk AM (bf16 matmuls, f32
        # accumulation); decode costs stay f32. Recurrent models keep
        # f32 (the carried state dtype is part of the compiled contract).
        self._bf16 = (
            self.am.compute_dtype in ("bfloat16", "bf16")
            and not self._recurrent
        )
        self._fwd_model = (
            self._chunk_model.cast(jnp.bfloat16)
            if self._bf16
            else self._chunk_model
        )
        lo, hi = self._chunk_model.ranges["input"]
        self._win_lo, self._win_hi = lo, hi
        self._chunk_in = self._chunk_out * self.am.subsampling
        # Effective drain cap: at least 2x one chunk of audio (catch-up
        # stays ~2x real-time consumption at any chunk_out_frames),
        # rounded to the bucket granularity's 1600 floor.
        #
        # Measured dead end (round 5, keep it dead): capping the drain at
        # the admission window (chunk + right context) to shrink the
        # fleet upload's padded width made PARTIAL drains routine, and a
        # partially-drained lane's leftover + next feed lands on an
        # arbitrary 800-bucket — the steady loop wandered across many
        # PCM widths, each a full XLA compile (tick 1,708 ms at 512
        # lanes, stream_chunk 1,289 ms of mid-measurement recompiles,
        # vs 350 ms before). The 2x cap is what guarantees every lane
        # drains FULLY every tick, so steady serving (with admissions)
        # hits exactly ONE width. The upload-byte lever that actually
        # works is the wire format (see wire="mulaw"), not the bucket.
        _chunk_samples = self._chunk_in * self.am.frontend_config.frame_shift
        self._drain_cap = max(
            _DRAIN_CAP, -(-2 * _chunk_samples // 1600) * 1600
        )

        graph = self.device_graph
        scale = acoustic_scale

        recurrent = self._recurrent
        self._has_ivector = self.am._has_ivector
        ivp = self.am.ivector_params if self._has_ivector else None
        self._ivp = ivp
        chunk_in = self._chunk_in
        chunk_out = self._chunk_out
        has_ivector = self._has_ivector
        win_lo = self._win_lo
        win_hi = self._win_hi
        num_ceps = self.am.frontend_config.num_ceps

        # uint16 bp/trace packing (bp + 3: 0 = inactive, 1 = STAY,
        # 2 = dead) halves the largest per-tick transfers whenever the
        # graph fits; the packed tick output also carries each lane's
        # final STATE id in u16, so both id spaces must fit (any trim
        # graph with <= 65532 arcs has <= 65533 states, so the state
        # bound only excludes degenerate non-trim graphs)
        self._bp_compact = (
            self.graph.num_arcs <= 65532
            and self.graph.num_states <= 65535
        )
        init_row = jnp.asarray(self.graph.init_weight)
        bp_compact = self._bp_compact

        # Inline i-vector windows: the staged [t0-sl, t0+chunk+sr) base-MFCC
        # window is a STATIC SLICE of the AM window whenever the nnet input
        # range covers it (TDNN context >= the splice context) — so the
        # previous tick's window is carried ON DEVICE and the per-lane host
        # staging plus its H2D upload disappear. Weights still come from
        # the host (they encode per-lane valid-frame counts; [N, chunk] —
        # bytes). Pitch models qualify too: the tap slices the window's
        # first num_ceps columns, and Kaldi's i-vector tap reads the BASE
        # MFCC, never the appended pitch columns
        # (online2/online-nnet2-feature-pipeline.cc:90-140).
        iv_inline_geom = (
            ivp is not None
            and self._win_lo <= -ivp.splice_left
            and self._win_hi >= self._chunk_in + ivp.splice_right
        )
        # Device-resident online CMVN for the i-vector tap: real Kaldi
        # online i-vector configs normalize the tap features
        # (ivector_extractor.conf --cmvn-config), which previously forced
        # the host staging path. A cumulative-sum ring alongside the
        # feature ring yields each row's sliding-window mean (600 frames,
        # global-stats deficit fill) with two gathers per window row, so
        # CMVN'd models ride the fused tick too.
        _iv_cmvn_stats = getattr(self.am, "ivector_cmvn_stats", None)
        self._iv_cmvn_device = (
            iv_inline_geom
            and _iv_cmvn_stats is not None
            and self._bp_compact
        )
        _cmvn_ok = _iv_cmvn_stats is None or self._iv_cmvn_device
        # Device-resident silence weighting: the chunk's best path is
        # backtraced ON DEVICE right after the decode scan (7 point
        # gathers), silence frames map to next-tick fold weights carried
        # on device — so OnlineSilenceWeighting no longer forces the host
        # backpointer path either.
        self._sw_device = (
            silence_weight is not None
            and silence_weight != 1.0
            and iv_inline_geom
            and _cmvn_ok
            and self._bp_compact
        )
        self._iv_inline = (
            iv_inline_geom
            and _cmvn_ok
            and (silence_weight in (None, 1.0) or self._sw_device)
        )

        # Endpointing (online-endpoint.h rules over decode-state signals),
        # resolved BEFORE the device programs are built: on compact-bp
        # graphs the endpoint signals are maintained ON DEVICE (see
        # _ep_device below), so endpointing no longer forces the host
        # backpointer path.
        self.endpointing = endpointing
        self._silence_pdfs = set()
        if endpointing is not None or silence_weight is not None:
            from ..fst.core import SymbolTable
            from .endpoint import silence_pdfs_from_model

            phones_path = self.am._resolved_model_dir / "model" / "phones.txt"
            if phones_path.exists():
                with open(phones_path, "r", encoding="utf-8") as f:
                    model_phones = SymbolTable.read_text(f)
                self._silence_pdfs = silence_pdfs_from_model(
                    self.am.transition_model, model_phones
                )

        # Device-resident endpoint signals: at tick end the program
        # backtraces the best path through the device bp ring — trail =
        # consecutive trailing silence frames of that path, nonsil =
        # the path saw a non-silence frame (whole-path, uncapped —
        # Kaldi's TrailingSilenceLength semantics, online-endpoint.h).
        # One [N, 3] stats row (trail, nonsil, relative final cost at
        # the tick-end best state) leaves the chip per tick; the rules
        # run on host against the PREVIOUS tick's landed stats, so
        # endpoint detection lags one chunk (0.21 s) and never blocks
        # the tick. (The old host path walked per-lane backpointers and
        # capped at 400 frames; an earlier per-(lane, state) in-scan DP
        # was exact too but cost [N, A]-sized work every decode frame —
        # 220 ms/tick at 512 lanes, ~6x the decode scan itself.)
        self._ep_device = (
            endpointing is not None
            and (silence_weight in (None, 1.0) or self._sw_device)
            and self._bp_compact
        )

        # Device-resident backpointer ring: when no host consumer needs
        # per-tick backpointers (endpointing rides the device DP above;
        # silence weighting still walks on host), each lane's bps
        # accumulate in a [N, F, S] uint16 ring ON DEVICE and the finalize
        # backtrace runs on device too — steady-state ticks transfer
        # kilobytes instead of the [chunk, N, S] tensor (the dominant cost
        # over any remote-dispatch transport, and a big PCIe saving
        # locally). F is sized from the pool capacity: the pool bounds a
        # stream's un-consumed audio, so offsets stay in range.
        # silence_weight=1.0 is Kaldi's documented no-op value: it stays
        # on the fast path with no weighting applied (the host path also
        # skips the factor at 1.0) — and _iv_cmvn_device relies on this
        # (its ring reads are only valid on the device-feats path)
        self._device_bp = (
            (endpointing is None or self._ep_device)
            and (silence_weight in (None, 1.0) or self._sw_device)
            and self._bp_compact
        )
        self._ring_frames = (
            -(-pool_capacity_samples // (160 * self.am.subsampling))
            + self._chunk_out
            + 32
        )

        # Device-resident features: MFCC rows land in a [N, FT, D] ring on
        # device (written by the drain program) and the AM window gathers
        # from it INSIDE the chunk program — the per-tick feature D2H +
        # window H2D round trip disappears along with the per-lane host
        # window assembly. Pitch models ride the fused tick too (see
        # _pitch_device below); non-inline i-vector taps fall back.
        self._device_feats = (
            self._device_bp
            and self._featurizer.snip  # snip=false rides the host
            # featurizer (virtual-signal edge reflections are per-stream
            # host logic); an unused edge for the published model family
            and (ivp is None or self._iv_inline)
        )
        # Device-resident pitch: the fused tick keeps a per-lane PCM ring
        # (leading pitch-window zero pad, so window slices never index
        # negative), recomputes the sliding pitch window on device
        # (ops/pitch.pitch_batch inline — exactly the host streaming
        # featurizer's window semantics, streaming_features.py:216-268)
        # and block-writes the NEW pitch rows into the feature ring's 3
        # trailing columns; lane readiness gates on the pitch-matched
        # count. Reference: kaldi/src/feat/pitch-functions.cc (online
        # recompute with lookahead) + online2/online-nnet2-feature-
        # pipeline.cc:90-140 (pitch appended to MFCC, i-vector taps the
        # base MFCC only).
        self._pitch_device = False
        if self._device_feats and self._featurizer.has_pitch:
            from ..ops.pitch import num_pitch_frames

            _pw = self._featurizer.pitch_window
            _tw = num_pitch_frames(self.am.pitch_config, _pw)
            # one drain must never advance the window past the rows a
            # single block write can cover (the host path's by-order
            # pairing has the same cap implicitly via the drain cap)
            if _tw >= 2 and self._drain_cap <= (_tw - 1) * 160:
                self._pitch_device = True
                self._pitch_win_samples = _pw
                self._pitch_t_w = _tw
            else:  # pragma: no cover - config far off the published family
                _LOGGER.warning(
                    "pitch window too short for the drain cap "
                    "(t_w=%d, cap=%d); pitch rides the host feature path",
                    _tw,
                    self._drain_cap,
                )
                self._device_feats = False
        # slack past the valid rows covers the largest bucket's padded
        # scratch-row block (reads clamp to the valid count; the
        # ring-overflow guard must never fire on burst-fed lanes)
        cfg0 = self.am.frontend_config
        _scratch_rows = 1 + max(
            0, (self._drain_cap - cfg0.frame_length) // cfg0.frame_shift
        )
        self._feat_ring_frames = (
            pool_capacity_samples // 160
            + self._win_hi
            + max(160, _scratch_rows + 32)
        )

        # silence table for the device endpoint DP / silence weighting:
        # arc id -> emits silence
        if self._ep_device or self._sw_device:
            sil_tab = np.zeros(max(self.graph.num_pdfs, 1), dtype=bool)
            for p in self._silence_pdfs:
                if 0 <= p < sil_tab.shape[0]:
                    sil_tab[p] = True
            arc_sil_dev = jnp.asarray(sil_tab[self.graph.arc_pdf])
        else:
            arc_sil_dev = None
        ep_device = self._ep_device
        sw_device = self._sw_device
        sw_factor = float(silence_weight) if self._sw_device else 1.0
        subsampling = self.am.subsampling

        # device CMVN constants for the i-vector tap (ops/cmvn semantics:
        # 600-frame sliding window, global-stats deficit fill capped at
        # 200 frames, mean-only)
        iv_cmvn_device = self._iv_cmvn_device
        if iv_cmvn_device:
            from ..ops.cmvn import CmvnConfig, stats_from_matrix

            _cmvn_cfg = CmvnConfig()
            _g_sum, _g_sumsq, _g_count = stats_from_matrix(_iv_cmvn_stats)
            cmvn_g_sum = jnp.asarray(_g_sum, jnp.float32)
            cmvn_g_count = float(_g_count)
            cmvn_g_cap = (
                float(min(_g_count, _cmvn_cfg.global_frames))
                if _g_count > 0
                else 0.0
            )
            cmvn_window = _cmvn_cfg.cmn_window
        else:
            cmvn_g_sum = None

        def batch_chunk(
            alpha, windows, n_valid, reset, gamma, X, iv_wins, iv_ws,
            am_state, ring, offs, feats_ring, t0s, haves, sw_w,
            cum_ring
        ):
            """alpha [N, S]; windows [N, W, D]; n_valid [N]; reset [N] bool
            (lanes reopened since the last tick restart from the initial
            alpha / zero stats — folding the reset in here replaces one
            device dispatch per admission); i-vector stats gamma [N, I] /
            X [N, I, D] with the previous tick's pending contribution
            (iv_wins [N, Wiv, Dc], iv_ws [N, chunk_in]) ->
            (alpha' [N, S], bp [7, N, S] (uint16-packed when the graph
            fits; None in device-ring mode), gamma', X', am_state',
            ring', offs'). Lanes without work (n_valid == 0) keep alpha,
            recurrence state, and — via zero iv_ws rows — their i-vector
            stats. In device-ring mode the chunk's backpointers are
            written into ``ring`` [N, F, S] at each lane's frame offset
            (donated: updated in place) and never leave the device."""
            if device_feats:
                # assemble AM windows from the device feature ring (same
                # edge-clamped indexing as the host path)
                W = win_hi - win_lo
                idx = jnp.clip(
                    t0s[:, None] + win_lo + jnp.arange(W)[None, :],
                    0,
                    jnp.maximum(haves - 1, 0)[:, None],
                )  # [N, W]
                windows = jnp.take_along_axis(
                    feats_ring, idx[:, :, None], axis=1
                )
            alpha = jnp.where(reset[:, None], init_row[None, :], alpha)
            offs = jnp.where(reset, 0, offs)
            gamma = jnp.where(
                reset.reshape((-1,) + (1,) * (gamma.ndim - 1)), 0.0, gamma
            )
            X = jnp.where(
                reset.reshape((-1,) + (1,) * (X.ndim - 1)), 0.0, X
            )
            am_state = {
                k: jnp.where(
                    reset.reshape((-1,) + (1,) * (v.ndim - 1)), 0.0, v
                )
                for k, v in am_state.items()
            }
            from ..ops.ivector import (
                apply_lda,
                gmm_log_likes,
                gselect_posteriors,
                solve_ivector,
                splice_frames,
            )

            ivec = None
            new_gamma, new_X = gamma, X
            new_iv_carry = iv_wins
            if sw_device:
                # fold weights staged from the previous tick's on-device
                # silence backtrace (1.0 / silence_weight per input frame)
                iv_ws = iv_ws * sw_w
            if has_ivector:
                if ivp is not None:
                    sl, sr = ivp.splice_left, ivp.splice_right
                    spliced = splice_frames(iv_wins, sl, sr)[
                        :, sl : sl + chunk_in
                    ]
                    lda_feats = apply_lda(spliced, ivp)
                    post = gselect_posteriors(
                        gmm_log_likes(lda_feats, ivp), ivp
                    ) * iv_ws[:, :, None]
                    new_gamma = gamma + jnp.sum(post, axis=1)
                    new_X = X + jnp.einsum("nti,ntd->nid", post, lda_feats)
                    ivec = solve_ivector(new_gamma, new_X, ivp)
                    if iv_inline and iv_cmvn_device:
                        # CMVN'd tap window from the rings: per row the
                        # sliding-window mean comes from two cum-ring
                        # gathers (host twin: stage_ivector_window with
                        # cmvn_stats -> online_cmvn_numpy over the
                        # prefix, rows clamped to min(t_end + sr, have))
                        Wiv = sl + chunk_in + sr
                        t_end = jnp.minimum(t0s + chunk_in, haves)
                        hist_hi = jnp.minimum(t_end + sr, haves)
                        clamp = jnp.maximum(hist_hi - 1, 0)[:, None]
                        rows_abs = t0s[:, None] + (
                            jnp.arange(Wiv, dtype=jnp.int32)[None, :] - sl
                        )
                        r = jnp.clip(rows_abs, 0, clamp)
                        # the raw rows equal the AM window's static slice
                        # (the clamps coincide over the tap range: the
                        # highest tap row index is t_end+sr-1 <= hist_hi-1
                        # and the window clamps at haves-1 >= hist_hi-1
                        # only where both bind to the same last row) —
                        # reuse it instead of re-gathering the full ring
                        raw = jax.lax.dynamic_slice_in_dim(
                            windows, -sl - win_lo, Wiv, axis=1
                        )[:, :, :num_ceps]
                        cum_r = jnp.take_along_axis(
                            cum_ring, r[:, :, None], axis=1
                        )
                        lo = jnp.maximum(r - (cmvn_window - 1), 0)
                        cum_lo = jnp.where(
                            (lo > 0)[:, :, None],
                            jnp.take_along_axis(
                                cum_ring,
                                jnp.maximum(lo - 1, 0)[:, :, None],
                                axis=1,
                            ),
                            0.0,
                        )
                        wsum = cum_r - cum_lo
                        cnt = (r - lo + 1).astype(jnp.float32)[:, :, None]
                        if cmvn_g_cap > 0:
                            take_g = jnp.clip(
                                cmvn_window - cnt, 0.0, cmvn_g_cap
                            )
                            mean = (
                                wsum
                                + (take_g / cmvn_g_count)
                                * cmvn_g_sum[None, None, :]
                            ) / (cnt + take_g)
                        else:
                            mean = wsum / cnt
                        new_iv_carry = raw - mean
                    elif iv_inline:
                        # next tick's pending window: static slice of the
                        # AM window (same edge clamping by construction)
                        off = -sl - win_lo
                        new_iv_carry = jax.lax.dynamic_slice_in_dim(
                            windows, off, sl + chunk_in + sr, axis=1
                        )[:, :, :num_ceps]
                else:
                    ivec = jnp.zeros(
                        (windows.shape[0], self.am.spec.ivector_dim),
                        dtype=jnp.float32,
                    )
            new_state = am_state
            am_in = windows
            am_ivec = ivec
            if bf16:
                am_in = windows.astype(jnp.bfloat16)
                if am_ivec is not None:
                    am_ivec = am_ivec.astype(jnp.bfloat16)
            if recurrent:
                log_probs, new_state = self._chunk_model.forward_with_state(
                    windows, am_state, ivec
                )
                active = n_valid > 0
                new_state = {
                    k: jnp.where(
                        active.reshape((-1,) + (1,) * (v.ndim - 1)),
                        v,
                        am_state[k],
                    )
                    for k, v in new_state.items()
                }
            elif am_ivec is None:
                log_probs = self._fwd_model.forward(am_in)  # [N, 7, P]
            else:
                log_probs = self._fwd_model.forward(am_in, am_ivec)
            if bf16:
                log_probs = log_probs.astype(jnp.float32)
            am_costs = -scale * jnp.swapaxes(log_probs, 0, 1)  # [7, N, P]
            ts = jnp.arange(chunk_out, dtype=jnp.int32)

            def step(a, xs):
                am_t, t = xs
                new_alpha, bp = decode_step(graph, a, am_t)
                active = (t < n_valid)[:, None]
                return (
                    jnp.where(active, new_alpha, a),
                    jnp.where(active, bp, -3),
                )

            new_alpha, bps = jax.lax.scan(step, alpha, (am_costs, ts))
            new_sw = None
            if sw_device:
                # OnlineSilenceWeighting's per-chunk traceback, on device:
                # walk this chunk's best path backwards (chunk_out point
                # gathers) flagging silence frames, then expand to the
                # NEXT tick's per-input-frame fold weights (host twin:
                # streaming_features.silence_weights_from_chunk +
                # _stage_ivector_stats's out_idx mapping).
                lanes_w = jnp.arange(alpha.shape[0])
                s_cur = jnp.argmin(new_alpha, axis=1).astype(jnp.int32)
                flags_rev = []
                for t in range(chunk_out - 1, -1, -1):
                    e = bps[t][lanes_w, s_cur]  # [N]
                    real = e >= 0
                    sb = jnp.maximum(e, 0)
                    flags_rev.append(
                        jnp.where(real, arc_sil_dev[sb], False)
                    )
                    s_cur = jnp.where(
                        real,
                        graph.base.arc_src[sb].astype(jnp.int32),
                        s_cur,
                    )
                flags = jnp.stack(flags_rev[::-1], axis=1)  # [N, chunk]
                kk = jnp.maximum(n_valid, 1).astype(jnp.int32)
                out_idx = jnp.minimum(
                    jnp.arange(chunk_in, dtype=jnp.int32)[None, :]
                    // subsampling,
                    (kk - 1)[:, None],
                )
                fsel = jnp.take_along_axis(flags, out_idx, axis=1)
                new_sw = jnp.where(fsel, jnp.float32(sw_factor), 1.0)

            if device_bp:
                enc = (bps + 3).astype(jnp.uint16)  # [chunk, N, S]
                rows = jnp.swapaxes(enc, 0, 1)  # [N, chunk, S]
                # The barrier keeps the ring write OUT of the decode
                # scan: without it XLA sinks this vmapped update into
                # the while loop as a per-frame element scatter —
                # measured 176 vs 45 ms for scan+write at 512 lanes x
                # 14k states (the whole-tick profile showed 165 ms
                # inside the scan's while op, ~18 ms per frame row).
                ring, rows, offs = jax.lax.optimization_barrier(
                    (ring, rows, offs)
                )
                ring = jax.vmap(
                    lambda buf, chunk_rows, off: jax.lax.dynamic_update_slice(
                        buf, chunk_rows, (off, 0)
                    )
                )(ring, rows, offs)
                new_offs = offs + n_valid
                # Combined whole-path walk over the updated ring, once
                # per tick: from each lane's best (final if reachable,
                # else overall-best) state back to frame 0, emitting
                #   - the arc trace (the FINALIZE backtrace for every
                #     lane — the packed [N, F + 2] output replaces the
                #     separate finalize_trace dispatches, which paid a
                #     full-ring defensive copy crossing programs: 19 ms
                #     per dispatch, 2/tick at 512 lanes)
                #   - endpoint signals (trail / nonsil: exactly Kaldi's
                #     TrailingSilenceLength walk, online-endpoint.h:
                #     122-148 — whole-path, uncapped; the per-(lane,
                #     state) in-scan DP this replaces cost [N, A] work
                #     per decode frame, 220 ms/tick at 512 lanes)
                # Each step is a [N, S] slice + [N] point gather (the
                # shape that lowers well); unroll=8 amortizes loop-step
                # overhead. Masking by per-lane frames makes the fixed
                # full-ring trip count exact.
                fw = graph.base.final_weight
                totals = new_alpha + fw[None, :]
                fcost = jnp.min(totals, axis=1)
                has_final = fcost < 1.0e29
                best_any = jnp.min(new_alpha, axis=1)
                ep_idx = jnp.where(
                    has_final,
                    jnp.argmin(totals, axis=1),
                    jnp.argmin(new_alpha, axis=1),
                ).astype(jnp.int32)
                lanes_i = jnp.arange(new_alpha.shape[0])
                arc_src_w = jnp.asarray(graph.base.arc_src)
                frames = new_offs

                def walk_step(carry, f):
                    state, trail, nonsil, done = carry
                    bp_t = jax.lax.dynamic_index_in_dim(
                        ring, f, axis=1, keepdims=False
                    )  # [N, S]
                    e = bp_t[lanes_i, state].astype(jnp.int32) - 3
                    active = f < frames
                    is_real = active & (e >= 0)
                    emit = jnp.where(active, e, jnp.int32(-2))
                    if ep_device:
                        sil = jnp.where(
                            is_real,
                            arc_sil_dev[jnp.maximum(e, 0)],
                            False,
                        )
                        trail = jnp.where(
                            is_real & sil & ~done, trail + 1, trail
                        )
                        done = done | (active & ~(is_real & sil))
                        nonsil = nonsil | (is_real & ~sil)
                    state = jnp.where(
                        is_real,
                        arc_src_w[jnp.maximum(e, 0)].astype(jnp.int32),
                        state,
                    )
                    return (state, trail, nonsil, done), emit

                F = ring.shape[1]
                ts_desc = jnp.arange(F - 1, -1, -1, dtype=jnp.int32)
                zeros_i = jnp.zeros(frames.shape[0], jnp.int32)
                zeros_b = jnp.zeros(frames.shape[0], jnp.bool_)
                (_, trail, nonsil, _), arcs_rev = jax.lax.scan(
                    walk_step,
                    (ep_idx, zeros_i, zeros_b, zeros_b),
                    ts_desc,
                    unroll=8,
                )
                arcs = jnp.swapaxes(arcs_rev[::-1], 0, 1)  # [N, F]
                # ONE uint16 packed row per lane [N, F + 8]: the arc
                # trace (emit + 2: 0 = STAY pad, 1 = dead, 2+ = arc id),
                # then 8 stat columns [final_state, has_final, trail,
                # nonsil, cost_lo, cost_hi, rel_lo, rel_hi] (the two f32
                # values ride as exact bit halves — the endpoint rules
                # compare the EXACT relative final cost). Folding the
                # endpoint stats into the same tensor as the finalize
                # backtrace halves the steady-state D2H bytes (u16 vs
                # i32) and drops the separate per-tick [N, 3] stats
                # fetch — on a remote-dispatch transport every D2H is a
                # full round-trip RPC.
                cb = jax.lax.bitcast_convert_type(fcost, jnp.int32)
                rel = jnp.where(
                    has_final, fcost - best_any, jnp.float32(jnp.inf)
                )
                relb = jax.lax.bitcast_convert_type(rel, jnp.int32)
                stats_cols = jnp.stack(
                    [
                        ep_idx,
                        has_final.astype(jnp.int32),
                        jnp.minimum(trail, 65535),
                        nonsil.astype(jnp.int32),
                        cb & 0xFFFF,
                        (cb >> 16) & 0xFFFF,
                        relb & 0xFFFF,
                        (relb >> 16) & 0xFFFF,
                    ],
                    axis=1,
                )
                packed = jnp.concatenate(
                    [arcs + 2, stats_cols], axis=1
                ).astype(jnp.uint16)
                return (
                    new_alpha, None, new_gamma, new_X, new_state,
                    ring, new_offs, new_iv_carry, packed, new_sw,
                )
            if bp_compact:
                bps = (bps + 3).astype(jnp.uint16)
            return (
                new_alpha, bps, new_gamma, new_X, new_state,
                ring, offs, new_iv_carry, None, new_sw,
            )

        device_bp = self._device_bp
        iv_inline = self._iv_inline
        device_feats = self._device_feats
        bf16 = self._bf16
        self._batch_chunk = jax.jit(
            batch_chunk,
            donate_argnums=(9,)
            + ((14,) if self._sw_device else ()),
            # cum_ring (15) is only threaded on the fused path
        )

        frontend_params = self.am.frontend_params
        pitch_device = self._pitch_device
        # Serving wire format. "i16" uploads raw 16-bit PCM; "mulaw"
        # G.711-encodes every sample on the host drain and the fused tick
        # decodes it with one 256-entry gather before the MFCC — HALF the
        # per-tick H2D bytes, which is the serving tick's dominant cost
        # on remote-dispatch transports (see ops/mulaw.py for the exact
        # lossy-wire/exact-pipeline contract). "adpcm" halves mu-law's
        # bytes again (~0.52 B/sample): 4-bit block-ADPCM in frame_shift-
        # sized blocks, decoded by a short lax.scan inside the tick
        # program (ops/adpcm.py for the stability proof that lets frame-
        # overlap tails re-encode across ticks without drifting). Only
        # the fused device-feats path has a wire; the host feature path
        # reads the pool directly.
        if wire not in ("i16", "mulaw", "adpcm"):
            raise ValueError(
                f"wire must be 'i16', 'mulaw' or 'adpcm', got {wire!r}"
            )
        self._wire_mulaw = wire == "mulaw" and self._device_feats
        self._wire_adpcm = wire == "adpcm" and self._device_feats
        adpcm_block = self._featurizer.frame_shift
        if self._wire_adpcm and (adpcm_block < 2 or 800 % adpcm_block):
            # block == frame_shift is what keeps block boundaries at the
            # same ABSOLUTE sample positions every tick (upload buffers
            # start at feat_counts * frame_shift); the 800-sample PCM
            # buckets must stay whole blocks too
            raise ValueError(
                "wire='adpcm' needs a frame shift that divides the "
                f"800-sample PCM bucket, got {adpcm_block}; use "
                "wire='mulaw'"
            )
        wire_mulaw = self._wire_mulaw
        wire_adpcm = self._wire_adpcm
        wire_u8 = wire_mulaw or wire_adpcm
        # trailing meta columns riding the PCM upload: 16 (8 i32 slots)
        # everywhere, 24 (12 slots) for device-pitch schedulers (3 extra
        # slots: window start sample, pitch-done frame, flush flag) —
        # widened ONLY for pitch so existing non-pitch AOT exports keep
        # their exact layout. On the uint8 wires each 16-bit meta half
        # needs two columns, so the trailing block doubles.
        TC = 24 if pitch_device else 16
        TCW = 2 * TC if wire_u8 else TC
        self._meta_cols = TCW
        if pitch_device:
            from ..ops.pitch import pitch_batch as _pitch_batch

            pitch_cfg = self.am.pitch_config
            Wp = self._pitch_win_samples
            t_w = self._pitch_t_w
            pitch_shift = self._featurizer.frame_shift

        def unpack_pcm_meta(pcm_meta):
            """Split the merged upload into (pcm_buf, [N, k] i32 meta).
            Meta rides as 16-bit lo/hi halves in the PCM dtype; on the
            uint8 wires each half is itself two bytes."""
            pcm_buf = pcm_meta[:, :-TCW]
            enc = pcm_meta[:, -TCW:].astype(jnp.int32)
            if wire_u8:
                enc = enc[:, 0::2] | (enc[:, 1::2] << 8)
            meta = (enc[:, 0::2] & 0xFFFF) | (enc[:, 1::2] << 16)
            return pcm_buf, meta

        def feed_only_merged(feats_ring, cum_ring, pcm_ring, pcm_meta):
            """Features-only tick on the same merged [N, L + TC] upload
            layout as the fused tick (meta slots 4/5 = write offsets /
            has-new, matching batch_chunk_fused's column map)."""
            pcm_buf, meta = unpack_pcm_meta(pcm_meta)
            return feed_feats(
                feats_ring,
                cum_ring,
                pcm_ring,
                pcm_buf,
                meta[:, 4],
                meta[:, 5].astype(jnp.bool_),
                meta,
            )

        def feed_pitch(feats_ring, pcm_ring, pcm_buf, counts, has_new, meta):
            """Device pitch lane: PCM into the history ring, ONE sliding
            pitch window per lane (pitch_batch inline), the NEW rows
            block-written into the feature ring's pitch columns at the
            pitch-done offset. The block is t_w rows with the gather
            index clamped to the window: rows past the new count repeat
            the newest row, which (a) is scratch for live lanes — they
            are rewritten by the next, overlapping block before the
            matched count lets the AM read them — and (b) IS the flush
            semantics for finished lanes (the host path repeats the last
            pitch row over the MFCC tail, streaming_features._merge)."""
            a_samp = meta[:, 7]  # window start sample (can be negative)
            pdone = meta[:, 8]  # absolute pitch frames already final
            pflush = meta[:, 9].astype(jnp.bool_)
            if pcm_buf.shape[1] > 0:
                pcm_ring, rows_p, cnts = jax.lax.optimization_barrier(
                    (pcm_ring, pcm_buf, counts)
                )
                pcm_ring = jax.vmap(
                    lambda buf, row, c, w: jnp.where(
                        w,
                        jax.lax.dynamic_update_slice(
                            buf, row, (c * pitch_shift + Wp,)
                        ),
                        buf,
                    )
                )(pcm_ring, rows_p, cnts, has_new)
            win = jax.vmap(
                lambda buf, a: jax.lax.dynamic_slice(buf, (a + Wp,), (Wp,))
            )(pcm_ring, a_samp)
            rows3 = _pitch_batch(pitch_cfg, win)  # [N, t_w, 3]
            a_frames = a_samp // pitch_shift
            lo = (pdone - a_frames).astype(jnp.int32)
            idx = jnp.clip(
                lo[:, None] + jnp.arange(t_w, dtype=jnp.int32)[None, :],
                0,
                t_w - 1,
            )
            sel = jnp.take_along_axis(rows3, idx[:, :, None], axis=1)
            n_abs = a_frames + t_w
            wmask = (n_abs > pdone) | pflush
            feats_ring, sel, pd = jax.lax.optimization_barrier(
                (feats_ring, sel, pdone.astype(jnp.int32))
            )
            feats_ring = jax.vmap(
                lambda buf, blk, p, w: jnp.where(
                    w,
                    jax.lax.dynamic_update_slice(buf, blk, (p, num_ceps)),
                    buf,
                )
            )(feats_ring, sel, pd, wmask)
            return feats_ring, pcm_ring

        def feed_feats(
            feats_ring, cum_ring, pcm_ring, pcm_buf, counts, has_new, meta
        ):
            """Write each lane's new MFCC rows into the device feature
            ring at its frame offset. Rows beyond a lane's real frame
            count are scratch (overwritten by the next write; reads clamp
            to the valid count). Lanes without new audio this tick keep
            their ring untouched (``has_new`` mask): an idle lane whose
            count sits near the ring end must not have this tick's larger
            padded row block clamp-written over its newest valid rows.
            ``pcm_buf`` arrives int16 when exact (PCM is 16-bit at the
            wire; halves the per-tick H2D bytes). A zero-length pcm_buf
            (no new audio anywhere this tick) skips the write entirely —
            the shape is static, so this is a compile-time branch. With
            device CMVN a cumulative-sum ring rides along: cum[t] = sum of
            rows 0..t (continued from the lane's last valid cum row), so
            any row's sliding-window mean is two gathers."""
            if pcm_buf.shape[1] > 0:
                if pcm_buf.dtype == jnp.uint8:
                    if wire_adpcm:
                        # 4-bit wire: a short unrolled scan over the
                        # block re-runs the IMA recurrence per lane-
                        # block (see ops/adpcm.py)
                        from ..ops.adpcm import decode_blocks_jnp

                        pcm_buf = decode_blocks_jnp(pcm_buf, adpcm_block)
                    else:
                        # mu-law wire: one 256-entry gather, fused into
                        # the MFCC framing by XLA (see ops/mulaw.py)
                        from ..ops.mulaw import decode_u8_jnp

                        pcm_buf = decode_u8_jnp(pcm_buf)
                elif pcm_buf.dtype != jnp.float32:
                    pcm_buf = pcm_buf.astype(jnp.float32)
                rows = mfcc_batch(frontend_params, pcm_buf)  # [N, Lf, D]
                # barrier: keep the ring updates out of the MFCC loops
                # (the same scatter-sinking pathology as the decode-scan
                # ring write; see the bp-ring barrier in batch_chunk)
                feats_ring, rows, counts = jax.lax.optimization_barrier(
                    (feats_ring, rows, counts)
                )
                write = jax.vmap(
                    lambda buf, lane_rows, cnt, w: jnp.where(
                        w,
                        jax.lax.dynamic_update_slice(buf, lane_rows, (cnt, 0)),
                        buf,
                    )
                )
                feats_ring = write(feats_ring, rows, counts, has_new)
                if iv_cmvn_device:
                    prev = jnp.where(
                        (counts > 0)[:, None],
                        jnp.take_along_axis(
                            cum_ring,
                            jnp.maximum(counts - 1, 0)[:, None, None],
                            axis=1,
                        )[:, 0, :],
                        0.0,
                    )
                    cum_rows = prev[:, None, :] + jnp.cumsum(rows, axis=1)
                    cum_ring, cum_rows = jax.lax.optimization_barrier(
                        (cum_ring, cum_rows)
                    )
                    cum_ring = write(cum_ring, cum_rows, counts, has_new)
            if pitch_device:
                # runs even on zero-width uploads: flush ticks complete a
                # finished lane's pitch tail with no new audio anywhere
                feats_ring, pcm_ring = feed_pitch(
                    feats_ring, pcm_ring, pcm_buf, counts, has_new, meta
                )
            return feats_ring, cum_ring, pcm_ring

        def batch_chunk_fused(
            alpha, pcm_meta, gamma, X, iv_wins, am_state, ring,
            feats_ring, offs, sw_w, cum_ring, pcm_ring
        ):
            """One-dispatch serving tick (device-feats mode): PCM -> MFCC
            rows into the feature ring -> AM windows -> decode, all in a
            single program. The tick uploads exactly ONE host array:
            ``pcm_meta`` [N, L + TC] — the PCM batch with every per-tick
            lane scalar (n_valid, reset, t0, have, feat-ring write
            offset, has-new-audio, i-vector pending-weight count, and for
            pitch models window-start/pitch-done/flush) riding as TC
            trailing lo/hi 16-bit halves in the PCM dtype (int16 wraps;
            f32 carries the halves exactly) — on a remote-dispatch
            transport every separate H2D is its own RPC. The i-vector
            fold weights are a prefix mask reconstructed from the count
            (the host staged iv_n valid frames last tick)."""
            pcm_buf, meta = unpack_pcm_meta(pcm_meta)
            n_valid = meta[:, 0]
            reset = meta[:, 1].astype(jnp.bool_)
            t0s = meta[:, 2]
            haves = meta[:, 3]
            counts = meta[:, 4]
            has_new = meta[:, 5].astype(jnp.bool_)
            iv_n = meta[:, 6]
            feats_ring, cum_ring, pcm_ring = feed_feats(
                feats_ring, cum_ring, pcm_ring, pcm_buf, counts, has_new,
                meta,
            )
            iv_ws = (
                jnp.arange(chunk_in, dtype=jnp.int32)[None, :]
                < iv_n[:, None]
            ).astype(jnp.float32)
            dummy_win = jnp.zeros((alpha.shape[0], 1, 1), jnp.float32)
            out = batch_chunk(
                alpha, dummy_win, n_valid, reset, gamma, X, iv_wins,
                iv_ws, am_state, ring, offs, feats_ring, t0s, haves,
                sw_w, cum_ring,
            )
            return out + (feats_ring, cum_ring, pcm_ring)

        # Donate every threaded state buffer (all are replaced by the
        # outputs each tick). iv_wins is donated only when it's the real
        # device-carried window (ivp is None -> a persistent dummy that
        # must survive across ticks).
        fused_donate = (
            (0, 2, 3, 5, 6, 7)
            + ((4,) if self._iv_inline else ())
            + ((9,) if self._sw_device else ())
            + ((10,) if self._iv_cmvn_device else ())
            + ((11,) if pitch_device else ())
        )
        self._batch_chunk_fused = (
            jax.jit(batch_chunk_fused, donate_argnums=fused_donate)
            if self._device_feats
            else None
        )
        # standalone ring write for features-only ticks (no ready lane)
        self._feed_only = (
            jax.jit(
                feed_only_merged,
                donate_argnums=(0,)
                + ((1,) if self._iv_cmvn_device else ())
                + ((2,) if pitch_device else ()),
            )
            if self._device_feats
            else None
        )
        self._fused_donate = fused_donate
        # AOT program store: save_aot() exports the serving-tick programs
        # (fused tick, feature-only feed, finalize-trace buckets) as
        # StableHLO under <graph_dir>/aot; a later serving process skips
        # all tracing/lowering for them. Gated off under a mesh (exported
        # programs pin shardings).
        from ..utils.aot import AotStore

        self._aot = (
            AotStore(Path(graph_dir) / "aot")
            if (self._device_feats and mesh is None)
            else None
        )
        self._aot_export = False
        self._aot_cache: dict = {}
        if self._device_feats:
            # rows are [mfcc | pitch] for pitch models (feat_dim wide);
            # the drain writes cols [0, num_ceps), the pitch section
            # writes cols [num_ceps, feat_dim)
            self._feats_ring = jnp.zeros(
                (
                    max_streams,
                    self._feat_ring_frames,
                    self._featurizer.feat_dim,
                ),
                jnp.float32,
            )
        else:
            # lane-dim dummy so mesh sharding stays divisible
            self._feats_ring = jnp.zeros((max_streams, 1, 1), jnp.float32)
        if self._pitch_device:
            # per-lane PCM history for the sliding pitch window. Absolute
            # sample indexing with a leading pitch-window zero pad: sample
            # s lives at ring index s + Wp, so a window slice starting at
            # a (possibly negative, zero-padded at stream start — the
            # host featurizer pads identically) is always the in-bounds
            # dynamic slice [a + Wp, a + 2*Wp).
            self._pcm_ring = jnp.zeros(
                (
                    max_streams,
                    self._pitch_win_samples
                    + pool_capacity_samples
                    + self._drain_cap
                    + 1600,
                ),
                jnp.float32,
            )
        else:
            self._pcm_ring = jnp.zeros((max_streams, 1), jnp.float32)
        self._pitch_done = np.zeros(max_streams, dtype=np.int64)
        self._pcm_total = np.zeros(max_streams, dtype=np.int64)
        # cumulative-sum ring for the device i-vector CMVN (dummy when off)
        self._cum_ring = jnp.zeros(
            (max_streams, self._feat_ring_frames, num_ceps)
            if (self._device_feats and self._iv_cmvn_device)
            else (max_streams, 1, 1),
            jnp.float32,
        )
        self._feat_counts = np.zeros(max_streams, dtype=np.int32)
        if self._iv_inline:
            self._iv_carry = jnp.zeros(
                (
                    max_streams,
                    ivp.splice_left + self._chunk_in + ivp.splice_right,
                    num_ceps,
                ),
                jnp.float32,
            )
        else:
            self._iv_carry = None
        self._pending_reset = np.zeros(max_streams, dtype=bool)
        # Per-lane i-vector pending-weight count for the fused tick path
        # (the count reconstructs the prefix mask on device); the host
        # iv_pending_w arrays serve the non-fused paths.
        self._iv_pending_n = np.zeros(max_streams, dtype=np.int32)
        self._iv_dummy = (
            jnp.zeros((max_streams, 1, 1), jnp.float32)
            if (self._device_feats and not self._iv_inline)
            else None
        )
        self._tick_ring: List[_TickBps] = []
        self._alpha_host: Optional[_TickBps] = None
        # this tick's in-program [N, F + 8] packed finalize backtrace +
        # endpoint stats (device ref; harvested lazily for lanes that
        # flush) and its shared host fetch (started by the endpoint lane)
        self._tick_packed = None
        self._tick_packed_fetch = None
        # Pipeline-depth bound: fused ticks in flight whose completion
        # marker (the packed fetch, or a tiny offs read) has not been
        # joined. When the tick loop's host work is faster than the
        # device's service, an unpaced loop grows the device queue
        # without bound and every FORCED join (endpoint-stats staleness
        # cap) then drains the whole backlog. Capping the in-flight
        # depth at 2 self-paces the loop at the service rate: tick N
        # blocks (briefly) on tick N-2,
        # whose result has usually already landed, uploads for N overlap
        # execution of N-1, and the endpoint stats are never more than
        # ~2 chunks stale.
        self._inflight: "collections.deque" = collections.deque()
        self._pipeline_depth = int(
            os.environ.get("RSTPU_PIPELINE_DEPTH", "2")
        )
        self._fuzzy_cache: dict = {}
        self._pending_finalize: list = []
        # results of CLOSED streams whose finalize trace landed after (or
        # at) close — keyed by the (sid, gen) ticket close() returns, so
        # a serving loop can recycle a done lane IMMEDIATELY instead of
        # idling it 1-2 ticks until its async trace lands (measured ~20%
        # of lane-ticks lost to that wait at 512 lanes). Bounded FIFO.
        self._retired: Dict[Tuple[int, int], List[str]] = {}
        self._retired_cap = max(64, 4 * max_streams)
        # lanes quarantined this tick (ring-capacity overflow): they are
        # force-finalized with whatever decoded so far instead of raising
        # out of the shared tick and killing every other in-flight lane
        self._quarantined: Set[int] = set()
        # per-tick snapshot of the pool's finished flags (fast drain path)
        self._fin_snap: Optional[np.ndarray] = None
        # per-tick endpoint-stat entries (fetch, gens, out_frames snap),
        # oldest first; _apply_endpoint_stats consumes the newest landed
        self._ep_stats_pending: "collections.deque" = collections.deque()
        self._ep_stats_deferred = 0
        self._ep_tick_stats = None
        self._pending_drain = False
        # device silence-weighting fold weights for the next tick (a new
        # lane's stale values are masked by its zero iv_n prefix count)
        self._sw_w = (
            jnp.ones((max_streams, self._chunk_in), jnp.float32)
            if self._sw_device
            else None
        )
        self._am_state = (
            self._chunk_model.init_state(max_streams) if recurrent else {}
        )
        if ivp is not None:
            num_gauss = int(ivp.gconsts.shape[0])
            lda_dim = int(ivp.lda.shape[0])
            self._iv_gamma = jnp.zeros((max_streams, num_gauss), jnp.float32)
            self._iv_X = jnp.zeros((max_streams, num_gauss, lda_dim), jnp.float32)
            self._iv_win_shape = (
                ivp.splice_left + self._chunk_in + ivp.splice_right,
                self.am.frontend_config.num_ceps,
            )
        else:
            self._iv_gamma = jnp.zeros((max_streams, 1), jnp.float32)
            self._iv_X = jnp.zeros((max_streams, 1, 1), jnp.float32)
            self._iv_win_shape = (1, 1)

        S = self.graph.num_states
        self._alpha = jnp.broadcast_to(
            jnp.asarray(self.graph.init_weight)[None, :], (max_streams, S)
        ).copy()
        if self._device_bp:
            self._ring = jnp.zeros(
                (max_streams, self._ring_frames, S), dtype=jnp.uint16
            )
        else:
            self._ring = jnp.zeros((max_streams, 1, 1), dtype=jnp.uint16)
        self._offs = jnp.zeros(max_streams, dtype=jnp.int32)

        # Multi-chip lane sharding: persistent per-lane state and per-tick
        # inputs placed P("streams", ...) so XLA partitions the chunk step
        # over the mesh (all ops are per-lane; zero collectives).
        self._lane_spec = None
        self._mesh_shards = 0
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n = int(np.prod(mesh.devices.shape))
            if max_streams % n:
                raise ValueError(
                    f"max_streams={max_streams} must be a multiple of the "
                    f"mesh size {n}"
                )
            axis = mesh.axis_names[0]
            self._mesh_shards = n

            def _lane_spec(a):
                return NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))

            self._lane_spec = _lane_spec
            self._alpha = jax.device_put(self._alpha, _lane_spec(self._alpha))
            self._iv_gamma = jax.device_put(
                self._iv_gamma, _lane_spec(self._iv_gamma)
            )
            self._iv_X = jax.device_put(self._iv_X, _lane_spec(self._iv_X))
            self._am_state = {
                k: jax.device_put(v, _lane_spec(v))
                for k, v in self._am_state.items()
            }
            self._ring = jax.device_put(self._ring, _lane_spec(self._ring))
            self._offs = jax.device_put(self._offs, _lane_spec(self._offs))
            if self._sw_w is not None:
                self._sw_w = jax.device_put(
                    self._sw_w, _lane_spec(self._sw_w)
                )
            if self._iv_carry is not None:
                self._iv_carry = jax.device_put(
                    self._iv_carry, _lane_spec(self._iv_carry)
                )
            self._feats_ring = jax.device_put(
                self._feats_ring, _lane_spec(self._feats_ring)
            )
            self._cum_ring = jax.device_put(
                self._cum_ring, _lane_spec(self._cum_ring)
            )
        # On-device finalize backtrace (device-ring mode): one call per
        # tick handles up to _FINALIZE_BATCH flushed lanes, transferring
        # only [F_max, F] arc traces (kilobytes) instead of per-lane
        # [T, S] backpointer history.
        base = self.device_graph.base
        final_w = base.final_weight
        arc_src_dev = base.arc_src
        ring_frames = self._ring_frames

        def finalize_trace(ring, alpha, fin_meta, steps):
            """fin_meta [F_max, 2] int32 (sid, frames) -> ONE packed
            [F_max, steps + 2] int32: per row the arc trace, then the
            final state, then the path cost bitcast to int32 — a single
            async D2H instead of three (each forced np.asarray on a
            separate array costs a full dispatch round trip over a
            remote-transport link). Entries with frames == 0 are padding;
            ``steps`` (static) is the bucketed scan length (>= max frames
            in the group), so short utterances don't pay a full-ring-depth
            walk."""
            sids = fin_meta[:, 0]
            frames = fin_meta[:, 1]
            totals = alpha[sids] + final_w[None, :]
            fstate = jnp.argmin(totals, axis=-1).astype(jnp.int32)
            cost = jnp.take_along_axis(totals, fstate[:, None], axis=1)[:, 0]
            lanes = jnp.arange(sids.shape[0])

            # Gather the needed lanes once ([Fm, steps, S] — bounded HBM
            # traffic), then scan the TIME axis so each step indexes a
            # small [Fm, S] slice — the same structure as the batch
            # decoder's on-device backtrace, instead of a per-step point
            # gather from the full ring (which lowers ~25x slower).
            rows = ring[sids, :steps]  # [Fm, steps, S] u16
            rows_rev = jnp.swapaxes(rows, 0, 1)[::-1]  # [steps, Fm, S]

            def back(state, xs):
                bp_t, t = xs
                active = t < frames
                enc = bp_t[lanes, state].astype(jnp.int32) - 3
                is_real = active & (enc >= 0)
                src = jnp.where(
                    is_real, arc_src_dev[jnp.maximum(enc, 0)], state
                )
                emit = jnp.where(active, enc, jnp.int32(-2))  # STAY pad
                return src, emit

            ts = jnp.arange(steps - 1, -1, -1, dtype=jnp.int32)
            # unroll: each step is a [Fm, S] slice + [Fm] point gather —
            # loop overhead dominates (measured ~19 ms per finalize
            # dispatch at steps=128 without it)
            _, arcs_rev = jax.lax.scan(
                back, fstate, (rows_rev, ts), unroll=8
            )
            arcs = jnp.swapaxes(arcs_rev[::-1], 0, 1)
            cost_bits = jax.lax.bitcast_convert_type(cost, jnp.int32)
            return jnp.concatenate(
                [arcs, fstate[:, None], cost_bits[:, None]], axis=1
            )

        self._finalize_trace = jax.jit(finalize_trace, static_argnums=(3,))

        cfg = self.am.frontend_config
        self._frame_len = cfg.frame_length
        self._frame_shift = cfg.frame_shift

    # -- stream lifecycle ------------------------------------------------------

    def _open_slot(self) -> int:
        """Pick a pool slot. Under a mesh, fill device shards EVENLY:
        lanes are sharded in contiguous blocks of max_streams/shards, so
        first-free admission would pile partial occupancy onto shard 0
        while the other chips run masked lanes for nothing."""
        n = self._mesh_shards
        if n <= 1:
            return self.pool.open()
        per = self.max_streams // n
        occ = [0] * n
        for sid, st in enumerate(self.slots):
            if st.active:
                occ[sid // per] += 1
        for shard in sorted(range(n), key=lambda s: (occ[s], s)):
            for sid in range(shard * per, (shard + 1) * per):
                if not self.slots[sid].active:
                    got = self.pool.open_at(sid)
                    if got == sid:
                        return sid
        # stale native build without open_at (or a race): plain admission
        return self.pool.open()

    def open_stream(self) -> int:
        sid = self._open_slot()
        if sid < 0:
            return -1
        state = self.slots[sid]
        state.active = True
        state.feats = np.zeros((0, self._featurizer.feat_dim), np.float32)
        state.feat_state = self._featurizer.new_state()
        self._feat_counts[sid] = 0
        self._pitch_done[sid] = 0
        self._pcm_total[sid] = 0
        state.frames_consumed = 0
        state.out_frames = 0
        state.bps = []
        state.done = False
        state.result = None
        state.error = None
        state.flushed_feats = False
        self._quarantined.discard(sid)
        state.iv_pending_win = np.zeros(self._iv_win_shape, np.float32)
        state.iv_pending_w = np.zeros(self._chunk_in, np.float32)
        self._iv_pending_n[sid] = 0
        state.gen += 1
        # device-state reset (alpha / i-vector stats / recurrence rows) is
        # folded into the next chunk program via this mask — admission
        # costs no device dispatch
        self._pending_reset[sid] = True
        return sid

    def feed(self, sid: int, pcm: np.ndarray) -> int:
        return self.pool.feed(sid, pcm)

    def feed_many(self, sids: np.ndarray, pcm: np.ndarray) -> np.ndarray:
        """Feed row k of ``pcm`` [count, n] int16 to lane ``sids[k]`` in
        one batched native call (see StreamPool.feed_many) — the serving
        loop's per-tick ingest path; per-lane ``feed`` calls cost ~50us
        of Python/ctypes overhead each at high lane counts."""
        return self.pool.feed_many(sids, pcm)

    def finish(self, sid: int) -> None:
        self.pool.finish(sid)

    def poll(self, sid: int, block: bool = True) -> Optional[List[str]]:
        """Result once the stream is fully decoded; None while in flight.
        With ``block=False`` a finished stream whose finalize trace has
        not landed yet also returns None (pure non-blocking poll loop;
        the result appears on a later poll or after the next step)."""
        state = self.slots[sid]
        if state.done:
            if state.result is None and self._pending_finalize:
                self._harvest_finalizes(block=block)
            return state.result
        return None

    def close(self, sid: int) -> Tuple[int, int]:
        """Release the slot for reuse. Returns a ``(sid, gen)`` ticket:
        when the stream was finished but its async finalize trace has not
        landed yet, the result is delivered to the retired store instead
        of being dropped — ``take_result(ticket)`` retrieves it. A lane
        can therefore be recycled the moment its endpoint fires / feed
        finishes, without idling it until the trace D2H lands."""
        state = self.slots[sid]
        ticket = (sid, state.gen)
        if state.done and state.result is not None:
            self._retire(ticket, state.result)
        # bump NOW (not just on open): any in-flight finalize for this
        # incarnation now routes to the retired store via the gen guard
        state.gen += 1
        state.active = False
        self._quarantined.discard(sid)
        self.pool.close(sid)
        return ticket

    def _retire(self, ticket: Tuple[int, int], result: List[str]) -> None:
        if len(self._retired) >= self._retired_cap:
            # drop oldest (insertion order): a caller that never collects
            # tickets must not leak
            self._retired.pop(next(iter(self._retired)))
        self._retired[ticket] = result

    def take_result(
        self, ticket: Tuple[int, int], block: bool = False
    ) -> Optional[List[str]]:
        """Result of a closed stream, by close()'s ticket; None while its
        finalize trace is still in flight (``block=True`` forces the
        harvest). A returned result is popped — each ticket redeems once."""
        res = self._retired.pop(ticket, None)
        if res is None and self._pending_finalize:
            self._harvest_finalizes(block=block)
            res = self._retired.pop(ticket, None)
        return res

    def error(self, sid: int) -> Optional[str]:
        """Non-None when the stream was force-finalized by a capacity
        quarantine (it outlived the device rings sized from
        ``pool_capacity_samples``). ``poll()`` still returns the partial
        transcript decoded before the cutoff."""
        return self.slots[sid].error

    def _quarantine(self, sid: int, what: str, capacity: int) -> None:
        """Force-finalize one overlong stream instead of raising out of
        the shared serving tick: a raise here would abort the tick for
        every in-flight lane, so one runaway utterance could take down a
        whole fleet's tick loop. The lane is finalized with whatever was
        decoded so far, ``error(sid)`` reports the cutoff, and the loud
        log stays."""
        msg = (
            f"stream {sid} exceeds the device {what} ({capacity} frames); "
            "it was force-finalized with the audio decoded so far — raise "
            "pool_capacity_samples to the longest expected utterance"
        )
        _LOGGER.error(msg)
        self.slots[sid].error = msg
        self._quarantined.add(sid)

    @property
    def active_streams(self) -> int:
        return sum(1 for s in self.slots if s.active and not s.done)

    # -- scheduling -------------------------------------------------------------

    def _write_meta_cols(self, batch: np.ndarray, meta: np.ndarray) -> None:
        """Write the [N, k<=TC/2] int32 meta pack into the batch's TC
        trailing columns as lo/hi 16-bit halves in the PCM dtype (int16
        wraps modulo 2^16 — the program re-masks; f32 holds the halves
        exactly). On the uint8 mu-law wire each half is two bytes
        (little-endian), so the trailing block is 2x wide."""
        tc = self._meta_cols
        k = meta.shape[1]
        dt = batch.dtype
        batch[:, -tc:] = 0
        if dt == np.uint8:
            halves = np.empty((meta.shape[0], 2 * k), dtype=np.int32)
            halves[:, 0::2] = meta & 0xFFFF
            halves[:, 1::2] = (meta >> 16) & 0xFFFF
            batch[:, -tc : -tc + 4 * k : 2] = (halves & 0xFF).astype(dt)
            batch[:, -tc + 1 : -tc + 1 + 4 * k : 2] = (
                (halves >> 8) & 0xFF
            ).astype(dt)
            return
        batch[:, -tc : -tc + 2 * k : 2] = (meta & 0xFFFF).astype(dt)
        batch[:, -tc + 1 : -tc + 1 + 2 * k : 2] = (
            (meta >> 16) & 0xFFFF
        ).astype(dt)

    def _plan_pitch(self) -> Optional[np.ndarray]:
        """Per-tick device-pitch plan: window start sample, the absolute
        frame count the window write will reach, and the flush mask
        (finished lanes whose MFCC tail outruns the pitch rows — the
        block write repeats the newest row over it, the host path's
        flush semantics). Returns the matched per-lane frame count the
        ready loop gates on, or None when pitch is off."""
        if not self._pitch_device:
            return None
        shift = self._featurizer.frame_shift
        a = (self._pcm_total - self._pitch_win_samples) // shift * shift
        n_abs = a // shift + self._pitch_t_w
        matched = np.minimum(
            self._feat_counts.astype(np.int64),
            np.maximum(self._pitch_done, n_abs),
        )
        flush = np.zeros(self.max_streams, dtype=bool)
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and state.flushed_feats
                and (
                    bool(self._fin_snap[sid])
                    if self._fin_snap is not None
                    else self.pool.is_finished(sid)
                )
                and matched[sid] < int(self._feat_counts[sid])
            ):
                flush[sid] = True
                matched[sid] = int(self._feat_counts[sid])
        self._pitch_plan = (a, n_abs, flush)
        return matched

    def _stage_pitch_meta(self, meta: np.ndarray) -> None:
        if not self._pitch_device:
            return
        a, _n_abs, flush = self._pitch_plan
        meta[:, 7] = a
        meta[:, 8] = self._pitch_done
        meta[:, 9] = flush

    def _commit_pitch_meta(self) -> None:
        """After a dispatch carrying the pitch meta: the rows the plan
        promised are now (will be, in program order) in the ring."""
        a, n_abs, flush = self._pitch_plan
        self._pitch_done = np.maximum(self._pitch_done, n_abs)
        if flush.any():
            self._pitch_done[flush] = self._feat_counts[flush]

    def _step_fused(
        self, prep, n_valid, chunk_t0, chunk_have, flushed, metrics
    ) -> None:
        """Dispatch the fused serving tick (device-feats mode): exactly
        ONE H2D upload (the PCM batch with the meta pack riding in its
        16 trailing columns) and ONE device program covering feature-ring
        write, AM windows, i-vector fold, and decode. Nothing here
        blocks on the device."""
        N = self.max_streams
        if prep is not None:
            pcm_batch, counts_before, has_new = prep
        else:
            pcm_batch = np.zeros(
                (N, self._meta_cols),
                dtype=np.uint8
                if (self._wire_mulaw or self._wire_adpcm)
                else np.int16,
            )
            counts_before = np.zeros(N, dtype=np.int32)
            has_new = np.zeros(N, dtype=bool)
        meta = np.zeros((N, 10 if self._pitch_device else 7), dtype=np.int32)
        meta[:, 0] = n_valid
        meta[:, 1] = self._pending_reset
        meta[:, 2] = chunk_t0
        meta[:, 3] = chunk_have
        meta[:, 4] = counts_before
        meta[:, 5] = has_new
        if self._ivp is not None:
            meta[:, 6] = self._iv_pending_n
        self._stage_pitch_meta(meta)
        self._write_meta_cols(pcm_batch, meta)
        # Upload BEFORE the pace join: the PCM batch depends only on host
        # state, so its H2D transfer rides the transport while we wait for
        # the oldest in-flight tick's D2H to land (the join below). Only
        # the dispatch itself must stay behind the in-flight bound.
        with StageTimer("stream_upload", metrics):
            if self._lane_spec is not None:
                pcm_dev = jax.device_put(
                    pcm_batch, self._lane_spec(pcm_batch)
                )
            else:
                pcm_dev = jnp.asarray(pcm_batch)
        with StageTimer("stream_pace", metrics):
            # pipeline-depth bound (see _inflight): join the oldest
            # in-flight tick before dispatching a new one
            while len(self._inflight) >= self._pipeline_depth:
                self._inflight.popleft().get()
        with StageTimer("stream_chunk", metrics):
            ivw = self._iv_carry if self._iv_inline else self._iv_dummy
            (
                alpha, _bps, gamma, X, am_state, ring, offs, iv_carry,
                packed, sw_w, feats_ring, cum_ring, pcm_ring,
            ) = self._aot_call(
                "sched_tick",
                self._batch_chunk_fused,
                (
                    self._alpha, pcm_dev, self._iv_gamma,
                    self._iv_X, ivw, self._am_state, self._ring,
                    self._feats_ring, self._offs,
                    self._sw_w, self._cum_ring, self._pcm_ring,
                ),
                donate=self._fused_donate,
                vary=pcm_dev,
            )
            self._pending_reset[:] = False
            self._alpha = alpha
            self._am_state = am_state
            self._iv_gamma, self._iv_X = gamma, X
            self._ring, self._offs = ring, offs
            self._feats_ring = feats_ring
            self._tick_packed = packed
            if self._iv_cmvn_device:
                self._cum_ring = cum_ring
            if self._pitch_device:
                self._pcm_ring = pcm_ring
                self._commit_pitch_meta()
            if self._iv_inline:
                self._iv_carry = iv_carry
            if self._sw_device:
                self._sw_w = sw_w
        if self._ivp is not None:
            # everything passed this tick was folded into gamma/X — clear
            # so nothing is double-counted next tick
            self._iv_pending_n[:] = 0
        with StageTimer("stream_book", metrics):
            for sid, state in enumerate(self.slots):
                k = int(n_valid[sid])
                if k <= 0:
                    continue
                state.out_frames += k
                if self._ivp is not None:
                    t0 = int(chunk_t0[sid])
                    self._iv_pending_n[sid] = max(
                        0, min(self._chunk_in, int(chunk_have[sid]) - t0)
                    )
                state.frames_consumed += self._chunk_in
                fin = (
                    bool(self._fin_snap[sid])
                    if self._fin_snap is not None
                    else self.pool.is_finished(sid)
                )
                if (
                    fin
                    and state.flushed_feats
                    and state.frames_consumed >= int(self._feat_counts[sid])
                ):
                    flushed.append(sid)
        if self._ep_device:
            # applied next tick, guarded by slot generation; out_frames
            # snapshot AFTER this tick so utterance_length matches the
            # alpha the stats were computed from. The fetch covers the
            # WHOLE packed row (trace + stats): finalize harvests reuse
            # it instead of starting their own D2H, and it doubles as
            # this tick's pipeline-depth completion marker.
            fetch = _AsyncFetch(packed)
            self._tick_packed_fetch = fetch
            self._inflight.append(fetch)
            self._ep_stats_pending.append((
                _PackedStatsFetch(fetch),
                [s.gen for s in self.slots],
                np.array(
                    [s.out_frames for s in self.slots], dtype=np.int64
                ),
            ))
        else:
            # no endpoint lane: a tiny offs read is the completion marker
            self._inflight.append(_AsyncFetch(self._offs))

    # Total device-program dispatches since construction (fused ticks,
    # feature-only feeds, standalone finalize traces, host-path chunk
    # programs and MFCC/pitch batches). A steady-state serving tick must
    # dispatch EXACTLY ONE program; tests pin this so a per-lane or
    # per-stage dispatch can never silently creep back in (each dispatch
    # costs a full round trip on remote-dispatch transports).
    device_dispatches = 0

    def _aot_call(self, name, jitted, args, donate=(), vary=None):
        """Dispatch through a serialized AOT program when one exists for
        these shapes; export one when save_aot() is driving; else run the
        normal jit. Donation is re-applied to restored programs so the
        threaded state buffers keep their in-place reuse.

        ``vary`` is the one argument whose shape/dtype changes between
        ticks (the padded PCM batch); everything else is fixed per
        scheduler instance, so the resolved callable is memoized on
        (name, vary spec) and steady-state ticks pay one dict hit instead
        of a full spec hash (~0.4 ms)."""
        self.device_dispatches += 1
        if self._aot is None:
            return jitted(*args)
        key = (
            name,
            None if vary is None else (vary.shape, str(vary.dtype)),
        )
        if not self._aot_export:
            cached = self._aot_cache.get(key)
            if cached is not None:
                return cached(*args)
            if key in self._aot_cache:  # known miss
                return jitted(*args)
        loaded = self._aot.load(name, args, donate_argnums=donate)
        if loaded is None and self._aot_export:
            self._aot.save(name, jitted, args, donate_argnums=donate)
            loaded = self._aot.load(name, args, donate_argnums=donate)
        self._aot_cache[key] = loaded
        return (loaded or jitted)(*args)

    def save_aot(self, seconds: float = 3.0) -> "Path":
        """Export this configuration's serving-tick programs by driving
        synthetic int16-silence through every lane (open, chunk-sized
        feeds, finish, drain): the fused tick, the features-only feed,
        and the finalize-trace bucket for ``seconds``-long utterances all
        get serialized into ``<graph_dir>/aot``. Run once at deploy time
        on a fresh scheduler (this mutates lane state; all streams are
        closed afterwards); a later serving process then skips
        tracing/lowering — the streaming analogue of the batch
        transcriber's save_aot (Kaldi binaries are AOT-compiled C++ and
        never re-trace on restart)."""
        if self._aot is None:
            raise RuntimeError(
                "AOT export needs the fused device-feats path and no mesh"
            )
        chunk_samples = self._chunk_in * self._frame_shift
        n_chunks = max(2, int(round(seconds * 16000 / chunk_samples)))
        pcm = np.zeros(chunk_samples, dtype=np.float32)
        self._aot_export = True
        try:
            sids = []
            while True:
                sid = self.open_stream()
                if sid < 0:
                    break
                sids.append(sid)
            for i in range(n_chunks):
                for sid in sids:
                    self.feed(sid, pcm)
                self.step()
            for sid in sids:
                self.finish(sid)
            self.run_until_idle()
            for sid in sids:
                self.poll(sid)
                self.close(sid)
            # cover the other PCM buckets serving can dispatch (arrival
            # jitter and bursts change the padded width, and each width
            # is its own program): dribble feeds walk the small buckets,
            # a burst past the drain cap walks the largest + leftover
            sid = self.open_stream()
            for _ in range(8):
                self.feed(sid, np.zeros(1200, dtype=np.float32))
                self.step()
            self.finish(sid)
            self.run_until_idle()
            self.poll(sid)
            self.close(sid)
            sid = self.open_stream()
            self.feed(
                sid, np.zeros(2 * self._drain_cap + 1600, dtype=np.float32)
            )
            self.step()
            self.step()
            self.finish(sid)
            self.run_until_idle()
            self.poll(sid)
            self.close(sid)
        finally:
            self._aot_export = False
        return self._aot.dir

    def _feed_only_dispatch(self, prep, metrics) -> None:
        """Features-only tick: only the MFCC ring write (and the pitch
        lane, for pitch models) runs on device. Same merged [N, L + TC]
        upload layout as the fused tick (meta slots 4/5, 7-9)."""
        pcm_batch, counts, has_new = prep
        meta = np.zeros(
            (pcm_batch.shape[0], 10 if self._pitch_device else 6),
            dtype=np.int32,
        )
        meta[:, 4] = counts
        meta[:, 5] = has_new
        self._stage_pitch_meta(meta)
        self._write_meta_cols(pcm_batch, meta)
        with StageTimer("stream_chunk", metrics):
            if self._lane_spec is not None:
                pcm_dev = jax.device_put(
                    pcm_batch, self._lane_spec(pcm_batch)
                )
            else:
                pcm_dev = jnp.asarray(pcm_batch)
            self._feats_ring, self._cum_ring, self._pcm_ring = (
                self._aot_call(
                    "sched_feed",
                    self._feed_only,
                    (
                        self._feats_ring, self._cum_ring, self._pcm_ring,
                        pcm_dev,
                    ),
                    donate=(0,)
                    + ((1,) if self._iv_cmvn_device else ())
                    + ((2,) if self._pitch_device else ()),
                    vary=pcm_dev,
                )
            )
            if self._pitch_device:
                self._commit_pitch_meta()

    def _prep_features_device(self):
        """Device-feats host prep: drain pool PCM into one padded batch
        destined for the fused tick program (which runs MFCC and writes
        the rows into the device feature ring at per-lane offsets — no
        feature bytes ever return to host). Returns (pcm_batch, counts,
        has_new) — counts are the PRE-increment write offsets — or None
        when no lane has new audio. ``_feat_counts`` is advanced here so
        the readiness loop that follows sees the post-write frame
        counts.

        Fast path (native runtime): ONE rss_pool_snapshot + ONE
        rss_pool_read_all per tick drain every lane straight into the
        padded batch rows (after each lane's frame-remainder tail, which
        the host re-reads from the row afterwards) — replacing per-lane
        read calls, per-lane int16-exactness rescans (the pool tracks
        exactness at feed time), and per-lane row fills. Measured 5x less
        host time per tick at 256 lanes. ``self._fin_snap`` caches the
        snapshot's finished flags so the readiness/flush loops don't make
        per-lane pool calls either."""
        pool = self.pool
        if not getattr(pool, "has_batched_drain", False):
            return self._prep_features_device_slow()
        fz = self._featurizer
        N = self.max_streams
        counts, finished, exact = pool.snapshot()
        self._fin_snap = finished
        drain = np.zeros(N, dtype=np.int64)
        offs = np.zeros(N, dtype=np.int64)
        for sid, state in enumerate(self.slots):
            if state.active and not state.done and counts[sid] > 0:
                off = state.feat_state.mfcc_tail.shape[0]
                # cap the per-tick drain so tail+new stays within the
                # largest PCM bucket (see _DRAIN_CAP); the remainder
                # drains next tick
                drain[sid] = min(int(counts[sid]), self._drain_cap - off)
                offs[sid] = off
                if drain[sid] < counts[sid]:
                    self._pending_drain = True
        prep = None
        sel = drain > 0
        if sel.any():
            # quarantine pass BEFORE touching the pool: a lane whose next
            # rows would overflow the device feature ring is force-
            # finalized (drain skipped) instead of raising out of the
            # shared tick and killing every other in-flight lane
            buf_lens = offs + drain
            frame_len, shift = fz.frame_len, fz.frame_shift
            n_rows = max(
                0,
                1
                + (
                    _pcm_bucket(int(buf_lens.max()), self._drain_cap)
                    - frame_len
                )
                // shift,
            )
            limit = self._feat_ring_frames - n_rows
            for sid in np.nonzero(sel)[0]:
                bl = int(buf_lens[sid])
                n = 1 + (bl - frame_len) // shift if bl >= frame_len else 0
                if self._feat_counts[sid] + n > limit:
                    self._quarantine(
                        sid, "feature ring", self._feat_ring_frames
                    )
                    drain[sid] = 0
                    sel[sid] = False
        if sel.any():
            buf_lens = offs + drain
            max_len = _pcm_bucket(int(buf_lens.max()), self._drain_cap)
            exact_all = bool(exact[sel].all())
            if self._wire_mulaw:
                # 8-bit wire: samples are G.711-encoded (native encode
                # inside read_into; frame-tail floats re-encode to the
                # same codeword values — ops/mulaw.py stability contract)
                dtype = np.uint8
            else:
                dtype = np.int16 if exact_all else np.float32
            frame_len, shift = fz.frame_len, fz.frame_shift
            samples = None
            if self._wire_adpcm:
                # 4-bit wire: drain f32 samples first, then block-encode
                # into the upload batch in one native call (recon lands
                # in place over `samples` — the tail carry reads it)
                from ..ops.adpcm import block_bytes

                samples = np.zeros((N, max_len), dtype=np.float32)
                nbm = max_len // shift
                batch = np.zeros(
                    (N, nbm * block_bytes(shift) + self._meta_cols),
                    dtype=np.uint8,
                )
                wire_w = nbm * block_bytes(shift)
            else:
                # +TC trailing columns: the meta pack rides the same
                # upload (written by _step_fused/_feed_only_dispatch;
                # buf_lens <= max_len so audio never clashes with them)
                batch = np.zeros(
                    (N, max_len + self._meta_cols), dtype=dtype
                )
            new_frames = np.zeros(N, dtype=np.int64)
            lanes = np.nonzero(sel)[0]
            for sid in lanes:
                tail = self.slots[sid].feat_state.mfcc_tail
                if tail.shape[0]:
                    if self._wire_adpcm:
                        samples[sid, : tail.shape[0]] = tail
                    elif self._wire_mulaw:
                        from ..ops.mulaw import encode_f32

                        batch[sid, : tail.shape[0]] = encode_f32(tail)
                    else:
                        batch[sid, : tail.shape[0]] = (
                            tail.astype(np.int16) if exact_all else tail
                        )
                bl = int(buf_lens[sid])
                n = 1 + (bl - frame_len) // shift if bl >= frame_len else 0
                new_frames[sid] = n
            if self._wire_adpcm:
                from ..native.runtime import adpcm_encode_into

                pool.read_into(samples, offs, drain)
                adpcm_encode_into(
                    samples,
                    np.where(sel, buf_lens, 0),
                    shift,
                    batch[:, :wire_w],
                )
            else:
                pool.read_into(batch, offs, drain)
            has_new = sel & (new_frames > 0)
            if has_new.any():
                prep = (
                    batch,
                    self._feat_counts.copy(),
                    np.ascontiguousarray(has_new),
                )
                if self._pitch_device:
                    # samples present in the device PCM ring after this
                    # upload lands (masked lanes keep their old total:
                    # their drained samples live on in mfcc_tail and ride
                    # the NEXT upload's tail prefix)
                    self._pcm_total[has_new] = (
                        self._feat_counts.astype(np.int64)[has_new] * shift
                        + buf_lens[has_new]
                    )
            for sid in lanes:
                n = int(new_frames[sid])
                if self._wire_adpcm:
                    # carry the RECONSTRUCTED tail (the encoder wrote
                    # recon in place over `samples`): the device saw
                    # these exact values, and re-encoding reconstructions
                    # at the same absolute block positions reproduces
                    # them — features across the frame overlap never
                    # drift (ops/adpcm.py stability contract)
                    self.slots[sid].feat_state.mfcc_tail = samples[
                        sid, n * shift : int(buf_lens[sid])
                    ].copy()
                    self._feat_counts[sid] += n
                    continue
                row_tail = batch[sid, n * shift : int(buf_lens[sid])]
                if self._wire_mulaw:
                    # carry the DECODED tail: the device saw decode(b)
                    # for these samples, and next tick's re-encode maps
                    # decode(b) back to the same value — features across
                    # the frame overlap never drift
                    from ..ops.mulaw import decode_u8

                    self.slots[sid].feat_state.mfcc_tail = decode_u8(
                        row_tail
                    )
                else:
                    self.slots[sid].feat_state.mfcc_tail = (
                        row_tail.astype(np.float32)
                        if exact_all
                        else row_tail.copy()
                    )
                self._feat_counts[sid] += n
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and not state.flushed_feats
                and finished[sid]
                and drain[sid] == counts[sid]
            ):
                # everything available was drained this tick (no capped
                # leftover), so a finished lane's featurizer input is
                # complete
                state.flushed_feats = True
        return prep

    def _prep_features_device_slow(self):
        """Per-lane fallback drain (NumPy StreamPool without the native
        batched-drain entry points). Same contract as
        _prep_features_device."""
        fz = self._featurizer
        with_buf = []  # (sid, buf, n)
        for sid, state in enumerate(self.slots):
            if not state.active or state.done:
                continue
            avail = self.pool.available(sid)
            if avail <= 0:
                continue
            cap = self._drain_cap - state.feat_state.mfcc_tail.shape[0]
            if avail > cap:
                self._pending_drain = True
            pcm = self.pool.read(sid, min(avail, cap))
            r = fz.prepare_mfcc_buf(state.feat_state, pcm)
            if r is not None:
                with_buf.append((sid, *r))
        prep = None
        if with_buf:
            # quarantine overlong lanes instead of raising out of the
            # shared tick (their PCM already left the pool; the lane is
            # force-finalized, so dropping the overflow audio is the
            # quarantine semantics)
            max_len = _pcm_bucket(
                max(b.shape[0] for _, b, _ in with_buf), self._drain_cap
            )
            n_rows = 1 + (max_len - fz.frame_len) // fz.frame_shift
            limit = self._feat_ring_frames - n_rows
            keep = []
            for sid, buf, n in with_buf:
                if self._feat_counts[sid] + n > limit:
                    self._quarantine(
                        sid, "feature ring", self._feat_ring_frames
                    )
                else:
                    keep.append((sid, buf, n))
            with_buf = keep
        if with_buf:
            max_len = _pcm_bucket(
                max(b.shape[0] for _, b, _ in with_buf), self._drain_cap
            )
            # PCM is int16 at the wire; when every sample round-trips
            # exactly, upload half the bytes and widen on device
            exact_i16 = all(
                np.all(buf == np.round(buf))
                and np.all(np.abs(buf) <= 32767)
                for _sid, buf, _n in with_buf
            )
            if self._wire_adpcm:
                # 4-bit wire, fallback drain: assemble the f32 sample
                # batch and block-encode it. The tail carried below by
                # commit_mfcc is the ORIGINAL samples; encoding is a
                # pure causal function of the (block-aligned) buffer, so
                # re-encoding the same originals next tick reproduces
                # the same wire bytes and decoded values.
                from ..native.runtime import adpcm_encode_into
                from ..ops.adpcm import block_bytes

                shift = fz.frame_shift
                samples = np.zeros(
                    (self.max_streams, max_len), dtype=np.float32
                )
                lens = np.zeros(self.max_streams, dtype=np.int64)
                for sid, buf, _n in with_buf:
                    samples[sid, : buf.shape[0]] = buf
                    lens[sid] = buf.shape[0]
                wire_w = (max_len // shift) * block_bytes(shift)
                batch = np.zeros(
                    (self.max_streams, wire_w + self._meta_cols),
                    dtype=np.uint8,
                )
                adpcm_encode_into(samples, lens, shift, batch[:, :wire_w])
            elif self._wire_mulaw:
                batch = np.zeros(
                    (self.max_streams, max_len + self._meta_cols),
                    dtype=np.uint8,
                )
                from ..ops.mulaw import encode_f32

                for sid, buf, _n in with_buf:
                    batch[sid, : buf.shape[0]] = encode_f32(buf)
            else:
                dtype = np.int16 if exact_i16 else np.float32
                batch = np.zeros(
                    (self.max_streams, max_len + self._meta_cols),
                    dtype=dtype,
                )
                for sid, buf, _n in with_buf:
                    batch[sid, : buf.shape[0]] = (
                        buf.astype(np.int16) if exact_i16 else buf
                    )
            has_new = np.zeros(self.max_streams, dtype=bool)
            for sid, buf, _n in with_buf:
                has_new[sid] = True
                if self._pitch_device:
                    self._pcm_total[sid] = (
                        int(self._feat_counts[sid]) * fz.frame_shift
                        + buf.shape[0]
                    )
            # A COPY of the persistent counts: device_put of a host array
            # can be zero-copy (the program reads the numpy memory when it
            # executes, asynchronously), and _feat_counts is mutated right
            # below (+= n) and by close()'s reset — a dispatch that lags
            # under load would read post-mutation offsets and write
            # feature rows to the wrong ring positions (observed: rare
            # wrong transcripts under CPU contention).
            prep = (batch, self._feat_counts.copy(), has_new)
            for sid, buf, n in with_buf:
                self._feat_counts[sid] += n
                fz.commit_mfcc(self.slots[sid].feat_state, buf, n)
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and not state.flushed_feats
                and self.pool.is_finished(sid)
                and self.pool.available(sid) <= 0
            ):
                state.flushed_feats = True
        return prep

    def _drain_features_all(self) -> None:
        """Move pool PCM into per-slot feature buffers — ONE padded batched
        base-MFCC call per tick for every slot with new audio, plus (for
        pitch models) ONE batched fixed-window pitch call. (Device-feats
        mode doesn't come here: step() preps the PCM batch host-side and
        the fused tick program does the MFCC + ring write.)"""
        fz = self._featurizer
        pushed = []  # (sid, pcm, buf_or_None, n_frames)
        for sid, state in enumerate(self.slots):
            if not state.active or state.done:
                continue
            avail = self.pool.available(sid)
            if avail <= 0:
                continue
            pcm = self.pool.read(sid, avail)
            r = fz.prepare_mfcc_buf(state.feat_state, pcm)
            pushed.append((sid, pcm, *(r if r is not None else (None, 0))))
        base_rows = {}
        with_buf = [(sid, buf, n) for sid, _p, buf, n in pushed if buf is not None]
        if with_buf:
            # stable compiled shapes: fixed row count, 0.1 s length buckets
            # (steady streaming feeds chunk-sized pushes; coarse buckets
            # would pad the H2D transfer several-fold)
            max_len = max(b.shape[0] for _, b, _ in with_buf)
            max_len = -(-max_len // 1600) * 1600
            batch = np.zeros((self.max_streams, max_len), dtype=np.float32)
            for i, (_sid, buf, _n) in enumerate(with_buf):
                batch[i, : buf.shape[0]] = buf
            self.device_dispatches += 1
            # fz.stream_params: with snip_edges=false the buffers are in
            # VIRTUAL-signal space and need snip=true framing
            feats = np.asarray(
                mfcc_batch(fz.stream_params, jnp.asarray(batch))
            )
            for i, (sid, buf, n) in enumerate(with_buf):
                base_rows[sid] = feats[i, :n]
                fz.commit_mfcc(self.slots[sid].feat_state, buf, n)
        for sid, pcm, _buf, _n in pushed:
            state = self.slots[sid]
            rows = fz.push_with_base(
                state.feat_state,
                pcm,
                base_rows.get(
                    sid, np.zeros((0, fz.num_ceps), dtype=np.float32)
                ),
            )
            if rows.shape[0]:
                state.feats = np.concatenate([state.feats, rows], axis=0)
        if fz.has_pitch:
            self._drain_pitch_all()
        # finished streams: flush the featurizer tail once (pitch models
        # repeat the last pitch row over any unmatched MFCC tail)
        for sid, state in enumerate(self.slots):
            if (
                state.active
                and not state.done
                and not state.flushed_feats
                and self.pool.is_finished(sid)
                and self.pool.available(sid) <= 0
            ):
                rows = fz.push(
                    state.feat_state, np.zeros(0, np.float32), flush=True
                )
                if rows.shape[0]:
                    state.feats = np.concatenate(
                        [state.feats, rows], axis=0
                    )
                state.flushed_feats = True

    def _drain_pitch_all(self) -> None:
        """Batched pitch over fixed-size windows for every slot with
        unmatched MFCC rows."""
        from ..ops.pitch import pitch_batch

        fz = self._featurizer
        want = []  # (sid, window)
        for sid, state in enumerate(self.slots):
            if not state.active or state.done:
                continue
            if state.feat_state.mfcc_pending.shape[0] == 0:
                continue
            window = fz.pitch_window_array(state.feat_state)
            if window is not None:
                want.append((sid, window))
        if not want:
            return
        batch = np.stack([w for _s, w in want])
        self.device_dispatches += 1
        rows = np.asarray(
            pitch_batch(self.am.pitch_config, jnp.asarray(batch))
        )
        for i, (sid, _w) in enumerate(want):
            state = self.slots[sid]
            new = fz.consume_pitch_rows(state.feat_state, rows[i])
            out = fz.merge_pitch(state.feat_state, new)
            if out.shape[0]:
                state.feats = np.concatenate([state.feats, out], axis=0)

    def step(self) -> int:
        """One scheduling tick: run the batched chunk program over every
        slot with work. Returns the number of active chunk lanes."""
        metrics = get_metrics()
        N = self.max_streams
        W = self._win_hi - self._win_lo
        D = self._featurizer.feat_dim
        device_feats = self._device_feats
        windows = (
            np.zeros((N, 1, 1), dtype=np.float32)  # lane-dim dummy (mesh)
            if device_feats
            else np.zeros((N, W, D), dtype=np.float32)
        )
        n_valid = np.zeros(N, dtype=np.int32)
        chunk_t0 = np.zeros(N, dtype=np.int64)
        chunk_have = np.zeros(N, dtype=np.int64)
        flushed: List[int] = []

        if self._pending_finalize:
            with StageTimer("stream_finalize", metrics):
                # Non-blocking: assemble only finalize traces whose async
                # D2H copy has landed; the rest stay pending (poll()
                # forces them). Steady-state ticks never wait on the
                # device.
                self._harvest_finalizes(block=False)
        prep = None
        self._pending_drain = False
        self._tick_packed = None
        self._tick_packed_fetch = None
        with StageTimer("stream_features", metrics):
            if device_feats:
                prep = self._prep_features_device()
            else:
                self._drain_features_all()
        pitch_matched = self._plan_pitch() if device_feats else None
        # device endpoint lane: apply the PREVIOUS tick's landed signal
        # stats (detection lags one chunk; never blocks on the device)
        with StageTimer("stream_ep_apply", metrics):
            ep_fired: Set[int] = (
                self._apply_endpoint_stats()
                if self._ep_device and self._ep_stats_pending
                else set()
            )
        with StageTimer("stream_ready", metrics):
            for sid, state in enumerate(self.slots):
                if not state.active or state.done:
                    continue
                if sid in self._quarantined:
                    # ring-capacity quarantine (see _quarantine): finalize
                    # with whatever decoded so far, keep the tick alive
                    flushed.append(sid)
                    continue
                if sid in ep_fired:
                    _LOGGER.debug("endpoint fired for stream %d", sid)
                    flushed.append(sid)
                    continue
                t0 = state.frames_consumed
                if device_feats:
                    # pitch models: rows past the pitch-matched count are
                    # MFCC-only (their pitch columns are scratch) — not
                    # yet consumable
                    have = (
                        int(pitch_matched[sid])
                        if pitch_matched is not None
                        else int(self._feat_counts[sid])
                    )
                else:
                    have = state.feats.shape[0]
                finished = (
                    bool(self._fin_snap[sid])
                    if device_feats and self._fin_snap is not None
                    else self.pool.is_finished(sid)
                )
                ready = have >= t0 + self._chunk_in + max(
                    self._win_hi - self._chunk_in, 0
                )
                if not ready and not (
                    finished and state.flushed_feats and t0 < have
                ):
                    if finished and state.flushed_feats and t0 >= have:
                        flushed.append(sid)
                    continue
                if not device_feats:
                    idx = np.clip(
                        np.arange(t0 + self._win_lo, t0 + self._win_hi), 0,
                        max(have - 1, 0),
                    )
                    windows[sid] = state.feats[idx]
                real_out = min(
                    self._chunk_out,
                    max(0, -(-(have - t0) // self.am.subsampling)),
                )
                if not finished:
                    real_out = self._chunk_out  # full chunk by `ready`
                if (
                    self._device_bp
                    and state.out_frames + real_out > self._ring_frames
                ):
                    # The device bp ring is sized from the pool capacity
                    # (it bounds un-consumed audio, not stream length); a
                    # stream decoded past it would clamp-overwrite its
                    # newest trace rows and finalize to a silently wrong
                    # transcript. Quarantine the lane (loud log + error,
                    # finalize with the frames decoded so far) — mirrors
                    # the feature-ring guard; raising here would abort
                    # every other lane's tick.
                    self._quarantine(
                        sid, "backpointer ring", self._ring_frames
                    )
                    flushed.append(sid)
                    continue
                n_valid[sid] = real_out
                chunk_t0[sid] = t0
                chunk_have[sid] = have

        lanes = int((n_valid > 0).sum())
        if device_feats:
            if lanes:
                self._step_fused(
                    prep, n_valid, chunk_t0, chunk_have, flushed, metrics
                )
            elif prep is not None:
                # no decode-ready lane: write the feature ring only —
                # dispatching the whole fused (AM + decode) program for a
                # masked no-op would waste device work on every
                # features-only tick of a dribble-fed stream
                self._feed_only_dispatch(prep, metrics)
        elif lanes:
            win_shape = self._iv_win_shape
            if self._iv_inline:
                iv_wins = None  # carried on device
            else:
                iv_wins = np.stack(
                    [
                        s.iv_pending_win
                        if s.iv_pending_win is not None
                        and s.iv_pending_win.shape == win_shape
                        else np.zeros(win_shape, np.float32)
                        for s in self.slots
                    ]
                )
            iv_ws = np.stack(
                [
                    s.iv_pending_w
                    if s.iv_pending_w is not None
                    else np.zeros(self._chunk_in, np.float32)
                    for s in self.slots
                ]
            )
            reset = self._pending_reset.copy()
            with StageTimer("stream_chunk", metrics):
                if self._lane_spec is not None:
                    # shard host->devices directly: no device-0 staging copy
                    win_dev = jax.device_put(windows, self._lane_spec(windows))
                    nv_dev = jax.device_put(n_valid, self._lane_spec(n_valid))
                    rs_dev = jax.device_put(reset, self._lane_spec(reset))
                    ivs_dev = jax.device_put(iv_ws, self._lane_spec(iv_ws))
                    ivw_dev = (
                        self._iv_carry
                        if self._iv_inline
                        else jax.device_put(iv_wins, self._lane_spec(iv_wins))
                    )
                else:
                    win_dev = jnp.asarray(windows)
                    nv_dev = jnp.asarray(n_valid)
                    rs_dev = jnp.asarray(reset)
                    ivs_dev = jnp.asarray(iv_ws)
                    ivw_dev = (
                        self._iv_carry
                        if self._iv_inline
                        else jnp.asarray(iv_wins)
                    )
                t0s = chunk_t0.astype(np.int32)
                haves = chunk_have.astype(np.int32)
                if self._lane_spec is not None:
                    t0_dev = jax.device_put(t0s, self._lane_spec(t0s))
                    hv_dev = jax.device_put(haves, self._lane_spec(haves))
                else:
                    t0_dev = jnp.asarray(t0s)
                    hv_dev = jnp.asarray(haves)
                self.device_dispatches += 1
                (
                    alpha, bps, gamma, X, am_state, ring, offs, iv_carry,
                    packed, sw_w,
                ) = self._batch_chunk(
                    self._alpha, win_dev, nv_dev, rs_dev,
                    self._iv_gamma, self._iv_X,
                    ivw_dev, ivs_dev,
                    self._am_state,
                    self._ring, self._offs,
                    self._feats_ring, t0_dev, hv_dev,
                    self._sw_w, self._cum_ring,
                )
                self._pending_reset[:] = False
                self._alpha = alpha
                self._am_state = am_state
                self._iv_gamma, self._iv_X = gamma, X
                self._ring, self._offs = ring, offs
                if self._device_bp:
                    self._tick_packed = packed
                if self._iv_inline:
                    self._iv_carry = iv_carry
                if self._ep_device:
                    fetch = _AsyncFetch(packed)
                    self._tick_packed_fetch = fetch
                    self._ep_tick_stats = _PackedStatsFetch(fetch)
                else:
                    self._ep_tick_stats = None
                if self._sw_device:
                    self._sw_w = sw_w
                tick_bps = None
                if not self._device_bp:
                    self._alpha_host = _TickBps(alpha)
                    # [7, N, S]: copied device->host asynchronously;
                    # nothing blocks on it unless endpointing / silence
                    # weighting (or a finalize) needs the frames this tick
                    tick_bps = _TickBps(bps, self._bp_compact)
                    # bound device residency: materialize ticks a few
                    # steps old (their async copy has landed) so long
                    # utterances don't pile [7, N, S] buffers up in HBM;
                    # then demote every slot's reference to its own [k, S]
                    # slice so the full [chunk, N, S] host tensor is freed
                    # (a slot's entry for the popped tick is among its last
                    # few — one append per global tick at most)
                    self._tick_ring.append(tick_bps)
                    if len(self._tick_ring) > 4:
                        old = self._tick_ring.pop(0)
                        arr = old.force()
                        for sid2, st2 in enumerate(self.slots):
                            for j in range(
                                len(st2.bps) - 1,
                                max(len(st2.bps) - 7, -1),
                                -1,
                            ):
                                e = st2.bps[j]
                                if isinstance(e, tuple) and e[0] is old:
                                    st2.bps[j] = np.ascontiguousarray(
                                        arr[: e[1], sid2]
                                    )
                                    break
            if self._ivp is not None:
                # everything passed this tick was folded into gamma/X —
                # clear so nothing is double-counted next tick
                for s in self.slots:
                    if s.iv_pending_w is not None:
                        s.iv_pending_w = np.zeros(self._chunk_in, np.float32)
            need_alpha = (
                self.endpointing is not None and not self._ep_device
            ) or (self.silence_weight is not None and self._ivp is not None)
            alpha_np = self._alpha_host.force() if need_alpha else None
            for sid, state in enumerate(self.slots):
                k = int(n_valid[sid])
                if k <= 0:
                    continue
                if tick_bps is not None:
                    state.bps.append((tick_bps, k))
                state.out_frames += k
                if self._ivp is not None:
                    if self._iv_inline:
                        # window carried on device; only the valid-frame
                        # weights for the next tick's fold come from host
                        t0 = int(chunk_t0[sid])
                        t_end = min(t0 + self._chunk_in, int(chunk_have[sid]))
                        state.iv_pending_w = (
                            np.arange(t0, t0 + self._chunk_in) < t_end
                        ).astype(np.float32)
                    else:
                        self._stage_ivector_stats(
                            sid,
                            int(chunk_t0[sid]),
                            int(chunk_have[sid]),
                            tick_bps,
                            k,
                            alpha_np[sid] if alpha_np is not None else None,
                        )
                state.frames_consumed += self._chunk_in
                have_now = (
                    int(self._feat_counts[sid])
                    if device_feats
                    else state.feats.shape[0]
                )
                if (
                    self.pool.is_finished(sid)
                    and state.flushed_feats
                    and state.frames_consumed >= have_now
                ):
                    flushed.append(sid)
                elif (
                    self.endpointing is not None
                    and not self._ep_device
                    and self._check_endpoint(sid, alpha_np[sid])
                ):
                    _LOGGER.debug("endpoint fired for stream %d", sid)
                    flushed.append(sid)
            if self._ep_device and self._ep_tick_stats is not None:
                # applied on a later tick, guarded by slot generation
                self._ep_stats_pending.append((
                    self._ep_tick_stats,
                    [s.gen for s in self.slots],
                    np.array(
                        [s.out_frames for s in self.slots], dtype=np.int64
                    ),
                ))
                self._ep_tick_stats = None

        with StageTimer("stream_finalize", metrics):
            if self._device_bp:
                self._finalize_device(flushed)
            else:
                for sid in flushed:
                    self._finalize(sid)
        return lanes

    def run_until_idle(self, max_steps: int = 10000) -> None:
        """Step until no lane has work. Streams stalled on more PCM (or
        an endpoint) also stop the loop — callers drive ticks as audio
        arrives. Capped drains (burst-fed lanes with pool leftover) keep
        the loop going until everything owned by the scheduler is
        consumed."""
        for _ in range(max_steps):
            if self.step() == 0 and not self._pending_drain:
                return

    def _stage_ivector_stats(
        self,
        sid: int,
        t0: int,
        have: int,
        tick_bps: _TickBps,
        k: int,
        alpha_row: Optional[np.ndarray],
    ) -> None:
        """Prepare this slot's chunk (window, weights) for the next tick's
        stats fold (see pipeline/stream.py for the single-stream twin)."""
        from .streaming_features import (
            silence_weights_from_chunk,
            stage_ivector_window,
        )

        state = self.slots[sid]
        ivp = self._ivp
        num_ceps = self.am.frontend_config.num_ceps
        win, w = stage_ivector_window(
            state.feats[:, :num_ceps],
            t0,
            self._chunk_in,
            have,
            ivp.splice_left,
            ivp.splice_right,
            getattr(self.am, "ivector_cmvn_stats", None),
        )
        if (
            self.silence_weight is not None
            and self.silence_weight != 1.0
            and alpha_row is not None
            and self._silence_pdfs
        ):
            flags = silence_weights_from_chunk(
                tick_bps.force()[:k, sid],
                alpha_row,
                self.graph.arc_pdf,
                self.graph.arc_src,
                np.fromiter(self._silence_pdfs, dtype=np.int64),
            )
            if flags is not None and flags.shape[0]:
                sub = self.am.subsampling
                out_idx = np.minimum(
                    np.arange(self._chunk_in) // sub, flags.shape[0] - 1
                )
                w = np.where(
                    flags[out_idx], w * float(self.silence_weight), w
                )
        state.iv_pending_win = win
        state.iv_pending_w = w

    def _apply_endpoint_stats(self) -> Set[int]:
        """Evaluate the endpoint rules against the NEWEST LANDED tick's
        device-computed [N, 3] signals (trailing-silence frames,
        contains-nonsilence, relative final cost). Slots recycled since
        the stats were computed are skipped via the generation guard.

        Entries queue per tick; with the pipeline-depth pacing the entry
        from ``depth`` ticks back has always completed, so in steady
        state this finds landed stats WITHOUT ever blocking — endpoint
        detection lags ~depth chunks instead of the host serializing
        against the device queue (lag-1 + forced join measured 55-228
        ms/tick at 512 lanes across rounds 4-5; the pre-queue designs'
        history is in git). ``_ep_stats_deferred`` counts CONSECUTIVE
        empty applies and forces a blocking join on the oldest entry
        past depth+2 — no endpoint starvation into the ring quarantine,
        and the forced join is ~free because pacing already retired that
        tick's program. The fetch worker itself performs the read, so
        every backend — including ones where nothing lands without an
        explicit read (the 8-virtual-device CPU mesh) — converges
        without the tick loop blocking."""
        pending = self._ep_stats_pending
        newest = None
        for i in range(len(pending) - 1, -1, -1):
            f = pending[i][0]
            if not hasattr(f, "ready") or f.ready():
                newest = i
                break
        if newest is None:
            if pending and self._ep_stats_deferred >= self._pipeline_depth + 2:
                newest = 0  # forced blocking join on the oldest
            else:
                self._ep_stats_deferred += 1
                return set()
        stats_fetch, gens, out_snap = pending[newest]
        for _ in range(newest + 1):
            pending.popleft()
        if hasattr(stats_fetch, "get"):
            stats = stats_fetch.get(block=True)
        else:  # pragma: no cover - direct numpy in unit tests
            stats = np.asarray(stats_fetch)
        self._ep_stats_deferred = 0
        fired: Set[int] = set()
        out_frame_sec = self.am.subsampling * self._frame_shift / 16000.0
        for sid, state in enumerate(self.slots):
            if (
                not state.active
                or state.done
                or state.gen != gens[sid]
                or out_snap[sid] <= 0
            ):
                continue
            if self.endpointing.should_endpoint(
                contains_nonsilence=bool(stats[sid, 1] > 0.5),
                trailing_silence=float(stats[sid, 0]) * out_frame_sec,
                relative_cost=float(stats[sid, 2]),
                utterance_length=float(out_snap[sid]) * out_frame_sec,
            ):
                fired.add(sid)
        return fired

    def _check_endpoint(self, sid: int, alpha_row: np.ndarray) -> bool:
        """Evaluate the endpoint rules for one stream after a chunk."""
        from .endpoint import trailing_silence_frames

        state = self.slots[sid]
        totals = alpha_row + self.graph.final_weight
        best_final = float(totals.min())
        best_any = float(alpha_row.min())
        if best_final < 1.0e29:
            relative_cost = best_final - best_any
            best_state = int(np.argmin(totals))
        else:
            relative_cost = float("inf")
            best_state = int(np.argmin(alpha_row))
        trailing, nonsil = trailing_silence_frames(
            state.bp_chunks(sid), best_state,
            self.graph.arc_pdf, self.graph.arc_src,
            self._silence_pdfs,
        )
        out_frame_sec = self.am.subsampling * self._frame_shift / 16000.0
        return self.endpointing.should_endpoint(
            contains_nonsilence=nonsil,
            trailing_silence=trailing * out_frame_sec,
            relative_cost=relative_cost,
            utterance_length=state.out_frames * out_frame_sec,
        )

    # 32 lanes per finalize dispatch: through a remote-dispatch transport
    # each call costs a ~25 ms round trip regardless of size, and large
    # staggered serving fleets retire ~lanes/14 utterances per tick — one
    # dispatch instead of two at 256 lanes (device cost of the padding is
    # negligible next to the dispatch).
    _FINALIZE_BATCH = 32

    def _finalize_device(self, flushed: List[int]) -> None:
        """Device-ring finalize: dispatch one bucketed on-device backtrace
        per (up to) _FINALIZE_BATCH flushed lanes; results are harvested
        ASYNCHRONOUSLY (next tick, or on poll) so steady-state ticks don't
        block on the trace — only [F_max, steps] arc traces leave the
        chip."""
        todo = []
        for sid in flushed:
            state = self.slots[sid]
            if state.done:
                continue
            state.done = True
            get_metrics().add_audio(
                state.frames_consumed * self._frame_shift / 16000.0,
                utterances=1,
            )
            if state.out_frames <= 0:
                state.result = []
                continue
            todo.append(sid)

        if not todo:
            return
        if self._tick_packed is not None:
            # This tick's fused program already emitted every lane's
            # backtrace ([N, F + 8] packed u16 rows) — no separate
            # finalize dispatch, no cross-program ring handoff. Row
            # index == sid. When the endpoint lane already started the
            # tick's packed fetch, reuse it (one D2H per tick total).
            with StageTimer("stream_fin_trace", get_metrics()):
                frames = np.asarray(
                    [self.slots[s].out_frames for s in todo],
                    dtype=np.int32,
                )
                gens = [self.slots[s_].gen for s_ in todo]
                fetch = self._tick_packed_fetch or _AsyncFetch(
                    self._tick_packed
                )
                self._tick_packed_fetch = fetch
                self._pending_finalize.append(
                    (todo, gens, frames, fetch, list(todo), "u16")
                )
            return
        # no fused tick ran this step (drain-out / endpoint on an idle
        # lane): fall back to the standalone bucketed trace program
        for start in range(0, len(todo), self._FINALIZE_BATCH):
            group = todo[start : start + self._FINALIZE_BATCH]
            pad = self._FINALIZE_BATCH - len(group)
            fin_meta = np.zeros((self._FINALIZE_BATCH, 2), dtype=np.int32)
            fin_meta[: len(group), 0] = group
            fin_meta[len(group) :, 0] = group[0]
            frames = np.asarray(
                [self.slots[s].out_frames for s in group] + [0] * pad,
                dtype=np.int32,
            )
            fin_meta[:, 1] = frames
            # bucketed static scan length: short utterances don't pay a
            # full-ring-depth walk; one compiled program per bucket
            steps = 32
            top = int(frames.max())
            while steps < top:
                steps *= 2
            steps = min(steps, self._ring_frames)
            with StageTimer("stream_fin_trace", get_metrics()):
                packed = self._aot_call(
                    f"sched_fin{steps}",
                    lambda r, a, m, _s=steps: self._finalize_trace(
                        r, a, m, _s
                    ),
                    (self._ring, self._alpha, jnp.asarray(fin_meta)),
                )
            # start the (single, packed) background D2H now: the harvest
            # then reads landed data instead of paying a blocking round
            # trip
            gens = [self.slots[s_].gen for s_ in group]
            self._pending_finalize.append(
                (group, gens, frames, _AsyncFetch(packed),
                 list(range(len(group))), "i32")
            )

    def _harvest_finalizes(self, block: bool = True) -> None:
        """Assemble words for dispatched finalize traces. With
        ``block=False`` only traces whose background D2H copy has landed
        are assembled; the rest stay pending — the serving tick never
        waits on the device, and ``poll()`` forces the remainder."""
        graph = self.graph
        pending, self._pending_finalize = self._pending_finalize, []
        for entry in pending:
            group, gens, frames, packed_d, rows, fmt = entry
            if isinstance(packed_d, _AsyncFetch):
                with StageTimer("stream_fin_wait", get_metrics()):
                    packed = packed_d.get(block=block)
                if packed is None:
                    self._pending_finalize.append(entry)
                    continue
            else:  # pragma: no cover - direct numpy in unit tests
                with StageTimer("stream_fin_wait", get_metrics()):
                    packed = np.asarray(packed_d)
            if fmt == "u16":
                # fused-tick packed rows: u16 arc trace (emit + 2) +
                # _PACKED_STAT_COLS stat columns
                F = packed.shape[1] - _PACKED_STAT_COLS
                arcs = packed[:, :F].astype(np.int32) - 2
                fstates = packed[:, F].astype(np.int32)
                dead = packed[:, F + 1] == 0
            else:
                # standalone finalize-trace program: i32 arcs + final
                # state + f32 cost bits
                arcs = packed[:, :-2]
                fstates = packed[:, -2]
                costs = packed[:, -1:].view(np.float32)[:, 0]
                dead = costs >= 1.0e29
            for i, sid in enumerate(group):
                state = self.slots[sid]
                r = rows[i]
                res: Optional[List[str]] = None
                if dead[r]:
                    res = []
                else:
                    trace = arcs[r, : frames[i]]
                    if (trace == -1).any():
                        res = []
                if res is None:
                    real = trace[trace >= 0]
                    if real.shape[0]:
                        first_state = int(graph.arc_src[real[0]])
                    else:
                        first_state = int(fstates[r])
                    words: List[int] = list(
                        graph.words_of(int(graph.init_wseq[first_state]))
                    )
                    wseqs = graph.arc_wseq[real]
                    for wid in wseqs[wseqs != 0]:
                        words.extend(graph.words_of(int(wid)))
                    words.extend(
                        graph.words_of(int(graph.final_wseq[int(fstates[r])]))
                    )
                    with StageTimer("stream_fin_words", get_metrics()):
                        res = self._words_to_result(words)
                if state.gen != gens[i]:
                    # slot was closed (and possibly recycled) while the
                    # trace was in flight: deliver to the retired store,
                    # redeemable by close()'s (sid, gen) ticket
                    self._retire((sid, gens[i]), res)
                else:
                    state.result = res

    _FUZZY_CACHE_MAX = 4096

    def _words_to_result(self, words: List[int]) -> List[str]:
        """Fuzzy tail + decode_meta shared by both finalize paths.

        The fuzzy compose against G.fuzzy is the priciest host step per
        retired utterance; results are memoized per word sequence (the
        batch path dedups identical hypotheses per batch the same way)."""
        key = tuple(words)
        cached = self._fuzzy_cache.get(key)
        if cached is not None:
            return list(cached)
        lang = self.fuzzy_lang
        result = None
        if lang.g_fuzzy is not None and self.max_fuzzy_cost is not None:
            fuzzy = get_fuzzy_text([words], lang.g_fuzzy, lang.words)
            if fuzzy is not None and fuzzy[1] <= self.max_fuzzy_cost:
                result = [decode_meta(fuzzy[0])]
        if result is None:
            text = []
            for wid in words:
                sym = self.artifacts.words.find_id(wid)
                if sym and sym not in ("<eps>", "#0", "<s>", "</s>"):
                    text.append(sym)
            result = [decode_meta(" ".join(text))]
        if len(self._fuzzy_cache) >= self._FUZZY_CACHE_MAX:
            self._fuzzy_cache.clear()
        self._fuzzy_cache[key] = result
        return list(result)

    def _finalize(self, sid: int) -> None:
        state = self.slots[sid]
        if state.done:
            return
        state.done = True
        metrics = get_metrics()
        metrics.add_audio(
            state.frames_consumed * self._frame_shift / 16000.0, utterances=1
        )
        if not state.bps:
            state.result = []
            return
        bp = np.concatenate(state.bp_chunks(sid), axis=0)[:, None, :]
        if self._alpha_host is not None:
            alpha = self._alpha_host.force()[sid][None, :]
        else:  # finalize before any tick ran (shouldn't happen with bps)
            alpha = np.asarray(self._alpha[sid])[None, :]
        words, _cost = backtrace_words(self.graph, alpha, bp, 0,
                                       num_frames=bp.shape[0])
        if words is None:
            state.result = []
            return
        state.result = self._words_to_result(words)
