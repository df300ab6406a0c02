#!/usr/bin/env python
"""Flagship benchmark: the reference's real serving shape on one GPU.

Configuration (everything the serving path runs is in the measured loop):

- grammar: the committed voice-assistant grammar
  (testing/flagship_grammar.py, 3,701 sentences) -> 3-gram ARPA G
  (Witten-Bell) -> LG -> context-window HCLG expansion through the
  triphone machinery (graph/context.py, N=3 / P=1 windows), built by
  testing.flagship.build_flagship_graph;
- acoustic model: TDNN-F chain net (hidden 768 x 9 layers, random weights
  = honest FLOPs) consuming 40-dim MFCC + a 100-dim i-vector, emitting
  NUM_PDFS (default 3072) posteriors per frame like a real chain model;
- i-vector extraction inside the jitted program: splice ±3 -> LDA
  280->40 -> 512-Gaussian UBM gselect(5) -> stats -> 100-dim solve;
- decode kernel chosen by the production select_decoder;
- host tail included per iteration: on-device backtrace transfer, word
  assembly, and the fuzzy compose against G.fuzzy (with the serving
  path's per-batch dedup).

Known-synthetic parts (no real model/lexicon is downloadable here):
letters-as-phonemes pronunciations, a context-independent decision tree
(the N=3 window expansion machinery still runs), random AM weights.

Reports BOTH operating points over a batch sweep:
  (a) peak sustainable xRT streams (throughput knee);
  (b) the largest swept batch meeting RTF < 0.1 — the north-star point
      (BASELINE.json: >= 100 streams/chip at RTF < 0.1).

Prints ONE JSON line; `value` is the north-star point (streams at
RTF < 0.1), extra keys carry the peak point, graph/model sizes and the
device (platform, device_kind, count). Exits non-zero without a GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

SECONDS = float(os.environ.get("BENCH_SECONDS", "3.0"))
ITERS = int(os.environ.get("BENCH_ITERS", "3"))
HIDDEN = int(os.environ.get("BENCH_HIDDEN", "768"))
LAYERS = int(os.environ.get("BENCH_LAYERS", "9"))
NUM_PDFS = int(os.environ.get("BENCH_PDFS", "3072"))
IVEC_DIM = int(os.environ.get("BENCH_IVEC_DIM", "100"))
UBM_GAUSS = int(os.environ.get("BENCH_UBM_GAUSS", "512"))
NBEST = int(os.environ.get("BENCH_NBEST", "1"))
# AM compute dtype. bfloat16 is the default operating point: transcripts
# are bit-equal to f32 on every parity test (tests/test_bf16.py) and
# decode costs stay f32 either way. BENCH_DTYPE=float32 runs the f32 AM
# (matmuls at Precision.HIGHEST) for comparison.
DTYPE = os.environ.get("BENCH_DTYPE", "bfloat16")
if DTYPE in ("float32", "f32"):
    DTYPE = ""
# Sweep: RTF<0.1 candidates first (small), then throughput candidates.
# Infeasible points (device memory exhausted by the [B, T, 3072]
# posterior tensor plus forward temps) are recorded, not fatal.
# BENCH_BATCHES="" skips the batch sweep entirely (streaming-only runs)
BATCHES = [
    int(b)
    for b in os.environ.get(
        "BENCH_BATCHES", "128,256,384,512,640,768,1024"
    ).split(",")
    if b.strip()
]


def build_ivector_params(num_ceps: int):
    from rhasspy_speech_tpu.io.ivector import DiagGmm, IvectorExtractor
    from rhasspy_speech_tpu.ops.ivector import (
        OnlineIvectorConfig,
        make_ivector_params,
    )

    rng = np.random.RandomState(7)
    splice = 3
    lda_out = num_ceps
    spliced_dim = num_ceps * (2 * splice + 1)

    means = rng.randn(UBM_GAUSS, lda_out) * 2.0
    variances = 0.5 + rng.rand(UBM_GAUSS, lda_out)
    weights = rng.dirichlet(np.ones(UBM_GAUSS))
    dubm = DiagGmm.from_means_vars(weights, means, variances)

    M = (rng.randn(UBM_GAUSS, lda_out, IVEC_DIM) * 0.1).astype(np.float32)
    sigma_inv = np.broadcast_to(
        np.eye(lda_out, dtype=np.float32), (UBM_GAUSS, lda_out, lda_out)
    ).copy()
    extractor = IvectorExtractor(
        w=np.zeros((0, 0), dtype=np.float32),
        w_vec=weights.astype(np.float32),
        M=M,
        sigma_inv=sigma_inv,
        prior_offset=4.0,
    )
    lda = (rng.randn(lda_out, spliced_dim + 1) * 0.05).astype(np.float32)
    cfg = OnlineIvectorConfig(splice_left=splice, splice_right=splice)
    return make_ivector_params(dubm, extractor, lda, cfg)


def streaming_bench(graph, g_fuzzy, lang, lanes_list):
    """Drive the REAL StreamScheduler (the product's serving shape) at the
    flagship config: chunked PCM arrival, i-vector stat carry, admissions/
    retirements, fuzzy tail. Reference shape: online2-cli-nnet3-decode-faster
    reading chunks from a pipe (online2-cli-nnet3-decode-faster.cc:139-153).

    Each tick advances every active lane one decode chunk (21 input frames
    = 0.21 s audio); per-chunk RTF = tick_wall / 0.21. Lanes finish a
    SECONDS-long utterance every ~14 ticks (staggered), then are finished,
    polled, closed, and reopened — the full lifecycle is in the loop.
    """
    import shutil
    import tempfile

    from rhasspy_speech_tpu.pipeline.artifacts import LangArtifacts
    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler
    from rhasspy_speech_tpu.testing.flagship import write_flagship_model_dir

    workdir = tempfile.mkdtemp(prefix="rstpu_bench_")
    try:
        max_phone = max(
            pid
            for (p, pid) in lang.phones
            if pid != 0 and not p.startswith("#")
        )
        model_dir = write_flagship_model_dir(
            os.path.join(workdir, "model"),
            num_pdfs=graph.num_pdfs,
            max_phone=max_phone,
            hidden_dim=HIDDEN,
            num_tdnnf_layers=LAYERS,
            ivector_dim=IVEC_DIM,
            ubm_gauss=UBM_GAUSS,
            # BENCH_IVEC_CMVN=1 benches the production i-vector config
            # (online CMVN on the tap, the device cum-ring path); default
            # off to keep the sweep comparable with earlier artifacts
            with_ivector_cmvn=os.environ.get("BENCH_IVEC_CMVN", "0") == "1",
        )
        graph_dir = os.path.join(workdir, "graph")
        LangArtifacts(
            words=lang.words, g_fuzzy=g_fuzzy, graph=graph, phones=lang.phones
        ).save(graph_dir)

        chunk_env = os.environ.get("BENCH_CHUNK_OUT", "auto")

        def pick_chunk_out(lanes: int) -> int:
            """Scale the decode chunk with lane count: every per-tick
            fixed cost (dispatch, host bookkeeping, forced stats
            joins) amortizes over 2-3x the audio. Endpoint detection lag
            grows to one chunk = 0.42/0.63 s — still far inside the
            reference's 5 s rule-1 default (online-endpoint.h:88-127)."""
            if chunk_env != "auto":
                return int(chunk_env)
            return 7 if lanes < 256 else (14 if lanes < 512 else 21)

        # Endpointing active by default (the product's serving shape):
        # rides the device endpoint lane — per-state trailing-silence DP
        # in the decode scan, rules applied to the previous tick's landed
        # [N, 3] stats. BENCH_ENDPOINT=0 disables.
        endpointing = None
        if os.environ.get("BENCH_ENDPOINT", "1") != "0":
            from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig

            endpointing = EndpointConfig()

        # Per-point wire format. The env default drives the whole sweep;
        # when that default is i16, extra points re-run the largest lane
        # count on the compressed wires (reported separately as
        # streaming_wire_point = the best of them, never as the
        # headline); the wires shrink the per-tick H2D bytes (mu-law
        # 1 B/sample, block-ADPCM ~0.52 B/sample).
        # BENCH_WIRE_EXTRA=0 skips them; BENCH_WIRE_EXTRA=mulaw (or
        # adpcm) captures just that one.
        env_wire = os.environ.get("BENCH_WIRE", "i16")
        plan = [(lanes, env_wire) for lanes in lanes_list]
        extra = os.environ.get("BENCH_WIRE_EXTRA", "1")
        if env_wire == "i16" and lanes_list and extra != "0":
            wires = ("mulaw", "adpcm") if extra == "1" else (extra,)
            plan.extend((max(lanes_list), w) for w in wires)

        points = []
        for lanes, wire in plan:
            try:
                chunk_out = pick_chunk_out(lanes)
                CHUNK = chunk_out * 3 * 160  # one decode chunk of audio
                chunk_sec = CHUNK / 16000.0
                utt_ticks = max(2, int(round(SECONDS * 16000 / CHUNK)))
                rng = np.random.RandomState(1)
                # int16 PCM, the real wire format: feeds take the native
                # widening path (no per-sample exactness scan) and the
                # tick uploads ride the half-width int16 PCM batch
                pcm_pool = [
                    np.round(1000.0 * rng.randn(CHUNK)).astype(np.int16)
                    for _ in range(16)
                ]
                # Streaming defaults to f32 (the casts around the
                # feature-ring windows can break the tick program's
                # fusion); BENCH_STREAM_DTYPE=bfloat16 measures bf16.
                sdtype = os.environ.get("BENCH_STREAM_DTYPE", "") or None
                sched = StreamScheduler(
                    model_dir, graph_dir, max_streams=lanes,
                    max_fuzzy_cost=1.0,
                    pool_capacity_samples=int(16000 * (SECONDS + 2)),
                    chunk_out_frames=chunk_out,
                    compute_dtype=sdtype,
                    endpointing=endpointing,
                    wire=wire,
                )
                if endpointing is not None and not sched._ep_device:
                    # SystemExit passes the generic `except Exception`
                    # infeasible handler AND the enclosing finally (temp
                    # workdir cleanup): a config regression kills the run
                    # instead of filling the artifact with null points
                    sys.stderr.write(
                        "bench: endpointing fell off the device lane\n"
                    )
                    raise SystemExit(3)
                remaining = np.zeros(lanes, dtype=np.int64)
                for sid_expect in range(lanes):
                    sid = sched.open_stream()
                    assert sid >= 0
                    # stagger retirements across the utterance length
                    remaining[sid] = utt_ticks - (sid % utt_ticks)
                    sched.feed(sid, pcm_pool[sid % len(pcm_pool)])
                    sched.feed(sid, pcm_pool[(sid + 1) % len(pcm_pool)])

                completed = 0
                harvested = 0
                tickets = []

                pool_mat = np.stack(pcm_pool)  # [16, CHUNK] int16

                def tick(i):
                    nonlocal completed, harvested
                    from rhasspy_speech_tpu.utils.metrics import StageTimer

                    with StageTimer("stream_feed"):
                        feed_sids = []
                        to_finish = []
                        for sid in range(lanes):
                            st = sched.slots[sid]
                            if st.done:
                                # Recycle the lane IMMEDIATELY: close()
                                # returns a ticket; the word assembly +
                                # fuzzy tail happen when the async trace
                                # lands (take_result below, still inside
                                # the measured loop). Waiting here for the
                                # result before reopening idled every
                                # retiring lane 1-2 ticks (~20% of
                                # lane-ticks at 512 lanes).
                                tickets.append(sched.close(sid))
                                completed += 1
                                nsid = sched.open_stream()
                                remaining[nsid] = utt_ticks
                                sched.feed(nsid, pcm_pool[i % len(pcm_pool)])
                                sched.feed(
                                    nsid, pcm_pool[(i + 1) % len(pcm_pool)]
                                )
                            elif remaining[sid] > 0:
                                feed_sids.append(sid)
                                remaining[sid] -= 1
                                if remaining[sid] == 0:
                                    to_finish.append(sid)
                        if feed_sids:
                            # one batched native ingest call for the whole
                            # fleet (feed_many) instead of a ~50us Python/
                            # ctypes feed() per lane
                            sids_arr = np.asarray(feed_sids, dtype=np.int32)
                            sched.feed_many(
                                sids_arr,
                                pool_mat[(sids_arr + i) % len(pcm_pool)],
                            )
                        for sid in to_finish:
                            sched.finish(sid)
                        # redeem landed results (non-blocking: tickets
                        # whose trace is still in flight stay queued)
                        still = []
                        for tk in tickets:
                            if sched.take_result(tk, block=False) is None:
                                still.append(tk)
                            else:
                                harvested += 1
                        tickets[:] = still
                    return sched.step()

                tc = time.time()
                tick(0)  # compile
                compile_s = time.time() - tc
                # warm through a FULL utterance lifecycle + retirement so
                # every finalize steps-bucket (32/64/128...) compiles
                # before the measured window — a bucket compile landing
                # mid-measurement dominated earlier streaming numbers
                warm = utt_ticks + 4
                for i in range(1, warm):
                    tick(i)
                # ≥24 measured ticks: the end-of-window drain (in-flight
                # ticks + finalize backlog, charged INSIDE wall so the
                # loop can't hide unfinished work) is a fixed ~2-tick
                # cost that a 10-tick window would inflate
                n_meas = max(2 * utt_ticks, 24)
                active_total = 0
                from rhasspy_speech_tpu.utils.metrics import reset_metrics

                stage_metrics = reset_metrics()
                # BENCH_SERIAL=1: block on the device after every tick —
                # tick time becomes host + device fully serialized, so
                # (serial - async) exposes how much pipelining hides and
                # (serial - host stages) is the true device time/tick
                serial = os.environ.get("BENCH_SERIAL", "0") == "1"
                tick_walls = []  # per-tick wall samples (transport noise)
                t0 = time.time()
                for i in range(warm, warm + n_meas):
                    tw0 = time.time()
                    active_total += tick(i)
                    if serial:
                        import jax as _jax

                        _jax.block_until_ready(sched._alpha)
                    tick_walls.append(time.time() - tw0)
                # Ticks dispatch asynchronously and finalize harvests are
                # readiness-gated, so drain everything still in flight
                # INSIDE the measured wall — otherwise the loop above
                # could just be enqueueing work the device hasn't done.
                import jax as _jax

                _jax.block_until_ready(sched._alpha)
                while sched._pending_finalize:
                    sched._harvest_finalizes()
                for tk in tickets:
                    if sched.take_result(tk, block=True) is not None:
                        harvested += 1
                tickets.clear()
                wall = time.time() - t0
                stage_ms = {
                    name: round(s.seconds / n_meas * 1000.0, 1)
                    for name, s in sorted(stage_metrics.stages.items())
                }

                tick_ms = wall / n_meas * 1000.0
                chunk_rtf = (wall / n_meas) / chunk_sec
                xrt = active_total * chunk_sec / wall
                # median/p90 per-tick wall separates the steady state
                # from stalls
                tws = np.sort(np.array(tick_walls)) * 1000.0
                tick_med = float(tws[len(tws) // 2])
                tick_p90 = float(tws[int(len(tws) * 0.9)])
                points.append(
                    {"lanes": lanes, "tick_ms": round(tick_ms, 1),
                     "tick_ms_median": round(tick_med, 1),
                     "tick_ms_p90": round(tick_p90, 1),
                     "chunk_rtf": round(chunk_rtf, 4),
                     "xrt_streams": round(xrt, 1),
                     "xrt_streams_median": round(
                         active_total / n_meas * chunk_sec / tick_med * 1000.0,
                         1,
                     ),
                     "chunk_out": chunk_out,
                     "wire": wire,
                     "endpointing": endpointing is not None,
                     "utts_retired": completed,
                     "results_harvested": harvested,
                     "stage_ms": stage_ms}
                )
                sys.stderr.write(
                    f"stream lanes {lanes}: tick {tick_ms:.1f} ms "
                    f"(median {tick_med:.1f}, p90 {tick_p90:.1f}) "
                    f"chunk-RTF {chunk_rtf:.4f} {xrt:.0f} xRT streams "
                    f"({completed} utts retired, {harvested} results "
                    f"harvested; compile {compile_s:.1f}s) "
                    f"stages {stage_ms}\n"
                )
                del sched
            except Exception as exc:
                sys.stderr.write(
                    f"stream lanes {lanes}: infeasible ({type(exc).__name__}: {exc})\n"
                )
                points.append({"lanes": lanes, "tick_ms": None,
                               "chunk_rtf": None, "xrt_streams": 0.0,
                               "wire": wire})
        return points
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _require_gpu():
    """Print the device JAX runs on; exit 2 unless it is a GPU (a CPU
    number is never a device figure)."""
    import jax

    devs = jax.devices()
    sys.stderr.write(
        f"bench devices: {devs[0].platform} {devs[0].device_kind} "
        f"x{len(devs)}\n"
    )
    if devs[0].platform != "gpu":
        sys.stderr.write("bench: no GPU; refusing to measure\n")
        sys.exit(2)
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def main():
    import jax
    import jax.numpy as jnp

    device = _require_gpu()

    # the serving entry points enable this themselves; the batch path
    # builds raw jits, so opt in explicitly — across bench runs the
    # flagship programs then load from the persistent cache
    from rhasspy_speech_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    from rhasspy_speech_tpu.models import compile_nnet3
    from rhasspy_speech_tpu.ops.decoder import (
        make_decode_graph,
        traces_to_words_batch,
        viterbi_decode,
    )
    from rhasspy_speech_tpu.ops.frontend import (
        FrontendConfig,
        make_frontend_params,
        mfcc_batch,
        num_frames,
    )
    from rhasspy_speech_tpu.ops.ivector import extract_ivectors
    from rhasspy_speech_tpu.pipeline.fuzzy import get_fuzzy_text
    from rhasspy_speech_tpu.pipeline.transcribe import select_decoder
    from rhasspy_speech_tpu.testing.flagship import build_flagship_graph
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    t0 = time.time()
    graph, g_fuzzy, lang = build_flagship_graph(order=3)
    tree_pdfs = graph.num_pdfs
    # A real chain model computes all its pdfs every frame; the synthetic
    # tree only REFERENCES the first tree_pdfs of them.
    graph.num_pdfs = max(NUM_PDFS, tree_pdfs)
    dev_graph = make_decode_graph(graph)
    build_s = time.time() - t0

    cfg = FrontendConfig(num_mel_bins=40, num_ceps=40)  # mfcc_hires shape
    params = make_frontend_params(cfg)
    iv_params = build_ivector_params(cfg.num_ceps)

    spec = build_tdnnf_spec(
        num_pdfs=graph.num_pdfs,
        input_dim=cfg.num_ceps,
        ivector_dim=IVEC_DIM,
        hidden_dim=HIDDEN,
        num_tdnnf_layers=LAYERS,
    )

    n_samples = int(16000 * SECONDS)
    T = num_frames(cfg, n_samples)
    n_out = -(-T // 3)
    model = compile_nnet3(spec, num_out_frames=n_out, subsampling=3)
    lo, hi = model.ranges["input"]
    idx = np.clip(np.arange(lo, hi), 0, T - 1)

    bf16 = DTYPE in ("bfloat16", "bf16")
    if bf16:
        model = model.cast(jnp.bfloat16)

    def front(pcm):
        feats = mfcc_batch(params, pcm)
        ivec = extract_ivectors(feats, iv_params)  # f32 (linear solves)
        am_in = feats[:, idx]
        if bf16:
            am_in = am_in.astype(jnp.bfloat16)
            ivec = ivec.astype(jnp.bfloat16)
        out = model.forward(am_in, ivec)
        return out.astype(jnp.float32) if bf16 else out

    jitted_front = jax.jit(front)
    jitted_dense = jax.jit(lambda lp: viterbi_decode(dev_graph, lp))
    frontier_graph = None
    rng = np.random.RandomState(0)

    def fuzzy_tail(word_lists):
        # serving path's per-batch dedup of identical hypotheses
        fuzzy_cache = {}
        for words in word_lists:
            if words is None:
                continue
            key = tuple(words)
            if key not in fuzzy_cache:
                fuzzy_cache[key] = get_fuzzy_text([words], g_fuzzy, lang.words)

    def measure(batch):
        nonlocal frontier_graph
        out_degree = int(np.bincount(graph.arc_src).max())
        mode, arg = select_decoder(
            graph.num_states, batch, n_out, max(NBEST, 1), 7000,
            out_degree=out_degree, num_arcs=graph.num_arcs,
        )

        if mode == "frontier":
            from rhasspy_speech_tpu.ops.frontier import (
                FrontierGraph,
                topk_backtrace,
                viterbi_topk_cached,
            )

            if frontier_graph is None:
                frontier_graph = FrontierGraph.from_dense(graph)

        def decode_and_tail(lp, stages=None):
            def mark(name, t0):
                if stages is not None:
                    stages[name] = stages.get(name, 0.0) + (time.time() - t0)
                return time.time()

            if mode == "frontier":
                t0 = time.time()
                states_t, alphas_t, arcs_t = viterbi_topk_cached(
                    frontier_graph, lp, arg
                )
                # one batched D2H for the triple
                states_np, alphas_np, arcs_np = jax.device_get(
                    (states_t, alphas_t, arcs_t)
                )
                t0 = mark("decode", t0)
                words = [
                    topk_backtrace(graph, states_np, alphas_np, arcs_np, i)[0]
                    for i in range(batch)
                ]
                t0 = mark("backtrace", t0)
                fuzzy_tail(words)
                mark("fuzzy", t0)
                return
            # exact paths in sub-batches of `arg` (production plan)
            for start in range(0, batch, arg):
                chunk = lp[start : start + arg]
                t0 = time.time()
                if mode == "dense":
                    trace, fstate, cost = jax.device_get(
                        jitted_dense(chunk)
                    )
                    t0 = mark("decode", t0)
                    assembled = traces_to_words_batch(graph, trace, fstate, cost)
                else:
                    from rhasspy_speech_tpu.ops.decoder import (
                        viterbi_decode_checkpointed,
                    )

                    trace, fstate, cost = viterbi_decode_checkpointed(
                        dev_graph, chunk
                    )
                    t0 = mark("decode", t0)
                    assembled = traces_to_words_batch(graph, trace, fstate, cost)
                t0 = mark("backtrace", t0)
                fuzzy_tail([w for w, _c in assembled])
                mark("fuzzy", t0)

        pcm = jnp.asarray(
            (1000.0 * rng.randn(batch, n_samples)).astype(np.float32)
        )
        tc = time.time()
        lp = jitted_front(pcm)
        lp.block_until_ready()
        decode_and_tail(lp)
        compile_s = time.time() - tc

        times = []
        for _ in range(ITERS):
            t1 = time.time()
            lp = jitted_front(pcm)
            decode_and_tail(lp)
            times.append(time.time() - t1)

        # One extra instrumented iteration for the stage breakdown (the
        # front block boundary removes front/decode dispatch overlap, so
        # it is reported separately, not folded into the headline avg).
        stages = {}
        t1 = time.time()
        lp = jitted_front(pcm)
        lp.block_until_ready()
        stages["front"] = time.time() - t1
        decode_and_tail(lp, stages=stages)

        avg = float(np.mean(times))
        return avg, compile_s, mode, arg, stages

    results = []
    for batch in BATCHES:
        try:
            avg, compile_s, mode, arg, stages = measure(batch)
        except Exception as exc:  # e.g. RESOURCE_EXHAUSTED past the HBM knee
            sys.stderr.write(f"batch {batch}: infeasible ({type(exc).__name__})\n")
            results.append({"batch": batch, "rtf": None, "xrt_streams": 0.0,
                            "decode": "infeasible"})
            continue
        rtf = avg / SECONDS
        xrt = batch * SECONDS / avg
        stage_ms = {k: round(v * 1000, 1) for k, v in stages.items()}
        results.append({"batch": batch, "rtf": round(rtf, 4),
                        "xrt_streams": round(xrt, 1), "decode": mode,
                        "stage_ms": stage_ms})
        sys.stderr.write(
            f"batch {batch} [{mode}({arg})]: "
            f"avg {avg * 1000:.1f} ms RTF {rtf:.4f} "
            f"{xrt:.0f} xRT streams (compile {compile_s:.1f}s) "
            f"stages {stage_ms}\n"
        )

    feasible = [r for r in results if r["rtf"] is not None]
    peak = max(feasible, key=lambda r: r["xrt_streams"]) if feasible else None
    realtime = [r for r in feasible if r["rtf"] < 0.1]
    north = max(realtime, key=lambda r: r["batch"]) if realtime else None

    # Streaming serving point: the StreamScheduler lanes x chunks shape.
    # BENCH_STREAMING=0 skips it.
    stream_points = []
    stream_north = None
    stream_realtime = None
    stream_wire = None
    if os.environ.get("BENCH_STREAMING", "1") != "0":
        lanes_list = [
            int(x)
            for x in os.environ.get(
                "BENCH_LANES", "128,256,384,512"
            ).split(",")
            if x.strip()
        ]
        stream_points = streaming_bench(graph, g_fuzzy, lang, lanes_list)
        # headline points come from the env-default wire only; the extra
        # mu-law point (when the default is i16) is reported separately
        env_wire = os.environ.get("BENCH_WIRE", "i16")
        default_pts = [p for p in stream_points if p.get("wire") == env_wire]
        extra_pts = [p for p in stream_points if p.get("wire") != env_wire]
        stream_wire = (
            max(extra_pts, key=lambda p: p["xrt_streams"])
            if extra_pts
            else None
        )
        rt = [
            p for p in default_pts
            if p["chunk_rtf"] is not None and p["chunk_rtf"] < 0.1
        ]
        stream_north = max(rt, key=lambda p: p["lanes"]) if rt else None
        # keeping-up point: the most lanes the scheduler sustains in real
        # time (tick <= one chunk of audio per lane)
        keep = [
            p for p in default_pts
            if p["chunk_rtf"] is not None and p["chunk_rtf"] < 1.0
        ]
        stream_realtime = max(keep, key=lambda p: p["lanes"]) if keep else None

    sys.stderr.write(
        f"graph: {graph.num_states} states / {graph.num_arcs} arcs / "
        f"{graph.num_pdfs} pdfs (tree {tree_pdfs}); AM TDNN-F {HIDDEN}x{LAYERS} "
        f"+ivec{IVEC_DIM} (UBM {UBM_GAUSS}); build {build_s:.1f}s\n"
    )

    value = north["batch"] if north else 0
    print(
        json.dumps(
            {
                "metric": "streams_per_chip_at_rtf_0.1",
                "value": value,
                "unit": (
                    "concurrent streams decoded at RTF<0.1 (flagship "
                    f"grammar 3-gram ARPA triphone-expanded graph, TDNN-F "
                    f"{HIDDEN}x{LAYERS} + {IVEC_DIM}-dim i-vector "
                    f"({UBM_GAUSS}-gauss UBM), {graph.num_pdfs} pdfs, "
                    "fuzzy tail included)"
                ),
                "vs_baseline": round(value / 100.0, 3),
                "device": device,
                "north_star_point": north,
                "peak_throughput_point": peak,
                "streaming_point": stream_north,
                "streaming_realtime_point": stream_realtime,
                "streaming_wire_point": stream_wire,
                "streaming_sweep": stream_points,
                "sweep": results,
                "graph": {
                    "states": graph.num_states,
                    "arcs": graph.num_arcs,
                    "pdfs": graph.num_pdfs,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
