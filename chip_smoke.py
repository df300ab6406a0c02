#!/usr/bin/env python
"""Smoke run of the serving path on one GPU, through the user entry points.

Phases, in one process (any failure exits non-zero and prints no result):

1. device: the card's name and power limit (nvidia-smi) and what JAX sees;
   anything but a GPU stops the run;
2. synthetic: a synthetic profile whose acoustic model matches its audio
   (testing.synthetic) trained through ``train_model_sync`` must give
   exact transcripts in batch (``Nnet3WavTranscriber``) and streaming
   (``StreamScheduler`` with endpointing), bf16 transcripts equal to f32,
   and an AOT ``save_aot`` / load round trip;
3. flagship: the flagship AM (TDNN-F 768x9, 40-dim MFCC + 100-dim
   i-vector, 512-Gaussian UBM, 3,072 pdfs; random weights from a seed) over
   the committed grammar's order-3 graph — a batch of 64 three-second
   utterances and 64 streaming lanes through one full utterance
   lifecycle, with compile seconds, memory analyses and smoke timings;
4. parity: MFCC, i-vectors, f32 AM log-probs and decode at flagship width
   against the same functions on the in-process CPU backend, each max
   error printed beside its tolerance;
5. determinism: two flagship decodes give bit-equal traces;
6. compile cache and the GPU-marked tests (``pytest -m gpu``).

``--four`` runs only the multi-card path instead: ShardedWavTranscriber
and StreamScheduler over a four-card stream mesh, each against the
one-card result (transcripts must be equal).

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Times printed here are smoke timings (one run, compile excluded where
stated), not benchmark figures.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parent

# Parity tolerances, each a max error over the compared arrays:
# MFCC and AM log-probs relative to the reference's largest magnitude
# (cuFFT and the CPU FFT sum in different orders); i-vectors as
# |a - b| <= tol * (1 + |b|), the CPU test suite's rtol = atol = 2e-3;
# decode best costs relative.
TOL = {"mfcc": 1e-4, "ivector": 2e-3, "am_f32": 1e-3, "decode_cost": 1e-5}

SYNTH_LEXICON = {
    "turn": ["t", "er", "n"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "the": ["dh", "ah"],
    "light": ["l", "ay", "t"],
    "fan": ["f", "ae", "n"],
}
SYNTH_GRAMMAR = "turn (on|off) [the] (light|fan)"
SYNTH_SENTENCES = [
    "turn on the light", "turn off the fan", "turn on fan", "turn off light",
]


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


# ---------------------------------------------------------------------------
# synthetic profile: exact transcripts, bf16 == f32, AOT round trip


def phase_synthetic(workdir: Path, n_utts: int = 8) -> None:
    from rhasspy_speech_tpu.const import LangSuffix
    from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber, lang_dir_name
    from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig
    from rhasspy_speech_tpu.pipeline.train import train_model_sync
    from rhasspy_speech_tpu.testing import (
        build_synthetic_profile,
        synthesize_sentence,
    )

    profile = build_synthetic_profile(
        workdir / "synth_model", SYNTH_LEXICON, with_ivector=True
    )
    train_dir = workdir / "synth_train"
    train_model_sync(
        "en",
        {"language": "en",
         "intents": {"M": {"data": [{"sentences": [SYNTH_GRAMMAR]}]}}},
        train_dir, profile.model_dir, lang_suffixes=[LangSuffix.GRAMMAR],
    )
    lang_dir = train_dir / lang_dir_name(LangSuffix.GRAMMAR)
    texts = [SYNTH_SENTENCES[i % len(SYNTH_SENTENCES)] for i in range(n_utts)]
    pcms = [synthesize_sentence(profile, t, seed=10 + i)
            for i, t in enumerate(texts)]

    t32 = Nnet3WavTranscriber(profile.model_dir, lang_dir)
    got32 = t32.transcribe_pcm_batch(pcms)
    check(got32 == [[t] for t in texts], f"synthetic batch f32: {got32}")
    t16 = Nnet3WavTranscriber(
        profile.model_dir, lang_dir, compute_dtype="bfloat16"
    )
    got16 = t16.transcribe_pcm_batch(pcms)
    check(got16 == got32, f"synthetic bf16 != f32: {got16}")
    log(f"synthetic batch: {n_utts}/{n_utts} exact (f32), bf16 == f32")

    results = stream_lifecycle(
        profile.model_dir, lang_dir, pcms, endpointing=EndpointConfig()
    )
    check(results == [[t] for t in texts], f"synthetic streaming: {results}")
    log(f"synthetic streaming: {n_utts}/{n_utts} exact (endpointing on)")

    # AOT: export the serving programs, then a fresh transcriber must serve
    # from the blobs alone (its traceable frontend is poisoned)
    aot_dir = workdir / "synth_aot"
    t_save = Nnet3WavTranscriber(profile.model_dir, lang_dir, aot_dir=aot_dir)
    t_save.save_aot(pcms)
    blobs = sorted(p.name for p in aot_dir.glob("*.jaxexport"))
    check(bool(blobs), "save_aot wrote no programs")
    t_load = Nnet3WavTranscriber(profile.model_dir, lang_dir, aot_dir=aot_dir)

    def _poisoned(*_a, **_k):
        raise SmokeFailure("AOT load re-traced the frontend")

    t_load.am.features_traceable = _poisoned
    got_aot = t_load.transcribe_pcm_batch(pcms)
    check(got_aot == got32, f"AOT round trip: {got_aot}")
    log(f"AOT round trip: {len(blobs)} programs {blobs} loaded; "
        "transcripts equal")


def stream_lifecycle(
    model_dir, graph_dir, pcms, endpointing=None, chunk: int = 1600,
    mesh=None,
) -> List[Optional[List[str]]]:
    """One full utterance lifecycle per lane on a StreamScheduler: open,
    feed in ``chunk``-sample pieces, finish, step until decoded, close,
    take_result. Returns one result per PCM."""
    import numpy as np

    from rhasspy_speech_tpu.pipeline.scheduler import StreamScheduler

    n = len(pcms)
    longest = max(p.shape[0] for p in pcms)
    sched = StreamScheduler(
        model_dir, graph_dir, max_streams=n, endpointing=endpointing,
        wire="i16", mesh=mesh, pool_capacity_samples=longest + 16000,
    )
    sids = [sched.open_stream() for _ in range(n)]
    check(all(s >= 0 for s in sids), "stream admission failed")
    offsets = [0] * n
    finished = [False] * n
    for _ in range(10_000):
        if all(sched.slots[s].done for s in sids):
            break
        for i, sid in enumerate(sids):
            if sched.slots[sid].done or finished[i]:
                continue
            if offsets[i] < pcms[i].shape[0]:
                piece = np.round(pcms[i][offsets[i]: offsets[i] + chunk])
                sched.feed(sid, piece.astype(np.int16))
                offsets[i] += chunk
            else:
                sched.finish(sid)
                finished[i] = True
        sched.step()
    else:
        raise SmokeFailure("streaming lanes never finished")
    tickets = [sched.close(sid) for sid in sids]
    results = [sched.take_result(tk, block=True) for tk in tickets]
    check(all(r is not None for r in results), "a lane returned no result")
    return results


# ---------------------------------------------------------------------------
# flagship width


@dataclass
class Flagship:
    graph: object
    model_dir: Path
    graph_dir: Path


def build_flagship(
    workdir: Path,
    hidden: int = 768,
    layers: int = 9,
    num_pdfs: int = 3072,
    ivector_dim: int = 100,
    ubm_gauss: int = 512,
    order: int = 3,
) -> Flagship:
    """The flagship model dir (random weights, seed 7) and the committed
    grammar's decode graph, written where the user entry points read
    them."""
    from rhasspy_speech_tpu.pipeline.artifacts import LangArtifacts
    from rhasspy_speech_tpu.testing.flagship import (
        build_flagship_graph,
        write_flagship_model_dir,
    )

    t0 = time.time()
    graph, g_fuzzy, lang = build_flagship_graph(order=order, num_pdfs=num_pdfs)
    max_phone = max(
        pid for (p, pid) in lang.phones if pid != 0 and not p.startswith("#")
    )
    model_dir = write_flagship_model_dir(
        workdir / "flagship_model", num_pdfs=graph.num_pdfs,
        max_phone=max_phone, hidden_dim=hidden, num_tdnnf_layers=layers,
        ivector_dim=ivector_dim, ubm_gauss=ubm_gauss,
    )
    graph_dir = workdir / "flagship_graph"
    LangArtifacts(
        words=lang.words, g_fuzzy=g_fuzzy, graph=graph, phones=lang.phones
    ).save(graph_dir)
    log(f"flagship graph: {graph.num_states} states / {graph.num_arcs} arcs "
        f"/ {graph.num_pdfs} pdfs (order {order}); AM TDNN-F "
        f"{hidden}x{layers} + ivec{ivector_dim} (UBM {ubm_gauss}); "
        f"built in {time.time() - t0:.1f} s")
    return Flagship(graph, model_dir, graph_dir)


def random_pcms(n: int, seconds: float, seed: int = 0):
    import numpy as np

    rng = np.random.RandomState(seed)
    samples = int(16000 * seconds)
    return [np.round(1000.0 * rng.randn(samples)).astype(np.float32)
            for _ in range(n)]


def memory_line(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(
        f"{f.replace('_size_in_bytes', '')} "
        f"{getattr(ma, f, 0) / 2**20:.1f} MiB"
        for f in fields
    )


def phase_flagship_batch(fl: Flagship, card: str, batch: int = 64,
                         seconds: float = 3.0):
    """Batch path at flagship width. Returns (transcriber, pcms, decode
    program, log-probs, lengths)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rhasspy_speech_tpu.ops.decoder import viterbi_decode
    from rhasspy_speech_tpu.ops.frontend import num_frames
    from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber
    from rhasspy_speech_tpu.pipeline.transcribe import select_decoder

    t = Nnet3WavTranscriber(fl.model_dir, fl.graph_dir)
    pcms = random_pcms(batch, seconds)
    cfg = t.am.frontend_config
    T = num_frames(cfg, pcms[0].shape[0])
    n_out = -(-T // t.am.subsampling)
    bucket = -(-n_out // 16) * 16
    g = t.artifacts.graph
    mode, arg = select_decoder(
        g.num_states, batch, bucket, 1, t.max_active,
        t.decode_memory_budget, out_degree=t._graph_out_degree(),
        num_arcs=g.num_arcs,
    )
    log(f"decode mode: {mode}({arg}) for {batch} x {bucket} frames "
        f"(budget {t.decode_memory_budget / 2**30:.2f} GiB)")

    t0 = time.time()
    first = t.transcribe_pcm_batch(pcms)
    first_s = time.time() - t0
    t0 = time.time()
    again = t.transcribe_pcm_batch(pcms)
    warm_s = time.time() - t0
    check(len(first) == batch and all(isinstance(r, list) for r in first),
          "flagship batch returned malformed results")
    check(again == first, "flagship batch transcripts changed between runs")
    log(f"flagship batch {batch} x {seconds:.0f} s: first call "
        f"{first_s:.2f} s (compile ~{first_s - warm_s:.2f} s), warm "
        f"{warm_s:.3f} s [smoke timing on {card}]")

    # the front and decode programs, compiled whole for their memory
    # analyses and reused by the parity and determinism phases
    pcm = jnp.asarray(np.stack(pcms))
    lengths = jnp.full((batch,), n_out, dtype=jnp.int32)

    def front(p):
        return t.am.log_probs(t.am.features_traceable(p), bucket)

    def decode(lp, lens):
        return viterbi_decode(t.device_graph, lp, lengths=lens)

    t0 = time.time()
    front_c = jax.jit(front).lower(pcm).compile()
    front_cs = time.time() - t0
    lp = front_c(pcm)
    lp.block_until_ready()
    t0 = time.time()
    decode_c = jax.jit(decode).lower(lp, lengths).compile()
    decode_cs = time.time() - t0
    log(f"front program: compile {front_cs:.2f} s; memory "
        f"{memory_line(front_c)}")
    log(f"decode program: compile {decode_cs:.2f} s; memory "
        f"{memory_line(decode_c)}")
    t0 = time.time()
    front_c(pcm).block_until_ready()
    front_s = time.time() - t0
    t0 = time.time()
    jax.block_until_ready(decode_c(lp, lengths))
    decode_s = time.time() - t0
    log(f"front step {front_s * 1000:.1f} ms, decode step "
        f"{decode_s * 1000:.1f} ms at B={batch} [smoke timing on {card}]")
    check(bool(np.isfinite(np.asarray(lp[:, :n_out])).all()),
          "flagship log-probs not finite")
    return t, pcms, decode_c, lp, lengths


def phase_flagship_stream(fl: Flagship, card: str, lanes: int = 64,
                          seconds: float = 3.0):
    from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig

    pcms = random_pcms(lanes, seconds, seed=1)
    t0 = time.time()
    results = stream_lifecycle(
        fl.model_dir, fl.graph_dir, pcms, endpointing=EndpointConfig()
    )
    log(f"flagship streaming: {lanes} lanes x {seconds:.0f} s, one full "
        f"lifecycle (endpointing on) in {time.time() - t0:.2f} s including "
        f"compile [smoke timing on {card}]")
    return results


def _max_rel(a, b) -> float:
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def phase_parity(fl: Flagship, t, pcms, lp_dev, n_sub: int = 8) -> Dict:
    """MFCC, i-vectors, f32 AM and decode on the device against the same
    functions on the in-process CPU backend (full f32; matmuls at HIGHEST
    on both sides)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rhasspy_speech_tpu.ops.decoder import (
        make_decode_graph,
        traces_to_words_batch,
        viterbi_decode,
    )
    from rhasspy_speech_tpu.ops.frontend import num_frames
    from rhasspy_speech_tpu.ops.ivector import extract_ivectors
    from rhasspy_speech_tpu.pipeline.transcribe import AcousticModel

    cpu = jax.devices("cpu")[0]
    pcm_np = np.stack(pcms[:n_sub])
    cfg = t.am.frontend_config
    n_out = -(-num_frames(cfg, pcm_np.shape[1]) // t.am.subsampling)
    bucket = lp_dev.shape[1]
    am = t.am
    with jax.default_device(cpu):
        am_cpu = AcousticModel(fl.model_dir)
        feats_ref = am_cpu.features_traceable(jnp.asarray(pcm_np))
        iv_ref = extract_ivectors(feats_ref, am_cpu.ivector_params)
        lp_ref = am_cpu.log_probs(feats_ref, bucket)

    feats = am.features_traceable(jnp.asarray(pcm_np))
    iv = extract_ivectors(feats, am.ivector_params)
    lp = lp_dev[:n_sub]
    out = {
        "mfcc": _max_rel(feats, feats_ref),
        "ivector": float(np.max(
            np.abs(np.asarray(iv, np.float64) - np.asarray(iv_ref, np.float64))
            / (1.0 + np.abs(np.asarray(iv_ref, np.float64)))
        )),
        "am_f32": _max_rel(lp[:, :n_out], lp_ref[:, :n_out]),
    }

    # decode: the device's log-probs through both backends' decoders
    lens = np.full((n_sub,), n_out, dtype=np.int32)
    lp_np = np.asarray(lp)
    trace, fstate, cost = jax.device_get(
        viterbi_decode(t.device_graph, jnp.asarray(lp_np),
                       lengths=jnp.asarray(lens))
    )
    with jax.default_device(cpu):
        dg_cpu = make_decode_graph(t.artifacts.graph)
        trace_r, fstate_r, cost_r = jax.device_get(
            viterbi_decode(dg_cpu, jnp.asarray(lp_np), lengths=jnp.asarray(lens))
        )
    g = t.artifacts.graph
    words = [w for w, _c in traces_to_words_batch(g, trace, fstate, cost)]
    words_r = [w for w, _c in traces_to_words_batch(g, trace_r, fstate_r, cost_r)]
    out["decode_cost"] = _max_rel(cost, cost_r)
    for name, err in out.items():
        log(f"parity {name}: max error {err:.3e} (tolerance {TOL[name]:.0e})")
        check(err <= TOL[name], f"parity {name}: {err:.3e} > {TOL[name]:.0e}")
    check(words == words_r, "parity decode: transcripts differ from the CPU")
    log(f"parity decode: {n_sub}/{n_sub} transcripts equal to the CPU's")
    return out


def phase_determinism(decode_c, lp, lengths) -> None:
    import jax
    import numpy as np

    a = jax.device_get(decode_c(lp, lengths))
    b = jax.device_get(decode_c(lp, lengths))
    for x, y, name in zip(a, b, ("trace", "final state", "cost")):
        check(np.array_equal(np.asarray(x), np.asarray(y)),
              f"determinism: two decodes differ in {name}")
    log("determinism: two flagship decodes bit-equal (trace, final state, "
        "cost)")


def phase_compile_cache() -> None:
    from rhasspy_speech_tpu.utils.compile_cache import cache_dir

    d = cache_dir()
    n = len([p for p in d.rglob("*") if p.is_file()]) if d.exists() else 0
    log(f"compile cache: {d} ({n} entries)")


def phase_gpu_tests() -> None:
    """The GPU-marked tests, in this process (one JAX process per card)."""
    import pytest

    class _Outcomes:
        def __init__(self):
            self.counts: Dict[str, int] = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] = (
                    self.counts.get(report.outcome, 0) + 1
                )

    # only the modules that hold GPU-marked tests: collecting the others
    # would import what the serving host need not have (PyYAML for the
    # CLI tests)
    files = sorted(
        str(p) for p in (REPO / "tests").glob("test_*.py")
        if "mark.gpu" in p.read_text(encoding="utf-8")
    )
    check(bool(files), "no GPU-marked test modules found")
    outcomes = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", *files],
        plugins=[outcomes],
    )
    log(f"gpu-marked tests: {outcomes.counts} (pytest exit {rc})")
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")
    check(outcomes.counts.get("passed", 0) > 0
          and not outcomes.counts.get("skipped"),
          "gpu-marked tests did not all run")


# ---------------------------------------------------------------------------
# four cards


def phase_four(fl: Flagship, card: str, batch: int = 64, lanes: int = 64,
               seconds: float = 3.0, n_devices: int = 4) -> None:
    from rhasspy_speech_tpu.parallel import ShardedWavTranscriber, make_stream_mesh
    from rhasspy_speech_tpu.pipeline import Nnet3WavTranscriber
    from rhasspy_speech_tpu.pipeline.endpoint import EndpointConfig

    mesh = make_stream_mesh(n_devices)
    pcms = random_pcms(batch, seconds)
    one = Nnet3WavTranscriber(fl.model_dir, fl.graph_dir).transcribe_pcm_batch(
        pcms
    )
    t0 = time.time()
    sharded = ShardedWavTranscriber(
        fl.model_dir, fl.graph_dir, mesh=mesh
    ).transcribe_pcm_batch(pcms)
    log(f"sharded batch {batch} x {seconds:.0f} s over {n_devices} devices in "
        f"{time.time() - t0:.2f} s including compile [smoke timing on {card}]")
    same = sum(a == b for a, b in zip(sharded, one))
    log(f"sharded batch: {same}/{batch} transcripts equal to one card")
    check(same == batch, "sharded batch transcripts differ from one card")

    spcms = random_pcms(lanes, seconds, seed=1)
    one_s = stream_lifecycle(fl.model_dir, fl.graph_dir, spcms,
                             endpointing=EndpointConfig())
    t0 = time.time()
    mesh_s = stream_lifecycle(fl.model_dir, fl.graph_dir, spcms,
                              endpointing=EndpointConfig(), mesh=mesh)
    log(f"mesh streaming {lanes} lanes over {n_devices} devices in "
        f"{time.time() - t0:.2f} s including compile [smoke timing on {card}]")
    same = sum(a == b for a, b in zip(mesh_s, one_s))
    log(f"mesh streaming: {same}/{lanes} transcripts equal to one card")
    check(same == lanes, "mesh streaming transcripts differ from one card")


# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    if not (REPO / "rhasspy_speech_tpu" / "__init__.py").is_file():
        print("chip_smoke: the rhasspy_speech_tpu package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    import jax

    devs = jax.devices()
    log(f"jax devices: {devs}")
    platform, kind = devs[0].platform, devs[0].device_kind
    log(f"device: platform {platform}, kind {kind}, count {len(devs)}")
    if platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {platform!r}); refusing to "
              "run on another device", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: need {need} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")

    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        fl = build_flagship(workdir)
        if args.four:
            phase_four(fl, card)
        else:
            phase_synthetic(workdir)
            t, pcms, decode_c, lp, lengths = phase_flagship_batch(fl, card)
            phase_flagship_stream(fl, card)
            stats = jax.devices()[0].memory_stats() or {}
            log(f"peak_bytes_in_use: "
                f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB of "
                f"{stats.get('bytes_limit', 0) / 2**30:.2f} GiB")
            phase_parity(fl, t, pcms, lp)
            phase_determinism(decode_c, lp, lengths)
            phase_compile_cache()
            phase_gpu_tests()
    log(f"all phases passed in {time.time() - t_start:.1f} s on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
