#!/usr/bin/env python
"""Roofline accounting for the flagship batch step.

Replaces an asserted "bandwidth-bound" claim with measured fractions:
for the B x T flagship shapes this reports, per stage,

  - XLA's own cost model (compiled.cost_analysis()): bytes accessed and
    FLOPs of the whole program;
  - measured wall time on the current backend (block_until_ready);
  - achieved HBM GB/s vs the device's peak, and achieved TFLOP/s vs
    its matmul peak for the AM's dtype (MFU).

Stages measured:
  decode      the production viterbi_decode (forward + bp + on-device
              backtrace) over the flagship graph
  decode_fwd  the alpha-only forward scan (_relax_costs; no winner
              tracking) — isolates how much of decode's traffic is the
              backpointer machinery
  am_forward  the TDNN-F chunk AM (the MFU side of the step)

Peaks come from the PEAKS table, keyed by JAX's ``device_kind``; a
device missing from it is an error. Shares are of the published peak;
report them beside the card's power limit (nvidia-smi), since a card set
below its full limit cannot hold the peak clock.

Usage: python examples/decode_roofline.py [B] [T_seconds]
(defaults B=512, 3.0 s).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

B = int(sys.argv[1]) if len(sys.argv) > 1 else 512
SECONDS = float(sys.argv[2]) if len(sys.argv) > 2 else 3.0
ITERS = int(os.environ.get("ROOFLINE_ITERS", "5"))

# Published dense peaks per device (NVIDIA H100 SXM data sheet, at its
# full 700 W power limit): HBM bytes/s and matmul FLOP/s by AM dtype
# (f32 at Precision.HIGHEST runs outside the tensor cores).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbs": 3350.0,
        "tflops": {"bf16": 989.0, "f32": 67.0},
    },
}


def device_peaks(device_kind: str, dtype: str):
    """(HBM GB/s, TFLOP/s) for ``device_kind`` at the AM's ``dtype``."""
    if device_kind not in PEAKS:
        raise SystemExit(
            f"no published peaks for device {device_kind!r}; add it to PEAKS"
        )
    p = PEAKS[device_kind]
    return p["hbm_gbs"], p["tflops"][dtype]


def main():
    import jax
    import jax.numpy as jnp

    from rhasspy_speech_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    import bench  # repo-root flagship AM sizes

    from rhasspy_speech_tpu.models import compile_nnet3
    from rhasspy_speech_tpu.ops.decoder import (
        _relax_costs,
        make_decode_graph,
        viterbi_decode,
    )
    from rhasspy_speech_tpu.ops.frontend import (
        FrontendConfig,
        make_frontend_params,
        mfcc_batch,
        num_frames,
    )
    from rhasspy_speech_tpu.testing.flagship import build_flagship_graph
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    graph, _g_fuzzy, _lang = build_flagship_graph(
        order=3, with_fuzzy=False, num_pdfs=bench.NUM_PDFS
    )
    dev_graph = make_decode_graph(graph)

    cfg = FrontendConfig(num_mel_bins=40, num_ceps=40)
    params = make_frontend_params(cfg)
    n_samples = int(16000 * SECONDS)
    T = num_frames(cfg, n_samples)
    n_out = -(-T // 3)

    spec = build_tdnnf_spec(
        num_pdfs=graph.num_pdfs,
        input_dim=cfg.num_ceps,
        ivector_dim=bench.IVEC_DIM,
        hidden_dim=bench.HIDDEN,
        num_tdnnf_layers=bench.LAYERS,
    )
    model = compile_nnet3(spec, num_out_frames=n_out, subsampling=3)
    bf16 = bench.DTYPE in ("bfloat16", "bf16")
    dev = jax.devices()[0]
    PEAK_GBS, PEAK_TFLOPS = device_peaks(
        dev.device_kind, "bf16" if bf16 else "f32"
    )
    if bf16:
        model = model.cast(jnp.bfloat16)
    lo, hi = model.ranges["input"]
    idx = np.clip(np.arange(lo, hi), 0, T - 1)

    rng = np.random.RandomState(0)
    pcm = jnp.asarray((1000.0 * rng.randn(B, n_samples)).astype(np.float32))
    feats = mfcc_batch(params, pcm)
    am_in = feats[:, idx]
    ivec = jnp.asarray(rng.randn(B, bench.IVEC_DIM).astype(np.float32))
    if bf16:
        am_in = am_in.astype(jnp.bfloat16)
        ivec = ivec.astype(jnp.bfloat16)

    def am_fn(x, iv):
        out = model.forward(x, iv)
        return out.astype(jnp.float32) if bf16 else out

    lp = jax.jit(am_fn)(am_in, ivec)
    lp.block_until_ready()

    def decode_fn(lp):
        return viterbi_decode(dev_graph, lp)

    def fwd_only(lp):
        am_costs = -jnp.swapaxes(lp, 0, 1)
        alpha0 = jnp.broadcast_to(
            dev_graph.base.init_weight[None, :], (B, dev_graph.base.num_states)
        )
        return jax.lax.scan(
            lambda a, am_t: (_relax_costs(dev_graph, a, am_t), None),
            alpha0,
            am_costs,
        )[0]

    stages = {
        "am_forward": (am_fn, (am_in, ivec)),
        "decode": (decode_fn, (lp,)),
        "decode_fwd": (fwd_only, (lp,)),
    }

    print(
        f"device {dev.platform} {dev.device_kind} | "
        f"B={B} T={T} n_out={n_out} graph S={graph.num_states} "
        f"A={graph.num_arcs} P={graph.num_pdfs} layout="
        f"{type(dev_graph).__name__} dtype={'bf16' if bf16 else 'f32'}"
    )
    results = {}
    for name, (fn, args) in stages.items():
        jitted = jax.jit(fn)
        compiled = jitted.lower(*args).compile()
        try:
            ca = compiled.cost_analysis()
            if isinstance(ca, list):  # older jax returns one dict per device
                ca = ca[0]
            bytes_total = float(ca.get("bytes accessed", float("nan")))
            flops = float(ca.get("flops", float("nan")))
        except Exception as exc:  # pragma: no cover
            print(f"{name}: cost_analysis unavailable ({exc})")
            bytes_total = flops = float("nan")
        out = jitted(*args)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(ITERS):
            out = jitted(*args)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / ITERS
        gbs = bytes_total / dt / 1e9
        tfs = flops / dt / 1e12
        results[name] = dict(
            ms=dt * 1000.0,
            bytes=bytes_total,
            flops=flops,
            gbs=gbs,
            hbm_frac=gbs / PEAK_GBS,
            tflops=tfs,
            mfu=tfs / PEAK_TFLOPS,
        )
        print(
            f"{name:11s} {dt*1000:8.1f} ms | {bytes_total/1e9:7.2f} GB "
            f"-> {gbs:6.1f} GB/s ({100*gbs/PEAK_GBS:5.1f}% of HBM peak) | "
            f"{flops/1e12:7.3f} TF -> {tfs:6.1f} TF/s "
            f"({100*tfs/PEAK_TFLOPS:5.2f}% MFU)"
        )

    d = results.get("decode")
    if d:
        per_frame = d["bytes"] / n_out / 1e6
        print(
            f"\ndecode moves {per_frame:.1f} MB/frame over {n_out} frames; "
            f"at {100*d['hbm_frac']:.1f}% of HBM roofline the plateau is "
            + (
                "physics — shrink state (fp16 alpha, bp compaction)"
                if d["hbm_frac"] > 0.7
                else "NOT bandwidth: overhead/latency-bound — kernel or "
                "schedule headroom remains"
            )
        )


if __name__ == "__main__":
    main()
