#!/usr/bin/env python
"""MFCC's share of the batch front step on the GPU.

Times ``ops.frontend.mfcc_batch`` alone, then the whole front step
(MFCC -> i-vector -> flagship TDNN-F AM, as bench.py's ``front``), at
B utterances of 3 s, in that order, each as one jitted program after a
warm-up, ending in ``block_until_ready``. Prints the card (nvidia-smi
name and power limit) beside every number. Refuses to run without a GPU.

Usage: python examples/front_share.py [B] [iters]   (defaults 512, 10)
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _timed(fn, arg, iters):
    import jax

    jax.block_until_ready(fn(arg))  # compile + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1000.0, float(np.min(times)) * 1000.0


def main(batch: int = 512, iters: int = 10) -> None:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"front_share: no GPU (platform {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    import bench  # flagship AM sizes and i-vector construction

    from rhasspy_speech_tpu.models import compile_nnet3
    from rhasspy_speech_tpu.ops.frontend import (
        FrontendConfig,
        make_frontend_params,
        mfcc_batch,
        num_frames,
    )
    from rhasspy_speech_tpu.ops.ivector import extract_ivectors
    from rhasspy_speech_tpu.testing.tdnnf import build_tdnnf_spec

    cfg = FrontendConfig(num_mel_bins=40, num_ceps=40)
    params = make_frontend_params(cfg)
    iv_params = bench.build_ivector_params(cfg.num_ceps)
    n_samples = int(16000 * 3.0)
    T = num_frames(cfg, n_samples)
    spec = build_tdnnf_spec(
        num_pdfs=bench.NUM_PDFS, input_dim=cfg.num_ceps,
        ivector_dim=bench.IVEC_DIM, hidden_dim=bench.HIDDEN,
        num_tdnnf_layers=bench.LAYERS,
    )
    f32_model = compile_nnet3(spec, num_out_frames=-(-T // 3), subsampling=3)
    lo, hi = f32_model.ranges["input"]
    idx = np.clip(np.arange(lo, hi), 0, T - 1)
    rng = np.random.RandomState(0)
    pcm = jnp.asarray((1000.0 * rng.randn(batch, n_samples)).astype(np.float32))

    def front_fn(model, bf16):
        def front(p):
            feats = mfcc_batch(params, p)
            ivec = extract_ivectors(feats, iv_params)
            am_in = feats[:, idx]
            if bf16:
                am_in, ivec = am_in.astype(jnp.bfloat16), ivec.astype(jnp.bfloat16)
            return model.forward(am_in, ivec).astype(jnp.float32)

        return jax.jit(front)

    mfcc_ms, mfcc_min = _timed(jax.jit(lambda p: mfcc_batch(params, p)), pcm, iters)
    iv_ms, iv_min = _timed(
        jax.jit(lambda p: extract_ivectors(mfcc_batch(params, p), iv_params)),
        pcm, iters,
    )
    print(f"device {dev.device_kind}; card {card}; B={batch} x 3 s; "
          f"median (min) of {iters}")
    print(f"mfcc_batch alone: {mfcc_ms:.2f} ms ({mfcc_min:.2f})")
    print(f"mfcc + i-vector: {iv_ms:.2f} ms ({iv_min:.2f})")
    for name, model, bf16 in (
        ("f32", f32_model, False),
        ("bf16", f32_model.cast(jnp.bfloat16), True),
    ):
        front_ms, front_min = _timed(front_fn(model, bf16), pcm, iters)
        print(f"front step ({name} AM): {front_ms:.2f} ms ({front_min:.2f}); "
              f"MFCC share {100.0 * mfcc_ms / front_ms:.1f}%")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
