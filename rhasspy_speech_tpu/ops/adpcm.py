"""4-bit block-ADPCM codec for the serving wire (``wire="adpcm"``).

The serving tick is wire-byte bound on remote-dispatch transports: every
loop-ordering probe converges to the H2D channel's byte time, with the
fused device program idle behind it (see CHANGELOG 0.5.0 and
examples/tick_device_profile.py). The mu-law wire halved raw int16's
bytes; this wire halves mu-law's again — ~0.52 bytes/sample — by
encoding 4-bit IMA-style ADPCM deltas in independent blocks.

Wire format (block = the featurizer's frame shift, 160 samples at the
16 kHz/10 ms default): each block is ``3 + ceil((block-1)/2)`` bytes —

- bytes 0-1: the block's first sample, exact int16 little-endian
- byte 2: the initial step index (the encoder writes START_IDX; the
  decoder honors whatever is stored, clipped to the table)
- remaining bytes: samples 1..block-1 as 4-bit nibbles, low nibble
  first; nibble = sign<<3 | code, sample = clip(pred +/- dequant(code)).

Why blocks, and why block == frame_shift: the scheduler re-encodes each
lane's frame-overlap tail every tick (the original samples left the
pool when they were drained), so a sample can be encoded in several
ticks and its DECODED value must be identical in all of them or
features drift across the overlap (the mu-law wire's stability
contract, ops/mulaw.py). Three properties make block-ADPCM stable too:

1. **Absolute block alignment.** A lane's upload buffer always starts
   at absolute sample ``feat_counts * frame_shift`` (the tail is the
   previous buffer's suffix from ``n_new_frames * frame_shift``), so
   with block == frame_shift every tick carves blocks at the same
   absolute sample positions.
2. **Causal encoding.** A nibble depends only on earlier samples in its
   block (fixed initial step index per block — no lookahead, no
   cross-block carry), so extending a partially-filled block next tick
   never changes the nibbles already emitted for its prefix.
3. **Idempotent quantization.** The encoder picks, among all 16
   (sign, code) candidates, the reconstruction closest to the input
   (first-wins tie-break in fixed rank order +0,-0,+1,-1,...). Feeding
   a reconstruction back re-selects a candidate with that exact
   reconstruction (distance 0, and the first pass already picked the
   lowest-ranked member of its distance class), so re-encoding decoded
   values reproduces both the values AND the step-index trajectory.
   This argmin form (rather than the classic bit-serial quantizer) is
   what makes the guarantee hold under predictor clipping as well.

Contract: the WIRE is lossy (~4-bit ADPCM, between G.726 32 kbps and
telephony quality at 16 kHz); everything after it is exact — streaming
with ``wire="adpcm"`` produces bit-identical transcripts to the batch
path fed the ADPCM-reconstructed audio. The reference never pays a
wire at all (it pipes raw PCM into a same-host subprocess,
transcribe_stream.py:66-82); this is a device-serving concern.

Encode runs on the host drain (native rss_adpcm_encode_blocks, NumPy
fallback here); decode runs inside the fused tick program as a short
``lax.scan`` over the block (``decode_blocks_jnp``) — [lanes, blocks]
elementwise work per step, a sub-millisecond add to the tick.
"""

from __future__ import annotations

import numpy as np

# Standard IMA ADPCM tables (89 steps; index deltas per 3-bit code).
STEP_TABLE = np.array(
    [
        7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31,
        34, 37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130,
        143, 157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408,
        449, 494, 544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282,
        1411, 1552, 1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327,
        3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630,
        9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500, 20350,
        22385, 24623, 27086, 29794, 32767,
    ],
    dtype=np.int32,
)
INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)
# Fixed per-block initial step index: any constant is stable/causal;
# 24 (step 73) converges within a few samples for int16-scale speech.
START_IDX = 24
HDR_BYTES = 3


def block_bytes(block: int) -> int:
    """Wire bytes per block of ``block`` samples."""
    return HDR_BYTES + (block - 1 + 1) // 2


def _dequant8(step: np.ndarray) -> np.ndarray:
    """[..., 8] magnitudes for codes 0..7 at the given step(s)."""
    step = np.asarray(step, dtype=np.int32)
    c = np.arange(8, dtype=np.int32)
    return (
        (step[..., None] >> 3)
        + np.where(c & 4, step[..., None], 0)
        + np.where(c & 2, step[..., None] >> 1, 0)
        + np.where(c & 1, step[..., None] >> 2, 0)
    )


def encode_blocks(
    samples: np.ndarray, lens: np.ndarray, block: int, out: np.ndarray
) -> None:
    """Encode ``samples`` [N, W] float32 into ``out`` [N, >= nb*bpb]
    uint8 wire bytes, lane by lane; ``lens[i]`` samples of lane i are
    valid (0 = skip the lane; its out row is left untouched). Rows are
    encoded in full blocks covering ceil(len/block); the reconstructed
    (decoded) values are written back IN PLACE over ``samples`` for the
    encoded region — the scheduler carries frame-overlap tails from
    them. NumPy reference implementation; the native runtime's
    rss_adpcm_encode_blocks is byte-identical."""
    N, W = samples.shape
    bpb = block_bytes(block)
    assert W % block == 0, (W, block)
    lens = np.asarray(lens, dtype=np.int64)
    sel = np.nonzero(lens > 0)[0]
    if sel.size == 0:
        return
    n_blocks = np.minimum(-(-lens[sel] // block), W // block)
    # flatten every encoded block of every selected lane into one [M,
    # block] matrix; vectorize the serial recurrence across blocks
    rows = np.repeat(sel, n_blocks)
    blk_of = np.concatenate([np.arange(n) for n in n_blocks])
    x = samples[rows].reshape(-1, W // block, block)[
        np.arange(rows.size), blk_of
    ]  # [M, block] f32
    xi = np.clip(np.rint(x), -32768, 32767).astype(np.int32)
    M = xi.shape[0]
    recon = np.empty((M, block), dtype=np.int32)
    nibs = np.zeros((M, block), dtype=np.uint8)  # nib[0] unused
    pred = xi[:, 0]
    recon[:, 0] = pred
    idx = np.full(M, START_IDX, dtype=np.int32)
    ar = np.arange(M)
    for t in range(1, block):
        dq = _dequant8(STEP_TABLE[idx])  # [M, 8]
        # rank order +c0, -c0, +c1, -c1, ... — argmin's first-wins
        # tie-break IS the stability tie-break (module docstring)
        cand = np.empty((M, 16), dtype=np.int32)
        cand[:, 0::2] = np.clip(pred[:, None] + dq, -32768, 32767)
        cand[:, 1::2] = np.clip(pred[:, None] - dq, -32768, 32767)
        r = np.argmin(np.abs(xi[:, t, None].astype(np.int64) - cand), axis=1)
        pred = cand[ar, r]
        code = (r >> 1).astype(np.int32)
        nibs[:, t] = ((r & 1) << 3 | code).astype(np.uint8)
        recon[:, t] = pred
        idx = np.clip(idx + INDEX_TABLE[code], 0, 88)
    # pack: header (int16 LE first sample + start idx) and nibbles
    packed = np.zeros((M, bpb), dtype=np.uint8)
    s0 = recon[:, 0]
    packed[:, 0] = (s0 & 0xFF).astype(np.uint8)
    packed[:, 1] = ((s0 >> 8) & 0xFF).astype(np.uint8)
    packed[:, 2] = START_IDX
    tail = nibs[:, 1:]
    if tail.shape[1] % 2:
        tail = np.concatenate(
            [tail, np.zeros((M, 1), dtype=np.uint8)], axis=1
        )
    packed[:, HDR_BYTES:] = tail[:, 0::2] | (tail[:, 1::2] << 4)
    out_cols = (blk_of[:, None] * bpb + np.arange(bpb)[None, :]).astype(
        np.int64
    )
    out[rows[:, None], out_cols] = packed
    rec_cols = (blk_of[:, None] * block + np.arange(block)[None, :]).astype(
        np.int64
    )
    samples[rows[:, None], rec_cols] = recon.astype(np.float32)


def decode_blocks(b: np.ndarray, block: int) -> np.ndarray:
    """uint8 wire bytes [N, nb*bpb] -> float32 samples [N, nb*block].
    NumPy reference; must match decode_blocks_jnp bit-for-bit."""
    bpb = block_bytes(block)
    N = b.shape[0]
    nb = b.shape[1] // bpb
    blk = b.reshape(N, nb, bpb).astype(np.int32)
    s0 = blk[..., 0] | (blk[..., 1] << 8)
    s0 = s0 - 2 * (s0 & 0x8000)
    idx = np.clip(blk[..., 2], 0, 88)
    payload = blk[..., HDR_BYTES:]
    nibs = np.empty((N, nb, 2 * (bpb - HDR_BYTES)), dtype=np.int32)
    nibs[..., 0::2] = payload & 0xF
    nibs[..., 1::2] = payload >> 4
    out = np.empty((N, nb, block), dtype=np.int32)
    pred = s0
    out[..., 0] = pred
    for t in range(1, block):
        nib = nibs[..., t - 1]
        code = nib & 7
        step = STEP_TABLE[idx]
        dq = (
            (step >> 3)
            + np.where(code & 4, step, 0)
            + np.where(code & 2, step >> 1, 0)
            + np.where(code & 1, step >> 2, 0)
        )
        pred = np.clip(pred + np.where(nib & 8, -dq, dq), -32768, 32767)
        out[..., t] = pred
        idx = np.clip(idx + INDEX_TABLE[code], 0, 88)
    return out.reshape(N, nb * block).astype(np.float32)


def decode_blocks_jnp(b, block: int):
    """Device ADPCM decode: uint8 [N, nb*bpb] -> float32 [N, nb*block].

    One ``lax.scan`` of block-1 steps over [N*nb] int32 vectors — tiny
    elementwise work per step (two 89/8-entry table gathers, adds,
    clips), fused into the serving tick program ahead of the MFCC."""
    import jax
    import jax.numpy as jnp

    bpb = block_bytes(block)
    N = b.shape[0]
    nb = b.shape[1] // bpb
    blk = b.reshape(N * nb, bpb).astype(jnp.int32)
    s0 = blk[:, 0] | (blk[:, 1] << 8)
    s0 = s0 - 2 * (s0 & 0x8000)
    idx0 = jnp.clip(blk[:, 2], 0, 88)
    payload = blk[:, HDR_BYTES:]
    nibs = jnp.stack([payload & 0xF, payload >> 4], axis=-1).reshape(
        N * nb, 2 * (bpb - HDR_BYTES)
    )[:, : block - 1]
    step_t = jnp.asarray(STEP_TABLE)
    idx_t = jnp.asarray(INDEX_TABLE)

    def step_fn(carry, nib):
        pred, idx = carry
        code = nib & 7
        step = step_t[idx]
        dq = (
            (step >> 3)
            + jnp.where(code & 4, step, 0)
            + jnp.where(code & 2, step >> 1, 0)
            + jnp.where(code & 1, step >> 2, 0)
        )
        pred = jnp.clip(
            pred + jnp.where(nib & 8, -dq, dq), -32768, 32767
        )
        idx = jnp.clip(idx + idx_t[code], 0, 88)
        return (pred, idx), pred

    (_, _), rest = jax.lax.scan(
        step_fn, (s0, idx0), nibs.T, unroll=8
    )  # rest: [block-1, N*nb]
    out = jnp.concatenate([s0[None, :], rest], axis=0)  # [block, N*nb]
    return (
        out.T.reshape(N, nb, block).reshape(N, nb * block).astype(jnp.float32)
    )
