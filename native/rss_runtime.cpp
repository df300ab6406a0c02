// rss_runtime: native audio-ingestion + stream-pool runtime.
//
// The reference delegates all native work to Kaldi/OpenFST subprocesses and
// an external sox for resampling (reference: tests/resample.py, and the
// 16 kHz mono requirement in rhasspy_speech/transcribe_wav.py). This library
// is this framework's equivalent of that ingestion layer, in-process:
//
//  - WAV (RIFF s16le) parsing with channel mixdown,
//  - windowed-sinc rational resampling to 16 kHz,
//  - a fixed-slot PCM ring-buffer pool feeding the batched streaming
//    scheduler (one slot per concurrent stream; the Python side drains
//    whole 16e3*0.21s chunks for the device decode step).
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#if defined(__AVX512F__)
#include <immintrin.h>
#endif
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV parsing
// ---------------------------------------------------------------------------

// Parse a RIFF/WAVE buffer; returns 0 on success. Fills *out_rate,
// *out_channels, *out_num_samples (per channel). If out_pcm is non-null it
// must hold num_samples floats; samples are mixed down to mono float32 in
// int16 range.
int rss_wav_info(const uint8_t *data, int64_t size, int32_t *out_rate,
                 int32_t *out_channels, int64_t *out_num_samples) {
  if (size < 44 || memcmp(data, "RIFF", 4) != 0 ||
      memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  int32_t rate = 0;
  int16_t channels = 0, bits = 0, format = 0;
  int64_t data_off = -1, data_len = 0;
  while (pos + 8 <= size) {
    const uint8_t *hdr = data + pos;
    uint32_t chunk_len;
    memcpy(&chunk_len, hdr + 4, 4);
    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      memcpy(&format, hdr + 8, 2);
      memcpy(&channels, hdr + 10, 2);
      memcpy(&rate, hdr + 12, 4);
      memcpy(&bits, hdr + 22, 2);
    } else if (memcmp(hdr, "data", 4) == 0) {
      data_off = pos + 8;
      data_len = chunk_len;
      if (data_off + data_len > size) data_len = size - data_off;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (rate <= 0 || channels <= 0 || data_off < 0) return -2;
  if (format != 1 || bits != 16) return -3;  // PCM s16le only
  *out_rate = rate;
  *out_channels = channels;
  *out_num_samples = data_len / (2 * channels);
  return 0;
}

int rss_wav_decode(const uint8_t *data, int64_t size, float *out_pcm,
                   int64_t max_samples) {
  int32_t rate, channels;
  int64_t num_samples;
  int rc = rss_wav_info(data, size, &rate, &channels, &num_samples);
  if (rc != 0) return rc;
  if (num_samples > max_samples) return -4;

  // find data chunk again
  int64_t pos = 12, data_off = -1;
  while (pos + 8 <= size) {
    const uint8_t *hdr = data + pos;
    uint32_t chunk_len;
    memcpy(&chunk_len, hdr + 4, 4);
    if (memcmp(hdr, "data", 4) == 0) {
      data_off = pos + 8;
      break;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  const int16_t *pcm16 = reinterpret_cast<const int16_t *>(data + data_off);
  if (channels == 1) {
    for (int64_t i = 0; i < num_samples; i++) out_pcm[i] = (float)pcm16[i];
  } else {
    for (int64_t i = 0; i < num_samples; i++) {
      int32_t acc = 0;
      for (int32_t c = 0; c < channels; c++) acc += pcm16[i * channels + c];
      out_pcm[i] = (float)acc / (float)channels;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Windowed-sinc rational resampler
// ---------------------------------------------------------------------------

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Output length for resampling n samples from in_rate to out_rate.
int64_t rss_resample_out_len(int64_t n, int32_t in_rate, int32_t out_rate) {
  return (n * (int64_t)out_rate) / in_rate;
}

// Polyphase windowed-sinc resampler (Hann window, zero-phase), cutoff at
// 0.9 * min(in, out) Nyquist. out must hold rss_resample_out_len samples.
int rss_resample(const float *in, int64_t n, int32_t in_rate,
                 int32_t out_rate, float *out) {
  if (in_rate == out_rate) {
    memcpy(out, in, sizeof(float) * n);
    return 0;
  }
  const int64_t g = gcd64(in_rate, out_rate);
  const int64_t up = out_rate / g, down = in_rate / g;
  const double cutoff = 0.45 * std::min(in_rate, out_rate);  // Hz
  const int half_taps = 16;  // zero crossings per side at the LOWER rate
  const double fc = cutoff / in_rate;        // normalized to input rate
  const double support = half_taps / (2.0 * fc);  // input samples per side

  const int64_t out_len = rss_resample_out_len(n, in_rate, out_rate);
  for (int64_t j = 0; j < out_len; j++) {
    // center position in input samples: j * down / up
    const double center = (double)(j * down) / (double)up;
    const int64_t lo = (int64_t)std::ceil(center - support);
    const int64_t hi = (int64_t)std::floor(center + support);
    double acc = 0.0, norm = 0.0;
    for (int64_t i = std::max<int64_t>(lo, 0);
         i <= std::min<int64_t>(hi, n - 1); i++) {
      const double x = (double)i - center;
      const double arg = 2.0 * M_PI * fc * x;
      const double sinc = (std::fabs(arg) < 1e-9) ? 1.0 : std::sin(arg) / arg;
      const double win =
          0.5 + 0.5 * std::cos(M_PI * x / (support + 1e-9));
      const double w = sinc * win;
      acc += w * (double)in[i];
      norm += w;
    }
    out[j] = (norm > 1e-12) ? (float)(acc / norm) : 0.0f;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Stream ring-buffer pool
// ---------------------------------------------------------------------------

struct StreamSlot {
  std::vector<float> ring;
  int64_t write_pos = 0;   // total samples ever written
  int64_t read_pos = 0;    // total samples ever consumed
  bool active = false;
  bool finished = false;   // EOF signalled
  // Every sample fed since open() round-trips exactly through int16
  // (tracked while the data is cache-hot, so the batched drain can emit
  // half-width int16 rows without a rescan).
  bool i16_exact = true;
};

struct StreamPool {
  std::vector<StreamSlot> slots;
  int64_t capacity;  // per-slot ring capacity in samples
  std::mutex mu;
};

void *rss_pool_create(int32_t num_slots, int64_t capacity_samples) {
  auto *pool = new StreamPool();
  pool->slots.resize(num_slots);
  pool->capacity = capacity_samples;
  for (auto &s : pool->slots) s.ring.resize(capacity_samples);
  return pool;
}

void rss_pool_destroy(void *p) { delete static_cast<StreamPool *>(p); }

// Claim a free slot; returns slot id or -1.
int32_t rss_pool_open(void *p) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  for (size_t i = 0; i < pool->slots.size(); i++) {
    if (!pool->slots[i].active) {
      auto &s = pool->slots[i];
      s.active = true;
      s.finished = false;
      s.i16_exact = true;
      s.write_pos = s.read_pos = 0;
      return (int32_t)i;
    }
  }
  return -1;
}

// Open a SPECIFIC slot (mesh-aware admission: the scheduler balances
// lanes across device shards). Returns the slot, or -1 when occupied
// or out of range.
int32_t rss_pool_open_at(void *p, int32_t slot) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  if (slot < 0 || (size_t)slot >= pool->slots.size()) return -1;
  auto &s = pool->slots[slot];
  if (s.active) return -1;
  s.active = true;
  s.finished = false;
  s.i16_exact = true;
  s.write_pos = s.read_pos = 0;
  return slot;
}

// Append PCM; returns samples accepted (may be < n when the ring is full).
int64_t rss_pool_feed(void *p, int32_t slot, const float *pcm, int64_t n) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  auto &s = pool->slots[slot];
  if (!s.active || s.finished) return -1;
  const int64_t free_space = pool->capacity - (s.write_pos - s.read_pos);
  const int64_t take = std::min(free_space, n);
  // two contiguous segments instead of a per-sample modulo loop
  const int64_t w0 = s.write_pos % pool->capacity;
  const int64_t seg1 = std::min(take, pool->capacity - w0);
  memcpy(s.ring.data() + w0, pcm, seg1 * sizeof(float));
  if (take > seg1) memcpy(s.ring.data(), pcm + seg1, (take - seg1) * sizeof(float));
  if (s.i16_exact) {
    for (int64_t i = 0; i < take; i++) {
      const float v = pcm[i];
      // matches the Python check: integral and |v| <= 32767 (the cast
      // is range-checked first — float->int16 out of range is UB)
      if (!(v >= -32767.0f && v <= 32767.0f) || v != truncf(v)) {
        s.i16_exact = false;
        break;
      }
    }
  }
  s.write_pos += take;
  return take;
}

int64_t rss_pool_feed_i16(void *p, int32_t slot, const int16_t *pcm,
                          int64_t n) {
  // int16 wire-format feed: widen into the f32 ring without the
  // per-sample exactness scan (int16 is exact by construction) — the
  // feed path's hot cost at high lane counts was truncf over every
  // sample of every chunk.
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  auto &s = pool->slots[slot];
  if (!s.active || s.finished) return -1;
  const int64_t free_space = pool->capacity - (s.write_pos - s.read_pos);
  const int64_t take = std::min(free_space, n);
  const int64_t w0 = s.write_pos % pool->capacity;
  const int64_t seg1 = std::min(take, pool->capacity - w0);
  float *dst = s.ring.data() + w0;
  for (int64_t i = 0; i < seg1; i++) dst[i] = static_cast<float>(pcm[i]);
  if (take > seg1) {
    dst = s.ring.data();
    const int16_t *src = pcm + seg1;
    for (int64_t i = 0; i < take - seg1; i++)
      dst[i] = static_cast<float>(src[i]);
  }
  s.write_pos += take;
  return take;
}

void rss_pool_finish(void *p, int32_t slot) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  pool->slots[slot].finished = true;
}

// Samples available to read.
int64_t rss_pool_available(void *p, int32_t slot) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  auto &s = pool->slots[slot];
  return s.write_pos - s.read_pos;
}

int32_t rss_pool_is_finished(void *p, int32_t slot) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  return pool->slots[slot].finished ? 1 : 0;
}

// Pop up to n samples into out; returns count actually read.
int64_t rss_pool_read(void *p, int32_t slot, float *out, int64_t n) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  auto &s = pool->slots[slot];
  const int64_t avail = s.write_pos - s.read_pos;
  const int64_t take = std::min(avail, n);
  const int64_t r0 = s.read_pos % pool->capacity;
  const int64_t seg1 = std::min(take, pool->capacity - r0);
  memcpy(out, s.ring.data() + r0, seg1 * sizeof(float));
  if (take > seg1) memcpy(out + seg1, s.ring.data(), (take - seg1) * sizeof(float));
  s.read_pos += take;
  return take;
}

// Per-slot drain snapshot in ONE call (the batched scheduler makes one of
// these per tick instead of num_slots rss_pool_available calls):
// counts[i] = readable samples; flags[i] = bit0 active | bit1 finished |
// bit2 i16-exact-since-open.
void rss_pool_snapshot(void *p, int64_t *counts, int32_t *flags) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  for (size_t i = 0; i < pool->slots.size(); i++) {
    auto &s = pool->slots[i];
    counts[i] = s.active ? (s.write_pos - s.read_pos) : 0;
    flags[i] = (s.active ? 1 : 0) | (s.finished ? 2 : 0) |
               (s.i16_exact ? 4 : 0);
  }
}

// Batched drain: for every slot i with counts[i] > 0, pop exactly
// counts[i] samples (must be <= available; counts normally comes straight
// from rss_pool_snapshot) into row i of a [num_slots, stride] row-major
// matrix at column offs[i] (the caller's frame-tail length). With
// as_i16 != 0 samples are written int16 into out16 (valid only when the
// drained slots are i16-exact); otherwise float32 into out_f32. ONE call
// per scheduler tick replaces num_slots rss_pool_read round trips.
// Returns 0, or -1 when any counts[i] exceeds that slot's available.
int32_t rss_pool_read_all(void *p, float *out_f32, int16_t *out_i16,
                          int32_t as_i16, int64_t stride,
                          const int64_t *offs, const int64_t *counts) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  for (size_t i = 0; i < pool->slots.size(); i++) {
    if (counts[i] > pool->slots[i].write_pos - pool->slots[i].read_pos)
      return -1;
  }
  for (size_t i = 0; i < pool->slots.size(); i++) {
    const int64_t take = counts[i];
    if (take <= 0) continue;
    auto &s = pool->slots[i];
    const int64_t r0 = s.read_pos % pool->capacity;
    const int64_t seg1 = std::min(take, pool->capacity - r0);
    if (as_i16) {
      int16_t *row = out_i16 + (int64_t)i * stride + offs[i];
      for (int64_t j = 0; j < seg1; j++) row[j] = (int16_t)s.ring[r0 + j];
      for (int64_t j = seg1; j < take; j++) row[j] = (int16_t)s.ring[j - seg1];
    } else {
      float *row = out_f32 + (int64_t)i * stride + offs[i];
      memcpy(row, s.ring.data() + r0, seg1 * sizeof(float));
      if (take > seg1)
        memcpy(row + seg1, s.ring.data(), (take - seg1) * sizeof(float));
    }
    s.read_pos += take;
  }
  return 0;
}

// G.711 mu-law encode (Sun g711.c segment layout: bias 0x84, clip
// 32635, truncating mantissa, complemented codeword). The Python
// ops.mulaw module holds the matching decoder (a 256-entry table the
// device program gathers from). Encoding runs on every drained sample
// of every lane each tick, so it goes through a 64 KiB int16->codeword
// LUT (the formula-per-sample loop measured ~85 ms/tick at 512 lanes x
// 0.63 s chunks; the LUT is one L2-resident table lookup per sample).
static uint8_t g_mulaw_lut[65536];
static std::once_flag g_mulaw_once;

static uint8_t mulaw_encode_one(int32_t x) {
  const int32_t sign = x < 0 ? 0x80 : 0;
  int32_t mag = (x < 0 ? -x : x);
  if (mag > 32635) mag = 32635;
  mag += 0x84;
  int32_t exp = 7;
  for (int32_t probe = 0x4000; (mag & probe) == 0 && exp > 0; probe >>= 1)
    exp--;
  const int32_t mant = (mag >> (exp + 3)) & 0x0F;
  return (uint8_t)(~(sign | (exp << 4) | mant) & 0xFF);
}

static void mulaw_init_lut() {
  for (int32_t i = 0; i < 65536; i++)
    g_mulaw_lut[(uint16_t)i] = mulaw_encode_one((int16_t)(uint16_t)i);
}

static inline uint8_t mulaw_encode(float v) {
  int32_t x = (int32_t)lrintf(v);
  if (x > 32767) x = 32767;
  if (x < -32768) x = -32768;
  return g_mulaw_lut[(uint16_t)(int16_t)x];
}

// Batched mu-law drain: like rss_pool_read_all, but every drained sample
// is G.711 mu-law encoded into a uint8 row (the 8-bit serving wire —
// HALF the per-tick H2D bytes of the int16 batch on remote-dispatch
// transports). Returns 0, or -1 when any counts[i] exceeds available.
int32_t rss_pool_read_all_mulaw(void *p, uint8_t *out, int64_t stride,
                                const int64_t *offs, const int64_t *counts) {
  auto *pool = static_cast<StreamPool *>(p);
  std::call_once(g_mulaw_once, mulaw_init_lut);
  std::lock_guard<std::mutex> lock(pool->mu);
  for (size_t i = 0; i < pool->slots.size(); i++) {
    if (counts[i] > pool->slots[i].write_pos - pool->slots[i].read_pos)
      return -1;
  }
  for (size_t i = 0; i < pool->slots.size(); i++) {
    const int64_t take = counts[i];
    if (take <= 0) continue;
    auto &s = pool->slots[i];
    const int64_t r0 = s.read_pos % pool->capacity;
    const int64_t seg1 = std::min(take, pool->capacity - r0);
    uint8_t *row = out + (int64_t)i * stride + offs[i];
    for (int64_t j = 0; j < seg1; j++) row[j] = mulaw_encode(s.ring[r0 + j]);
    for (int64_t j = seg1; j < take; j++)
      row[j] = mulaw_encode(s.ring[j - seg1]);
    s.read_pos += take;
  }
  return 0;
}

// 4-bit block-ADPCM encoder for the serving wire (ops/adpcm.py holds
// the matching decoder + the NumPy reference this must match byte-for-
// byte). Blocks of `block` samples: 3-byte header (exact int16 LE
// first sample + start step index) then 4-bit nibbles, low first.
// Quantization is argmin over the 16 (sign, code) reconstructions in
// rank order +0,-0,+1,-1,... (first-wins ties) — the property that
// makes re-encoding decoded frame-overlap tails reproduce the exact
// bytes AND values across ticks, including under predictor clipping.
// Reconstructed values are written back IN PLACE over `samples`.
static const int32_t g_adpcm_step[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};
static const int32_t g_adpcm_index[8] = {-1, -1, -1, -1, 2, 4, 6, 8};
static const int32_t kAdpcmStartIdx = 24;
// dequant magnitudes per (step index, code), built once: the hot loop
// must not recompute the shift/mask form per candidate (the serving
// drain encodes ~5M samples/tick at 512 lanes — the naive 16-candidate
// scalar loop measured 258 ms/tick of host time and throttled the
// whole serving pipeline; this table + the keyed argmin + lane threads
// below bring it to single-digit ms)
static int32_t g_adpcm_dq[89][8];
static std::once_flag g_adpcm_dq_once;
static void adpcm_init_dq() {
  for (int i = 0; i < 89; i++) {
    const int32_t step = g_adpcm_step[i];
    for (int32_t c = 0; c < 8; c++)
      g_adpcm_dq[i][c] = (step >> 3) + ((c & 4) ? step : 0) +
                         ((c & 2) ? (step >> 1) : 0) +
                         ((c & 1) ? (step >> 2) : 0);
  }
}

static void adpcm_encode_lane_range(float *samples, int64_t w,
                                    const int64_t *lens, int64_t block,
                                    uint8_t *out, int64_t out_stride,
                                    int64_t lane0, int64_t lane1) {
  const int64_t bpb = 3 + block / 2;  // block-1 nibbles, padded to bytes
  const int64_t nb_row = w / block;
  for (int64_t lane = lane0; lane < lane1; lane++) {
    const int64_t len = lens[lane];
    if (len <= 0) continue;
    int64_t nb = (len + block - 1) / block;
    if (nb > nb_row) nb = nb_row;
    float *row = samples + lane * w;
    uint8_t *orow = out + lane * out_stride;
    for (int64_t b = 0; b < nb; b++) {
      float *x = row + b * block;
      uint8_t *o = orow + b * bpb;
      int32_t v0 = (int32_t)lrintf(x[0]);
      if (v0 > 32767) v0 = 32767;
      if (v0 < -32768) v0 = -32768;
      o[0] = (uint8_t)(v0 & 0xFF);
      o[1] = (uint8_t)((v0 >> 8) & 0xFF);
      o[2] = (uint8_t)kAdpcmStartIdx;
      int32_t pred = v0, idx = kAdpcmStartIdx;
      x[0] = (float)pred;
      for (int64_t t = 1; t < block; t++) {
        int32_t xi = (int32_t)lrintf(x[t]);
        if (xi > 32767) xi = 32767;
        if (xi < -32768) xi = -32768;
        const int32_t *dq = g_adpcm_dq[idx];
        // exact rank-ordered argmin (+0,-0,+1,-1,...) via a single
        // keyed min: key = dist*16 + rank — ranks are distinct mod 16
        // so ties in distance resolve to the lowest rank exactly as
        // the NumPy reference's first-wins argmin does
        int32_t best_key = INT32_MAX, best_pred = pred;
        for (int32_t c = 0; c < 8; c++) {
          int32_t rp = pred + dq[c];
          rp = rp > 32767 ? 32767 : rp;  // +dq can only clip high
          int32_t rn = pred - dq[c];
          rn = rn < -32768 ? -32768 : rn;  // -dq only low
          int32_t dp = rp - xi;
          dp = dp < 0 ? -dp : dp;
          int32_t dn = rn - xi;
          dn = dn < 0 ? -dn : dn;
          const int32_t kp = dp * 16 + 2 * c;
          const int32_t kn = dn * 16 + 2 * c + 1;
          if (kp < best_key) {
            best_key = kp;
            best_pred = rp;
          }
          if (kn < best_key) {
            best_key = kn;
            best_pred = rn;
          }
        }
        const int32_t r = best_key & 15;
        const int32_t code = r >> 1;
        pred = best_pred;
        x[t] = (float)pred;
        const uint8_t nib = (uint8_t)(((r & 1) << 3) | code);
        uint8_t *pb = o + 3 + (t - 1) / 2;
        if ((t - 1) & 1)
          *pb = (uint8_t)(*pb | (nib << 4));
        else
          *pb = nib;  // low nibble first; high half starts 0
        idx += g_adpcm_index[code];
        if (idx < 0) idx = 0;
        if (idx > 88) idx = 88;
      }
    }
  }
}

#if defined(__AVX512F__)
// 16-lane lockstep encoder: the pools this serves run on few-core (often
// single-core) hosts, where the scalar 16-candidate argmin (~33 ns/sample)
// cannot feed a 512-lane drain (~5M samples/tick -> ~180 ms of host time,
// measured throttling the whole serving loop). Lanes are independent, so
// sixteen of them advance sample-by-sample in one __m512i with identical
// keyed-argmin semantics (key = dist*16 + rank, min over 16 candidates) —
// byte-identical to the scalar path and the NumPy reference.
static void adpcm_encode_lanes_avx512(float *samples, int64_t w,
                                      const int64_t *lens, int64_t block,
                                      uint8_t *out, int64_t out_stride,
                                      int64_t n_lanes) {
  const int64_t bpb = 3 + block / 2;
  const int64_t nb_row = w / block;
  std::vector<int32_t> nibtile((size_t)block * 16);
  const __m512i vmax16 = _mm512_set1_epi32(32767);
  const __m512i vmin16 = _mm512_set1_epi32(-32768);
  const __m512 fmax16 = _mm512_set1_ps(32767.0f);
  const __m512 fmin16 = _mm512_set1_ps(-32768.0f);
  for (int64_t g0 = 0; g0 < n_lanes; g0 += 16) {
    alignas(64) int32_t lane_of[16];
    alignas(64) int32_t nbl[16];
    int32_t nb_max = 0;
    for (int k = 0; k < 16; k++) {
      const int64_t lane = g0 + k;
      int32_t nb = 0;
      if (lane < n_lanes && lens[lane] > 0) {
        int64_t nbk = (lens[lane] + block - 1) / block;
        if (nbk > nb_row) nbk = nb_row;
        nb = (int32_t)nbk;
      }
      nbl[k] = nb;
      // pad/inactive lanes alias row g0 for the (masked-off) gathers
      lane_of[k] = (int32_t)(lane < n_lanes ? lane : g0);
      if (nb > nb_max) nb_max = nb;
    }
    if (nb_max == 0) continue;
    __m512i vrow = _mm512_mullo_epi32(
        _mm512_load_epi32(lane_of), _mm512_set1_epi32((int32_t)w));
    const __m512i vnbl = _mm512_load_epi32(nbl);
    for (int32_t b = 0; b < nb_max; b++) {
      const __mmask16 act =
          _mm512_cmpgt_epi32_mask(vnbl, _mm512_set1_epi32(b));
      const __m512i voff = _mm512_add_epi32(
          vrow, _mm512_set1_epi32(b * (int32_t)block));
      __m512 x0 = _mm512_i32gather_ps(voff, samples, 4);
      x0 = _mm512_min_ps(_mm512_max_ps(x0, fmin16), fmax16);
      __m512i pred = _mm512_cvtps_epi32(x0);  // MXCSR nearest-even, as lrintf
      __m512i idx = _mm512_set1_epi32(kAdpcmStartIdx);
      _mm512_mask_i32scatter_ps(samples, act, voff,
                                _mm512_cvtepi32_ps(pred), 4);
      alignas(64) int32_t s0arr[16];
      _mm512_store_epi32(s0arr, pred);
      for (int64_t t = 1; t < block; t++) {
        const __m512i offt =
            _mm512_add_epi32(voff, _mm512_set1_epi32((int32_t)t));
        __m512 xf = _mm512_i32gather_ps(offt, samples, 4);
        xf = _mm512_min_ps(_mm512_max_ps(xf, fmin16), fmax16);
        const __m512i xi = _mm512_cvtps_epi32(xf);
        const __m512i step = _mm512_i32gather_epi32(idx, g_adpcm_step, 4);
        const __m512i s1 = _mm512_srli_epi32(step, 1);
        const __m512i s2 = _mm512_srli_epi32(step, 2);
        const __m512i s3 = _mm512_srli_epi32(step, 3);
        __m512i best_key = _mm512_set1_epi32(INT32_MAX);
        __m512i best_pred = pred;
#define RSS_ADPCM_CAND(c, dq)                                              \
  {                                                                        \
    const __m512i rp =                                                     \
        _mm512_min_epi32(_mm512_add_epi32(pred, dq), vmax16);              \
    const __m512i rn =                                                     \
        _mm512_max_epi32(_mm512_sub_epi32(pred, dq), vmin16);              \
    const __m512i kp = _mm512_add_epi32(                                   \
        _mm512_slli_epi32(_mm512_abs_epi32(_mm512_sub_epi32(rp, xi)), 4),  \
        _mm512_set1_epi32(2 * (c)));                                       \
    const __m512i kn = _mm512_add_epi32(                                   \
        _mm512_slli_epi32(_mm512_abs_epi32(_mm512_sub_epi32(rn, xi)), 4),  \
        _mm512_set1_epi32(2 * (c) + 1));                                   \
    const __mmask16 mp = _mm512_cmplt_epi32_mask(kp, best_key);            \
    best_key = _mm512_mask_mov_epi32(best_key, mp, kp);                    \
    best_pred = _mm512_mask_mov_epi32(best_pred, mp, rp);                  \
    const __mmask16 mn = _mm512_cmplt_epi32_mask(kn, best_key);            \
    best_key = _mm512_mask_mov_epi32(best_key, mn, kn);                    \
    best_pred = _mm512_mask_mov_epi32(best_pred, mn, rn);                  \
  }
        RSS_ADPCM_CAND(0, s3)
        RSS_ADPCM_CAND(1, _mm512_add_epi32(s3, s2))
        RSS_ADPCM_CAND(2, _mm512_add_epi32(s3, s1))
        RSS_ADPCM_CAND(3, _mm512_add_epi32(s3, _mm512_add_epi32(s1, s2)))
        RSS_ADPCM_CAND(4, _mm512_add_epi32(s3, step))
        RSS_ADPCM_CAND(5,
                       _mm512_add_epi32(s3, _mm512_add_epi32(step, s2)))
        RSS_ADPCM_CAND(6,
                       _mm512_add_epi32(s3, _mm512_add_epi32(step, s1)))
        RSS_ADPCM_CAND(
            7, _mm512_add_epi32(
                   s3, _mm512_add_epi32(step, _mm512_add_epi32(s1, s2))))
#undef RSS_ADPCM_CAND
        const __m512i rank =
            _mm512_and_epi32(best_key, _mm512_set1_epi32(15));
        const __m512i code = _mm512_srli_epi32(rank, 1);
        pred = best_pred;
        _mm512_mask_i32scatter_ps(samples, act, offt,
                                  _mm512_cvtepi32_ps(pred), 4);
        const __m512i nib = _mm512_or_epi32(
            _mm512_slli_epi32(_mm512_and_epi32(rank, _mm512_set1_epi32(1)),
                              3),
            code);
        _mm512_storeu_epi32(nibtile.data() + t * 16, nib);  // heap: unaligned
        // index_table by code without a gather: {-1 x4, 2, 4, 6, 8}
        const __mmask16 lo = _mm512_cmplt_epi32_mask(
            code, _mm512_set1_epi32(4));
        const __m512i di = _mm512_mask_mov_epi32(
            _mm512_slli_epi32(
                _mm512_sub_epi32(code, _mm512_set1_epi32(3)), 1),
            lo, _mm512_set1_epi32(-1));
        idx = _mm512_min_epi32(
            _mm512_max_epi32(_mm512_add_epi32(idx, di),
                             _mm512_setzero_si512()),
            _mm512_set1_epi32(88));
      }
      for (int k = 0; k < 16; k++) {
        if (b >= nbl[k]) continue;
        uint8_t *o = out + (int64_t)lane_of[k] * out_stride + b * bpb;
        const int32_t v0 = s0arr[k];
        o[0] = (uint8_t)(v0 & 0xFF);
        o[1] = (uint8_t)((v0 >> 8) & 0xFF);
        o[2] = (uint8_t)kAdpcmStartIdx;
        const int32_t *col = nibtile.data() + k;
        for (int64_t t = 1; t < block; t++) {
          const uint8_t nb8 = (uint8_t)col[t * 16];
          uint8_t *pb = o + 3 + (t - 1) / 2;
          if ((t - 1) & 1)
            *pb = (uint8_t)(*pb | (nb8 << 4));
          else
            *pb = nb8;
        }
      }
    }
  }
}
#endif  // __AVX512F__

int32_t rss_adpcm_encode_blocks(float *samples, int64_t n_lanes, int64_t w,
                                const int64_t *lens, int64_t block,
                                uint8_t *out, int64_t out_stride) {
  if (block < 2 || w % block != 0) return -1;
  std::call_once(g_adpcm_dq_once, adpcm_init_dq);
#if defined(__AVX512F__)
  if (w <= (int64_t)INT32_MAX / (n_lanes > 0 ? n_lanes : 1)) {
    adpcm_encode_lanes_avx512(samples, w, lens, block, out, out_stride,
                              n_lanes);
    return 0;
  }
#endif
  int64_t total = 0;
  for (int64_t i = 0; i < n_lanes; i++)
    if (lens[i] > 0) total += lens[i];
  int64_t nt = (int64_t)std::thread::hardware_concurrency();
  if (nt > 8) nt = 8;
  if (nt < 1) nt = 1;
  if (total < (int64_t)256 * 1024 || nt == 1 || n_lanes < 2) {
    adpcm_encode_lane_range(samples, w, lens, block, out, out_stride, 0,
                            n_lanes);
    return 0;
  }
  if (nt > n_lanes) nt = n_lanes;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  const int64_t per = (n_lanes + nt - 1) / nt;
  for (int64_t k = 0; k < nt; k++) {
    const int64_t a = k * per;
    const int64_t z = std::min(n_lanes, a + per);
    if (a >= z) break;
    pool.emplace_back(adpcm_encode_lane_range, samples, w, lens, block, out,
                      out_stride, a, z);
  }
  for (auto &t : pool) t.join();
  return 0;
}

// Batched int16 feed: ONE lock + ONE ctypes call feeds row k of a
// [count, n] row-major int16 matrix into slots[k] — the serving loop's
// per-tick ingest (N feed() calls at ~50us of Python/ctypes overhead
// each was ~27 ms/tick at 512 lanes). taken[k] = samples accepted, or
// -1 for an inactive/finished/out-of-range slot. Always returns 0.
int32_t rss_pool_feed_i16_many(void *p, const int32_t *slots,
                               const int16_t *pcm, int64_t n,
                               int32_t count, int64_t *taken) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  for (int32_t k = 0; k < count; k++) {
    const int32_t slot = slots[k];
    const int16_t *row = pcm + (int64_t)k * n;
    if (slot < 0 || (size_t)slot >= pool->slots.size()) {
      taken[k] = -1;
      continue;
    }
    auto &s = pool->slots[slot];
    if (!s.active || s.finished) {
      taken[k] = -1;
      continue;
    }
    const int64_t free_space = pool->capacity - (s.write_pos - s.read_pos);
    const int64_t take = std::min(free_space, n);
    const int64_t w0 = s.write_pos % pool->capacity;
    const int64_t seg1 = std::min(take, pool->capacity - w0);
    float *dst = s.ring.data() + w0;
    for (int64_t i = 0; i < seg1; i++) dst[i] = static_cast<float>(row[i]);
    if (take > seg1) {
      dst = s.ring.data();
      const int16_t *src = row + seg1;
      for (int64_t i = 0; i < take - seg1; i++)
        dst[i] = static_cast<float>(src[i]);
    }
    s.write_pos += take;
    taken[k] = take;
  }
  return 0;
}

// Release a slot back to the pool.
void rss_pool_close(void *p, int32_t slot) {
  auto *pool = static_cast<StreamPool *>(p);
  std::lock_guard<std::mutex> lock(pool->mu);
  pool->slots[slot].active = false;
}

}  // extern "C"
