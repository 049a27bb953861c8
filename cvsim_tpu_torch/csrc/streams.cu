// The per-line inputs of both chains in one launch: field_streams, a CTA a
// field, writing what models/yiq.py field_streams computes from plain
// PyTorch ops (phase xi, the five stage keys, the dropout mask, the
// head-switch shifts, the chroma-phase sin/cos).
//
// Replaces no TPU kernel: the JAX package computes these streams with XLA
// ops around its Pallas kernels. On the card the plain version is some
// 500 eager launches (the head-switch decay alone is a 126-step loop of
// divisions) and four blocking copies of the blocked walk's constants, a
// few kilobytes of output for the whole batch. Here every output of a
// field comes from one CTA: the stage keys and the head-switch geometry
// are a few scalars that every thread computes, and the 128 threads stride
// over the lines for xi, the mask, the shifts and the walk's draws. What
// bounds it is latency: the walk's 128-line blocks are serial chains of 2
// float32 operations a line, one thread a block.
//
// Bits. Every output equals the plain version's:
// - the words are the splitmix32 counter stream of noise.cuh;
// - the head-switch geometry is float32 arithmetic with one rounding an
//   operation (__fmul_rn, __fadd_rn, __fsub_rn; built with -fmad=false),
//   then C's truncation and a wrap to uint32, as _head_switch_geometry;
// - the decay trunc(a * 7 / 8) is integer arithmetic;
// - the chroma-phase walk is ops/blocked_iir.iir_lowpass_blocked's at
//   alpha 0.5, y0 0: 128-line blocks, each a product with the lower
//   triangle T[t][j] = 2^-(t-j+1) from a zero carry, plus d[t] = 2^-(t+1)
//   times the carry into the block, c' = e + 2^-128 c over the blocks' last
//   zero-carry values e. The steps u are integers, so every product in T
//   is exact, and a sum over j ascending (pole.cuh's order) rounds as the
//   walk n = (n + u) * 0.5 from 0 within the block, scaled by a power of
//   two: so a thread runs that walk over its block, and the carry terms
//   are added as the plain version adds them. The plain version's matmul
//   sums in that order on the CPU, and on the card from 64 fields (128
//   rows) up; below that cuBLAS takes another order, whose floats differ
//   and, rarely, a truncation too. tests/test_torch_streams.py holds the
//   floats equal to the CPU's on 20,000 fields a configuration.
//   trunc(walk) takes 2 * mag + 1 values, so sin and cos come from a table
//   of them that the wrapper builds with the plain version's own torch ops
//   (models/yiq.phase_sincos), and a walk in (-1, 0), which truncates to
//   -0.0, reads the table's last entry, sin and cos of -0.0.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "noise.cuh"

namespace cvsim {
namespace streams {

// Mirror: models/fused_yiq._StreamsParams (field order matters).
struct StreamsParams {
  int b, l;                   // fields, lines (a row shard: the field's)
  uint32_t key;               // the u32 stream seed
  int fieldno_bytes, parity_bytes;  // 4 (int32) or 8 (int64) a field
  int gen1, ntsc;
  int phase_shift, phase_offset;
  int phase_mag;              // chroma phase noise (0: off)
  int chroma_loss;            // out of 100000 a line
  int head_switching;
  int twidth, vis_off;        // w + w/10; 2 * (invisible lines a field)
  float hs_point, hs_phase;   // float32 of the configuration's values
  float hs_phase_noise;       // 0: no draw (the plain version adds +-0)
  float hs_t;                 // float32 of twidth * lines a field
};

__device__ inline uint32_t low_word(const void* p, int bytes, int k) {
  return bytes == 8 ? (uint32_t) static_cast<const long long*>(p)[k]
                    : (uint32_t) static_cast<const int*>(p)[k];
}

// field_stage_keys: mix32(key ^ mix32(stage * 0x632BE59B) + fieldno * GOLD)
__device__ inline uint32_t stage_key(uint32_t key, uint32_t fn,
                                     uint32_t stage) {
  return mix32((key ^ mix32(stage * 0x632BE59Bu)) + fn * GOLD);
}

// word idx of stream key
__device__ inline uint32_t word(uint32_t key, uint32_t idx) {
  return mix32(key + idx * GOLD);
}

// the reference's fmod/unsigned-cast geometry: the fraction of v, times
// t, truncated to int32 and wrapped to uint32
__device__ inline uint32_t wrap_u32(float v, float t) {
  const float f = __fsub_rn(v, truncf(v));
  return (uint32_t)(int)truncf(__fmul_rn(f, t));
}

// int32 xi of frame row y (scanline_phase_xi), in uint32 arithmetic: only
// the low two bits are kept, which wrap the same
__device__ inline int phase_xi(const StreamsParams& P, uint32_t fn,
                               uint32_t par, int line) {
  const uint32_t y = par + 2u * (uint32_t)line;
  const uint32_t half = (uint32_t)((int)y >> 1);
  const uint32_t off = (uint32_t)P.phase_offset;
  if (!P.ntsc && P.gen1) return (int)((fn + y) & 3u);
  switch (P.phase_shift) {
    case 90: return (int)((fn + off + half) & 3u);
    case 180: return (int)((((fn + y) & 2u) + off) & 3u);
    case 270: return (int)((fn + off - half) & 3u);
    default: return P.gen1 ? 0 : (int)(off & 3u);
  }
}

// applied(k) of head_switch_shifts: 0, ishif, then trunc(a * 7 / 8)
__device__ inline int decayed(long long ishif, long long k) {
  if (k < 1) return 0;
  long long a = ishif;
  for (long long j = 2; j <= k && a != 0; ++j) a = a * 7 / 8;
  return (int)a;
}

constexpr int HS_KMAX = 128;   // models/yiq.py _HS_KMAX
// the walk's blocks that iir_lowpass_blocked carries with its loop (nb <=
// 16, 2048 lines); a longer walk takes its associative scan instead
constexpr int WALK_BLOCKS = 16;

// word t of k3 as a walk step in -mag..mag, as randint_per_field draws it:
// a floored remainder (torch's %), so that a negative mag draws alike
__device__ inline float walk_draw(uint32_t k3, int t, int mag) {
  const long long span = 2LL * mag + 1;
  long long r = (long long)word(k3, (uint32_t)t) % span;
  if (r != 0 && (r < 0) != (span < 0)) r += span;
  return (float)(r - mag);
}

}  // namespace streams

// Dynamic shared memory: with phase noise, the walk (the field's lines,
// whole blocks) and WALK_BLOCKS carries; else none.
__global__ void __launch_bounds__(BLOCK)
field_streams(const void* __restrict__ fieldno,
              const void* __restrict__ parity,
              const float* __restrict__ table, streams::StreamsParams P,
              int* __restrict__ xi, long long* __restrict__ keys_ab,
              float* __restrict__ sincos, float* __restrict__ keep,
              int* __restrict__ shifts) {
  using namespace streams;
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const uint32_t fn = low_word(fieldno, P.fieldno_bytes, b);
  const uint32_t par = low_word(parity, P.parity_bytes, b);
  const uint32_t k1 = stage_key(P.key, fn, 1);
  const uint32_t k3 = stage_key(P.key, fn, 3);
  const uint32_t k4 = stage_key(P.key, fn, 4);
  const size_t row = (size_t)b * P.l;
  if (threadIdx.x == 0) {
    keys_ab[2 * b] = stage_key(P.key, fn, 0);
    keys_ab[2 * b + 1] = stage_key(P.key, fn, 2);
  }

  // _head_switch_geometry; the parity cancels out of l_start, since the
  // invisible rows vis_off are even
  long long ishif = 0, l_start = 0;
  if (P.head_switching) {
    float noise = 0.f;
    if (P.hs_phase_noise != 0.f) {
      const float u = __fsub_rn(
          __fmul_rn((float)(word(k1, 0) >> 8), 0x1p-23f), 1.f);
      noise = __fmul_rn(u, P.hs_phase_noise);
    }
    const uint32_t p_y = wrap_u32(__fadd_rn(P.hs_point, noise), P.hs_t);
    const uint32_t p_x = wrap_u32(__fadd_rn(P.hs_phase, noise), P.hs_t);
    const long long x_pos = (long long)(p_x % (uint32_t)P.twidth);
    ishif = x_pos >= P.twidth / 2 ? x_pos - P.twidth : x_pos;
    l_start = (long long)(p_y / (uint32_t)P.twidth) - P.vis_off / 2;
  }

  for (int line = threadIdx.x; line < P.l; line += BLOCK) {
    const size_t at = row + line;
    xi[at] = phase_xi(P, fn, par, line);
    keep[at] =
        (long long)(word(k4, (uint32_t)line) % 100000u) >= P.chroma_loss
            ? 1.f : 0.f;
    const long long k = line - l_start;
    shifts[at] = P.head_switching && k >= 0 && k < HS_KMAX
                     ? decayed(ishif, k) : 0;
    if (P.phase_mag == 0) {
      sincos[2 * at] = 0.f;
      sincos[2 * at + 1] = 1.f;
    }
  }
  if (P.phase_mag == 0) return;

  // random_walk_per_field (see the top): the steps, each block's walk from
  // a zero carry on a thread of its own, the carries into the blocks on
  // thread 0, then each line's carry term and the table entry of its
  // truncation, which lies in +-|mag|
  const int nb = (P.l + BLOCK - 1) / BLOCK;
  float* walk = sm;
  float* carry = sm + nb * BLOCK;
  for (int t = threadIdx.x; t < P.l; t += BLOCK)
    walk[t] = walk_draw(k3, t, P.phase_mag);
  __syncthreads();
  if ((int)threadIdx.x < nb) {
    const int t0 = threadIdx.x * BLOCK, t1 = min(t0 + BLOCK, P.l);
    float n = 0.f;
    for (int t = t0; t < t1; ++t) {
      n = __fmul_rn(__fadd_rn(n, walk[t]), 0.5f);
      walk[t] = n;
    }
    carry[threadIdx.x] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;   // y0
    for (int q = 0; q < nb; ++q) {
      const float e = carry[q];
      carry[q] = c;
      c = __fadd_rn(e, __fmul_rn(0x1p-128f, c));
    }
  }
  __syncthreads();
  const int half = P.phase_mag < 0 ? -P.phase_mag : P.phase_mag;
  for (int t = threadIdx.x; t < P.l; t += BLOCK) {
    const float d = ldexpf(1.f, -(t % BLOCK + 1));
    const float n = __fadd_rn(walk[t], __fmul_rn(d, carry[t / BLOCK]));
    const float k = truncf(n);
    const int e = k == 0.f && n < 0.f ? 2 * half + 1 : (int)k + half;
    sincos[2 * (row + t)] = table[2 * e];
    sincos[2 * (row + t) + 1] = table[2 * e + 1];
  }
}

}  // namespace cvsim

// C entry point (bound with ctypes by cvsim_tpu_torch/kernels.py).
// fieldno, parity: [b] int32 or int64 (params says which); table: f32
// [2m + 2, 2] (sin, cos) of trunc(walk) = -m .. m, then of -0.0, with
// m = |phase_mag| (unused when phase_mag is 0); out: xi int32
// [b, l], keys_ab int64 [b, 2], sincos f32 [b, l, 2], keep f32 [b, l],
// shifts int32 [b, l]; all contiguous. One CTA a field. Launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// phase-noise walk longer than WALK_BLOCKS blocks (2048 lines).
extern "C" int cvsim_field_streams(const void* fieldno, const void* parity,
                                   const void* table, void* xi,
                                   void* keys_ab, void* sincos, void* keep,
                                   void* shifts, const void* params,
                                   void* stream) {
  using namespace cvsim;
  using streams::StreamsParams;
  using streams::WALK_BLOCKS;
  const StreamsParams P = *static_cast<const StreamsParams*>(params);
  const int nb = (P.l + BLOCK - 1) / BLOCK;
  if (P.b < 0 || P.l < 0 || P.twidth <= 0 ||
      (P.phase_mag != 0 && nb > WALK_BLOCKS))
    return (int)cudaErrorInvalidValue;
  if (P.b == 0) return 0;
  const size_t smem =
      P.phase_mag != 0 ? (nb * BLOCK + WALK_BLOCKS) * sizeof(float) : 0;
  field_streams<<<P.b, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      fieldno, parity, static_cast<const float*>(table), P,
      static_cast<int*>(xi), static_cast<long long*>(keys_ab),
      static_cast<float*>(sincos), static_cast<float*>(keep),
      static_cast<int*>(shifts));
  return (int)cudaGetLastError();
}
