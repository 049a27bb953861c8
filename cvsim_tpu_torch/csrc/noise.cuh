// In-kernel noise of the composite chains, shared by yiq_chain.cu and
// yuv_chain.cu.
//
// The words are the splitmix32 counter stream of cvsim_tpu/ops/noise.py:
// word idx of stream `key` is mix32(key + idx * 0x9E3779B9) in uint32
// arithmetic, the same bits as the TPU kernels' _walk_rows_kernel /
// _mix32_k (cvsim_tpu/models/fused_yiq.py).
//
// Every function here is entered and left by all 128 threads of the CTA
// and ends synchronised (see pole.cuh).

#pragma once

#include <cstdint>

#include "pole.cuh"

namespace cvsim {

constexpr uint32_t GOLD = 0x9E3779B9u;

__device__ inline uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// clampu8 of a float stage output: truncate toward zero, clamp to [0, 255].
__device__ inline float u8f(float v) {
  return fminf(fmaxf(truncf(v), 0.f), 255.f);
}

// Per-row smoothed noise walk added to plane p (w active samples of wp):
// increments from stream index plane_off + row*w + x, an alpha-0.5 pole,
// the pre-update value (shifted right by one, column 0 zero), truncated.
// tmp: wp floats of scratch; red: the pole's RED_FLOATS (pole.cuh). With
// u8_masked (gen-1) the sum is clamped to u8 and the samples past w are
// zeroed; without it (gen-2) every sample of wp takes the sum.
// The walk's increment at sample x of a row: word plane_off + row*w + x of
// stream key, uniform on -mag..mag; 0 past w.
__device__ inline float walk_step(uint32_t key, int row, int x, int mag,
                                  uint32_t plane_off, int w) {
  if (x >= w) return 0.f;
  const uint32_t span = 2u * (uint32_t)mag + 1u;
  const uint32_t idx = plane_off + (uint32_t)row * (uint32_t)w + (uint32_t)x;
  const uint32_t bits = mix32(key + idx * GOLD);
  return (float)((int)(bits % span) - mag);
}

__device__ inline void add_walk(float* p, float* tmp, float* red,
                                const PoleTables& tab, uint32_t key, int row,
                                int mag, uint32_t plane_off, int w, int wp,
                                bool u8_masked) {
  for (int x = threadIdx.x; x < wp; x += BLOCK)
    tmp[x] = walk_step(key, row, x, mag, plane_off, w);
  __syncthreads();
  pole(tmp, tmp, tab, 0.f, wp / BLOCK, red);
  for (int x = threadIdx.x; x < wp; x += BLOCK) {
    const float v = p[x] + (x == 0 ? 0.f : truncf(tmp[x - 1]));
    p[x] = !u8_masked ? v : (x < w ? u8f(v) : 0.f);
  }
  __syncthreads();
}

// The stream and row index of one row of a multi-row walk.
struct WalkRow {
  uint32_t key;
  int row;
};

// add_walk over nrows rows held one after another (row k at p + k*wp and
// tmp + k*wp), row k drawing the stream and row index stream_of(k) returns
// (a WalkRow), with one pole_rows call for all of them; u8_masked as in
// add_walk (gen-1 yuv_b1: true; gen-2 yiq_b1: false). Each row's sums
// equal add_walk's on that row alone.
template <class StreamOf>
__device__ inline void add_walk_rows(float* p, float* tmp, float* red,
                                     const PoleTables& tab, StreamOf stream_of,
                                     int nrows, int mag, uint32_t plane_off,
                                     int w, int wp, bool u8_masked = false) {
  for (int k = 0; k < nrows; ++k) {
    const WalkRow s = stream_of(k);
    for (int x = threadIdx.x; x < wp; x += BLOCK)
      tmp[k * wp + x] = walk_step(s.key, s.row, x, mag, plane_off, w);
  }
  __syncthreads();
  pole_rows(tmp, tmp, tab, 0.f, nrows, wp / BLOCK, red);
  for (int k = 0; k < nrows; ++k) {
    float* pk = p + k * wp;
    const float* tk = tmp + k * wp;
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const float v = pk[x] + (x == 0 ? 0.f : truncf(tk[x - 1]));
      pk[x] = !u8_masked ? v : (x < w ? u8f(v) : 0.f);
    }
  }
  __syncthreads();
}

}  // namespace cvsim
