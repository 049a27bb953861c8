// BT.601 studio-range RGB -> YUV of one pixel, bit for bit as
// host/colorconv.rgb_to_yuv601_np computes it: its float32 operations in
// its order, each rounded once, then round half to even and a clip to
// 0..255.
//   yl = (0.299 r + 0.587 g) + 0.114 b
//   y  = yl * (219/255) + 16
//   u  = (b - yl) / 1.772 * (224/255) + 128
//   v  = (r - yl) / 1.402 * (224/255) + 128
// The constants are numpy's np.float32 of the double values. On the card
// each operation is an explicit round-to-nearest intrinsic, so nothing is
// contracted into an FMA or approximated (the library is built with
// -fmad=false besides); on the host (g++ with -ffp-contract=off in the
// tests) the plain operators round the same way.
// csrc/y4m_payload.cu runs it on the card, native/hostpix.cpp on the host
// (rgb_to_yuv_impl, rgb_to_yuv_sub_impl); tests/pole_model.cpp builds it
// with g++ and holds it to rgb_to_yuv601_np on all 2^24 RGB triples.

#pragma once

#include <cmath>
#include <cstdint>

#if !defined(__CUDACC__)
#ifndef __host__
#define __host__
#endif
#ifndef __device__
#define __device__
#endif
#endif

namespace cvsim {
namespace yuv601 {

struct Yuv {
  uint8_t y, u, v;
};

__host__ __device__ inline float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__host__ __device__ inline float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__host__ __device__ inline float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

__host__ __device__ inline float div_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// np.clip(np.round(x), 0, 255): round half to even, then clip
__host__ __device__ inline uint8_t round_clip(float x) {
  return (uint8_t)fminf(fmaxf(rintf(x), 0.f), 255.f);
}

constexpr float K_Y = (float)(219.0 / 255.0);
constexpr float K_C = (float)(224.0 / 255.0);

__host__ __device__ inline float luma(float r, float g, float b) {
  return add_rn(add_rn(mul_rn((float)0.299, r), mul_rn((float)0.587, g)),
                mul_rn((float)0.114, b));
}

__host__ __device__ inline Yuv yuv_of(float r, float g, float b) {
  const float yl = luma(r, g, b);
  Yuv out;
  out.y = round_clip(add_rn(mul_rn(yl, K_Y), 16.f));
  out.u = round_clip(
      add_rn(mul_rn(div_rn(sub_rn(b, yl), (float)1.772), K_C), 128.f));
  out.v = round_clip(
      add_rn(mul_rn(div_rn(sub_rn(r, yl), (float)1.402), K_C), 128.f));
  return out;
}

}  // namespace yuv601
}  // namespace cvsim
