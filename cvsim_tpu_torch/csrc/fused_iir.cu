// A cascade of one-pole IIR lowpasses over each row of a float32 [rows, W]
// tensor, with an optional combine: the standalone pole-cascade kernel.
//
// Replaces the TPU kernel cvsim_tpu/ops/pallas/fused_iir.py _make_kernel
// (launched by fused_iir): k poles, each with its own alpha and reset
// value, in series; then
//   none:    the cascade output,
//   emph:    s + (s - pole_k(s)) * gain, s the cascade of the first k-1
//            poles (the VHS luma and preemphasis shape),
//   unsharp: x + (x - cascade(x)) * gain (the sharpen shape).
// Each pole is one blocked pass (pole.cuh's `pole`: x @ T^T + d * carry
// per 128-sample block), as in the TPU kernel, not the T^3 grouping of the
// stage path's three-pole cascades; the plain version it is held against
// is ops/fused_iir.fused_iir_reference.
//
// Design. Rows are independent and each row is a serial chain of blocks,
// so one CTA of 128 threads takes one row, held in shared memory (the
// input, the cascade and the emphasis pole's output: 3 * Wp floats, Wp =
// W padded to whole blocks, 23 KB at W = 1888, and the poles' carry
// scratch). The TPU's 256-row tiles
// exist to fill its VMEM and have no counterpart. The tables (T^T and d,
// one per pole) stay in global memory, shared by every CTA and resident
// in L2.
//
// What bounds it. The function needs 3 flops per sample per pole (the
// recurrence's subtract and multiply-add) against 8 bytes of device
// memory per sample (one read, one write), so it is bound by bytes. This
// blocked form costs far more: a 128 x 128 lower-triangular product per
// block and pole (8,256 multiply-adds, 129 flops per sample). pole.cuh
// runs every block's product before the carries, and a thread reuses
// each table entry it loads for all of its blocks, so the load units and
// the barriers of a 128-thread row set the pace (PERF.md). A scan over the
// row would need only the recurrence's own work, but would round
// otherwise.

#include <cuda_runtime.h>

#include "pole.cuh"

namespace cvsim {
namespace iir {

constexpr int MAX_POLES = 8;
enum { MODE_NONE = 0, MODE_EMPH = 1, MODE_UNSHARP = 2 };

// Launch arguments; mirrored by ops/fused_iir._IirParams.
struct Params {
  int rows, w, wp, k, mode;
  float gain;
  float y0[MAX_POLES];
};

}  // namespace iir

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
fused_iir_rows(const float* __restrict__ x, const float* __restrict__ tt,
               const float* __restrict__ d, iir::Params P,
               float* __restrict__ out) {
  extern __shared__ float sm[];
  float* xs = sm;
  float* s = sm + P.wp;
  float* lp = sm + 2 * P.wp;
  float* red = sm + 3 * P.wp;
  const int nb = P.wp / BLOCK;
  const size_t off = (size_t)blockIdx.x * P.w;
  for (int i = threadIdx.x; i < P.wp; i += BLOCK) xs[i] = i < P.w ? x[off + i] : 0.f;
  __syncthreads();

  const int n_lp = P.k - (P.mode == iir::MODE_EMPH ? 1 : 0);
  const float* c = xs;  // the cascade so far
  for (int i = 0; i < n_lp; ++i) {
    const PoleTables t{tt + i * BLOCK * BLOCK, d + i * BLOCK, nullptr,
                       nullptr, nullptr};
    pole(c, s, t, P.y0[i], nb, red);
    c = s;
  }
  float* o = out + off;
  if (P.mode == iir::MODE_EMPH) {
    const int i = P.k - 1;
    const PoleTables t{tt + i * BLOCK * BLOCK, d + i * BLOCK, nullptr,
                       nullptr, nullptr};
    pole(c, lp, t, P.y0[i], nb, red);
    for (int j = threadIdx.x; j < P.w; j += BLOCK)
      o[j] = c[j] + (c[j] - lp[j]) * P.gain;
  } else if (P.mode == iir::MODE_UNSHARP) {
    for (int j = threadIdx.x; j < P.w; j += BLOCK)
      o[j] = xs[j] + (xs[j] - c[j]) * P.gain;
  } else {
    for (int j = threadIdx.x; j < P.w; j += BLOCK) o[j] = c[j];
  }
}

}  // namespace cvsim

// C entry point (bound with ctypes by cvsim_tpu_torch/kernels.py). x and
// out: float32 [rows, w], contiguous; tt: [k, 128, 128] T^T per pole; d:
// [k, 128]. Launches on `stream`, allocates nothing, does not synchronise,
// and returns cudaGetLastError() (0 on success).
extern "C" int cvsim_fused_iir(const void* x, const void* tt, const void* d,
                               void* out, const void* params, void* stream) {
  using namespace cvsim;
  const iir::Params P = *static_cast<const iir::Params*>(params);
  if (P.k < 1 || P.k > iir::MAX_POLES || P.w < 1 || P.wp % BLOCK != 0 ||
      P.w > P.wp || P.rows < 0 || P.mode < iir::MODE_NONE ||
      P.mode > iir::MODE_UNSHARP)
    return (int)cudaErrorInvalidValue;
  if (P.rows == 0) return 0;
  const size_t smem = (size_t)(3 * P.wp + RED_FLOATS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_iir_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_iir_rows<<<P.rows, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(tt),
      static_cast<const float*>(d), P, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
