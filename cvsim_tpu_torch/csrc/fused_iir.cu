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
// so one CTA of 128 threads takes R rows (chosen per width by pole.cuh's
// rows_per_cta: the count that fits four CTAs an SM with the fewest pole
// rounds a row, 5 at 360 and 720 samples, 1 at 1888), held in shared
// memory one after another in each of three buffers (the input, the
// cascade and the emphasis pole's output: 3 * R * Wp floats, Wp = W padded
// to whole blocks, 23 KB at W = 1888 or at W = 360, and the poles' carry
// scratch). Each pole is one pole_rows call over the R rows, so a table
// entry a thread loads serves the blocks of all of them and the barriers
// are paid once; the last CTA may hold fewer rows. The TPU's 256-row tiles
// exist to fill its VMEM and have no counterpart. Where one row fills a
// round (R = 1), a kernel of its own runs the one-row primitive. The tables (T^T and d,
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
// the barriers of a 128-thread CTA set the pace (PERF.md). A scan over the
// row would need only the recurrence's own work, but would round
// otherwise.

#include <cuda_runtime.h>

#include "pole.cuh"

namespace cvsim {
namespace iir {

constexpr int MAX_POLES = 8;
constexpr int PLANES = 3;  // row planes in shared memory: xs, s, lp
enum { MODE_NONE = 0, MODE_EMPH = 1, MODE_UNSHARP = 2 };

// Launch arguments; mirrored by ops/fused_iir._IirParams.
struct Params {
  int rows, w, wp, k, mode;
  float gain;
  float y0[MAX_POLES];
};

}  // namespace iir

// ROWS false: one row a CTA (rows_per_cta == 1), through the one-row
// primitive; true: rows_per_cta rows, through pole_rows.
template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
fused_iir_rows(const float* __restrict__ x, const float* __restrict__ tt,
               const float* __restrict__ d, iir::Params P, int rows_per_cta,
               float* __restrict__ out) {
  extern __shared__ float sm[];
  const int R = ROWS ? rows_per_cta : 1, w = P.w, wp = P.wp;
  const int nb = wp / BLOCK, row0 = blockIdx.x * R;
  const int n = ROWS ? min(R, P.rows - row0) : 1;   // rows of this CTA
  float* xs = sm;
  float* s = sm + R * wp;
  float* lp = sm + 2 * R * wp;
  float* red = sm + 3 * R * wp;
  const float* xr = x + (size_t)row0 * w;
  for (int k = 0; k < n; ++k)
    for (int i = threadIdx.x; i < wp; i += BLOCK)
      xs[k * wp + i] = i < w ? xr[k * w + i] : 0.f;
  __syncthreads();

  // the cascade into s, pole by pole; emph's last pole runs on the
  // cascade of the others (xs when there are none) into lp
  const bool emph = P.mode == iir::MODE_EMPH;
  for (int i = 0; i < P.k; ++i) {
    const PoleTables t{tt + i * BLOCK * BLOCK, d + i * BLOCK, nullptr,
                       nullptr, nullptr};
    const float* in = i == 0 ? xs : s;
    float* o = emph && i == P.k - 1 ? lp : s;
    if constexpr (ROWS)
      pole_rows(in, o, t, P.y0[i], n, nb, red);
    else
      pole(in, o, t, P.y0[i], nb, red);
  }
  const float* c = emph && P.k == 1 ? xs : s;  // the cascade
  for (int k = 0; k < n; ++k) {
    float* o = out + (size_t)(row0 + k) * w;
    const float* ck = c + k * wp;
    const float* xk = xs + k * wp;
    const float* lk = lp + k * wp;
    for (int j = threadIdx.x; j < w; j += BLOCK) {
      if (P.mode == iir::MODE_EMPH)
        o[j] = ck[j] + (ck[j] - lk[j]) * P.gain;
      else if (P.mode == iir::MODE_UNSHARP)
        o[j] = xk[j] + (xk[j] - ck[j]) * P.gain;
      else
        o[j] = ck[j];
    }
  }
}

}  // namespace cvsim

int cvsim_rows_per_cta_override = 0;

// C entry points (bound with ctypes by cvsim_tpu_torch/kernels.py).

// The rows a CTA of cvsim_fused_iir at padded width wp on the current
// device.
extern "C" int cvsim_fused_iir_rows_per_cta(int wp) {
  return cvsim::rows_per_cta(wp, cvsim::iir::PLANES);
}

// x and out: float32 [rows, w], contiguous; tt: [k, 128, 128] T^T per pole;
// d: [k, 128]; ceil(rows / R) CTAs of R = cvsim_fused_iir_rows_per_cta(wp)
// rows. Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int cvsim_fused_iir(const void* x, const void* tt, const void* d,
                               void* out, const void* params, void* stream) {
  using namespace cvsim;
  const iir::Params P = *static_cast<const iir::Params*>(params);
  if (P.k < 1 || P.k > iir::MAX_POLES || P.w < 1 || P.wp % BLOCK != 0 ||
      P.w > P.wp || P.rows < 0 || P.mode < iir::MODE_NONE ||
      P.mode > iir::MODE_UNSHARP)
    return (int)cudaErrorInvalidValue;
  const int R = rows_per_cta(P.wp, iir::PLANES);
  if (R < 1 || R > ROUND) return (int)cudaErrorInvalidValue;
  if (P.rows == 0) return 0;
  const size_t smem = (size_t)(iir::PLANES * R * P.wp + RED_FLOATS) *
                      sizeof(float);
  const auto kernel = R == 1 ? fused_iir_rows<false> : fused_iir_rows<true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ctas = (P.rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(tt),
      static_cast<const float*>(d), P, R, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
