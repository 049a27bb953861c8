// The carried line tails of the raw composite decoder's Y/C separation:
// raw28_tails, one launch for a field's N lines.
//
// Replaces the serial part of cvsim_tpu/models/raw28.py decode_lines: its
// `one_line` body inside `jax.lax.scan` over the lines (:260-283). That is
// not a Pallas kernel; XLA runs it as a loop of one line a step. The
// reference keeps int_chroma[] as a C static, so the chroma stages that
// read past the line end (the burst enhancement at x+8 and x+12, each of
// the 4 denoise passes at x+4) read the previous line's shifted tail: the
// last 28 columns of each line's denoised chroma depend on the line before
// it, and so do chroma and luma at columns L-12..L-1 and the 16-sample
// tail the line hands on. Every other column is computed for all lines at
// once outside this kernel (models/raw28.py decode_lines); this kernel
// chains the 28 columns line by line. Its plain version is
// models/raw28.py tail_chain_reference, which runs on the CPU and in the
// tests.
//
// Per line, from c3 (the sample minus its 4-apart luma average) at
// columns L-28..L-1 and the carried tail t[16] (columns L..L+15):
//   c[x]  = ce[x] + ce[x+8] - ce[x+4] - ce[x+12], ce = c3 then t;
//   4 times: c[x] -= (c[x] + cd[x+4]) / 2, cd = c then t[0..3];
//   chroma[L-12+m] = c[m] / 4, luma = sample - chroma (m < 12);
//   next t[j] = c[12+j] / 4 (j < 16).
// All int32, with C's truncating division, so the kernel is exact.
//
// Design. The chain is serial in the lines and the division truncates,
// so it does not associate and no scan over the lines applies. One warp,
// the whole launch, walks the lines in order, one column a lane (28
// lanes; lanes 28..31 hold t[0..3], the denoise passes' reads past the
// line end), with the tail in the registers of lanes 0..15; every shifted
// read is a warp shuffle, so a line costs a few dozen instructions and no
// barrier. Each lane loads its inputs two lines ahead of the walk into
// registers, so a load's latency overlaps two lines of the chain, and
// stores its outputs straight to global memory. What bounds it is
// latency, not bytes or operations: about 260 bytes and 460 integer
// operations a line against a chain of dependent shuffles.

#include <cuda_runtime.h>

namespace cvsim {
namespace raw28 {

constexpr int TAIL = 28;    // carried columns of c: L-28..L-1
constexpr int OUT = 12;     // chroma and luma columns written: L-12..L-1
constexpr int CARRY = 16;   // the tail handed from line to line
constexpr unsigned FULL = 0xffffffffu;

// line r's inputs in this lane's registers (0 past the last line)
__device__ __forceinline__ void load_line(const int* __restrict__ c3t,
                                          const int* __restrict__ scant,
                                          int r, int n, int lane, int& c3,
                                          int& scan) {
  c3 = r < n && lane < TAIL ? c3t[(size_t)r * TAIL + lane] : 0;
  scan = r < n && lane < OUT ? scant[(size_t)r * OUT + lane] : 0;
}

__global__ void __launch_bounds__(32)
raw28_tails(const int* __restrict__ c3t, const int* __restrict__ scant,
            const int* __restrict__ carry_in, int* __restrict__ chroma_t,
            int* __restrict__ luma_t, int* __restrict__ carry_out, int n) {
  const int lane = threadIdx.x;
  // lane j < 16 holds t[j]
  int tail = lane < CARRY ? carry_in[lane] : 0;
  int c3_0, scan_0, c3_1, scan_1;
  load_line(c3t, scant, 0, n, lane, c3_0, scan_0);
  load_line(c3t, scant, 1, n, lane, c3_1, scan_1);
  for (int r = 0; r < n; ++r) {
    int c3_2, scan_2;
    load_line(c3t, scant, r + 2, n, lane, c3_2, scan_2);
    // a: ce at column L-28+lane (c3, then t[0..3] in lanes 28..31);
    // b: ce at column L+4+lane (t[4..15] in lanes 0..11)
    const int ta = __shfl_sync(FULL, tail, (lane - TAIL) & 31);
    const int b = __shfl_sync(FULL, tail, (lane + 4) & 31);
    const int a = lane < TAIL ? c3_0 : ta;
    int e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {   // ce at column L-28+lane+4(k+1)
      const int off = 4 * (k + 1);
      const int va = __shfl_sync(FULL, a, (lane + off) & 31);
      const int vb = __shfl_sync(FULL, b, (lane + off - 32) & 31);
      e[k] = lane + off < 32 ? va : vb;
    }
    // burst enhancement; lanes 28..31 keep t[0..3] for the denoise
    int d = lane < TAIL ? a + e[1] - e[0] - e[2] : a;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int nb = __shfl_sync(FULL, d, (lane + 4) & 31);
      if (lane < TAIL) d -= (d + nb) / 2;
    }
    if (lane < OUT) {
      const int ch = d / 4;
      chroma_t[(size_t)r * OUT + lane] = ch;
      luma_t[(size_t)r * OUT + lane] = scan_0 - ch;
    }
    const int nt = __shfl_sync(FULL, d, (lane + OUT) & 31) / 4;
    tail = lane < CARRY ? nt : 0;
    c3_0 = c3_1;
    scan_0 = scan_1;
    c3_1 = c3_2;
    scan_1 = scan_2;
  }
  if (lane < CARRY) carry_out[lane] = tail;
}

}  // namespace raw28
}  // namespace cvsim

// C entry point (bound with ctypes by cvsim_tpu_torch/kernels.py).
// c3t: int32 [n, 28]; scant: int32 [n, 12]; carry_in, carry_out: int32
// [16]; chroma_t, luma_t: int32 [n, 12]; all contiguous. One warp. Launches
// on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int cvsim_raw28_tails(const void* c3t, const void* scant,
                                 const void* carry_in, void* chroma_t,
                                 void* luma_t, void* carry_out, int n,
                                 void* stream) {
  using namespace cvsim::raw28;
  if (n < 0) return (int)cudaErrorInvalidValue;
  raw28_tails<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(c3t), static_cast<const int*>(scant),
      static_cast<const int*>(carry_in), static_cast<int*>(chroma_t),
      static_cast<int*>(luma_t), static_cast<int*>(carry_out), n);
  return (int)cudaGetLastError();
}
