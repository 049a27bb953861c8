// Blocked one-pole IIR for one scanline held in shared memory.
//
// y[t] = a*x[t] + (1-a)*y[t-1] over 128-sample blocks: within a block the
// response is a product with the lower-triangular T[i][j] = a*(1-a)^(i-j),
// and the carry-in adds d[i] = (1-a)^(i+1) times the previous block's last
// value (cvsim_tpu/ops/blocked_iir.py). Three identical poles compose into
// one product with T^3 plus three carries. Thread t of a 128-thread CTA
// computes output t of each block; the carry chains over the blocks.
//
// The tables are the stacks built by models/fused_yiq._stack_alpha_consts
// (float64 math, one cast), stored transposed so that thread t reads
// column t of row j at [j*128 + t]: consecutive threads, consecutive
// addresses. They stay in global memory, shared by every CTA and resident
// in L2.
//
// Op order follows the TPU kernel's _pole/_pole3
// (cvsim_tpu/models/fused_yiq.py:92-132): the products accumulate with
// fused multiply-adds, and the carry terms are added left to right. Build
// with -fmad=false so that the compiler contracts nothing else.
//
// Every function here is entered and left by all 128 threads of the CTA
// (each contains __syncthreads) and ends synchronised, so that the caller
// may read any sample and overwrite any buffer right after it returns.

#pragma once

#include <cstdint>

namespace cvsim {

constexpr int BLOCK = 128;

struct PoleTables {
  const float* tt;   // [128][128] T^T
  const float* d;    // [128] carry vector
  const float* tt3;  // [128][128] (T^3)^T
  const float* d3;   // [8][128]: row 0 = T^2 d, row 1 = T d
  const float* vt;   // [128][8]: column 0 = T[127][:], column 1 = T^2[127][:]
};

// Row k of the stacked tables.
__device__ inline PoleTables pole_tables(const float* tt, const float* d,
                                         const float* tt3, const float* d3,
                                         const float* vt, int k) {
  return {tt + k * BLOCK * BLOCK, d + k * BLOCK, tt3 + k * BLOCK * BLOCK,
          d3 + k * 8 * BLOCK, vt + k * BLOCK * 8};
}

// The stacked tables of one chain; tab[k] is row k.
struct Tables {
  const float *tt, *d, *tt3, *d3, *vt;
  __device__ PoleTables operator[](int k) const {
    return pole_tables(tt, d, tt3, d3, vt, k);
  }
};

// Output t of a lower-triangular block product: sum_{j<=t} xb[j]*m[j][t]
// (the entries above the diagonal are exact zeros and add nothing).
__device__ inline float tri_dot(const float* xb, const float* m, int t) {
  float acc = 0.f;
  for (int j = 0; j <= t; ++j) acc = fmaf(xb[j], __ldg(m + j * BLOCK + t), acc);
  return acc;
}

// One pole over nb blocks, register reset to y0. in may equal out.
__device__ inline void pole(const float* in, float* out, const PoleTables& p,
                            float y0, int nb) {
  const int t = threadIdx.x;
  const float dt = __ldg(p.d + t);
  float carry = y0;
  for (int b = 0; b < nb; ++b) {
    const float yb = tri_dot(in + b * BLOCK, p.tt, t) + dt * carry;
    __syncthreads();
    out[b * BLOCK + t] = yb;
    __syncthreads();
    carry = out[b * BLOCK + BLOCK - 1];
  }
  __syncthreads();
}

// Three identical poles in series (all registers reset to y0) as one T^3
// product per block. red: 4 floats of shared memory for the two
// block-end responses, double-buffered over blocks. in may equal out.
__device__ inline void pole3(const float* in, float* out, const PoleTables& p,
                             float y0, int nb, float* red) {
  const int t = threadIdx.x;
  const float dc1 = __ldg(p.d3 + t);
  const float dc2 = __ldg(p.d3 + BLOCK + t);
  const float dt = __ldg(p.d + t);
  const float dl = __ldg(p.d + BLOCK - 1);
  const float s2 = __ldg(p.d3 + BLOCK + BLOCK - 1);
  float c1 = y0, c2 = y0, c3 = y0;
  for (int b = 0; b < nb; ++b) {
    const float* xb = in + b * BLOCK;
    float* slot = red + 2 * (b & 1);
    const float yb = tri_dot(xb, p.tt3, t) + dc1 * c1 + dc2 * c2 + dt * c3;
    if (t == 0 || t == 32) {
      // block-end responses of the first two poles with zero carry-in,
      // on two warps so that neither delays the other
      const int col = t ? 1 : 0;
      float u = 0.f;
      for (int j = 0; j < BLOCK; ++j) u = fmaf(xb[j], __ldg(p.vt + j * 8 + col), u);
      slot[col] = u;
    }
    __syncthreads();
    out[b * BLOCK + t] = yb;
    __syncthreads();
    const float nc1 = slot[0] + dl * c1;
    const float nc2 = slot[1] + s2 * c1 + dl * c2;
    c3 = out[b * BLOCK + BLOCK - 1];
    c1 = nc1;
    c2 = nc2;
  }
  __syncthreads();
}

}  // namespace cvsim
