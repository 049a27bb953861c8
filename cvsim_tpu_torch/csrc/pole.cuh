// Blocked one-pole IIR for one scanline held in shared memory.
//
// y[t] = a*x[t] + (1-a)*y[t-1] over 128-sample blocks: within a block the
// response is a product with the lower-triangular T[i][j] = a*(1-a)^(i-j),
// and the carry-in adds d[i] = (1-a)^(i+1) times the previous block's last
// value (cvsim_tpu/ops/blocked_iir.py). Three identical poles compose into
// one product with T^3 plus three carries.
//
// The tables are the stacks built by models/fused_yiq._stack_alpha_consts
// (float64 math, one cast), stored transposed so that column t of row j
// sits at [j*128 + t]: consecutive columns, consecutive addresses. They
// stay in global memory, shared by every CTA and resident in L2.
//
// Op order follows the TPU kernel's _pole/_pole3
// (cvsim_tpu/models/fused_yiq.py:92-132): output t of a block's product
// is acc = 0, then acc = fmaf(x[j], T[j][t], acc) for j = 0..t in
// ascending order, and the carry terms are added left to right. Build
// with -fmad=false so that the compiler contracts nothing else.
//
// Schedule. The products do not depend on the carries, so a call runs in
// three phases with one barrier after each:
//   1. products: every block's zero-carry product at once. Thread k owns
//      the column pair (k mod 64, 127 - k mod 64), 129 multiply-adds a
//      block, in half k / 64 of the blocks (every other block), and keeps
//      each block's two sums in registers. Each table entry it loads
//      serves all of its blocks, and the samples arrive as float4
//      broadcasts from shared memory. pole3's block-end responses of its
//      first two poles (dots with vt's columns 0 and 1) run meanwhile on
//      one warp, a lane for each block and column (block_end_dots);
//   2. carries: thread 0 runs the short scalar chain over the blocks with
//      the expressions of the TPU kernel, into `red`;
//   3. outputs: each thread adds its blocks' carry terms to the sums it
//      holds and writes them.
// A round holds up to 16 blocks (2048 samples, every raster of the repo);
// a longer row takes more rounds, the carries running on from one to the
// next.
//
// Several rows (pole_rows, pole3_rows). A row of 720 samples fills 6 of a
// round's 16 blocks, one of 360 samples 3, so a thread's table entries
// serve only 3 or 2 blocks and the barriers serve one short row. The
// multi-row forms take R rows held one after another as one list of
// blocks: phases 1 and 3 are unchanged, and phase 2 runs one thread per
// row, each chain starting from its row's reset value. Each output is the
// same operations on the same values as in the one-row form, so the bits
// are the same; only which thread computes it, and in which round, moves.
//
// Every function here is entered and left by all 128 threads of the CTA
// (each contains __syncthreads) and ends synchronised, so that the caller
// may read any sample and overwrite any buffer right after it returns.
// `in` may equal `out`.

#pragma once

#include <cstdint>

namespace cvsim {

constexpr int BLOCK = 128;
constexpr int HALF = BLOCK / 2;
constexpr int MAX_KB = 8;          // blocks a thread holds per round
constexpr int ROUND = 2 * MAX_KB;  // blocks per round
// shared scratch of a pole call: the block carries, then pole3's two vt
// columns
constexpr int RED_FLOATS = 3 * ROUND + 2 * BLOCK;
// CTAs per SM that every kernel on these primitives is built for
// (__launch_bounds__): four rows share an SM, and a thread may hold 128
// registers, under which nothing spills (ptxas -v). Five or six rows an SM
// ran 10-25% faster on an H100 but spill around the calls (PERF.md).
constexpr int MIN_CTAS = 4;

// Rows one CTA of a multi-row kernel takes, each row `row_floats` floats of
// shared memory whose pole calls run at nb blocks and, in a kernel with
// rows of two widths, at nb2 (0: one width), on an SM of sm_smem bytes that
// keeps cta_reserved bytes for each CTA: of the counts up to ROUND whose
// rows fit MIN_CTAS CTAs an SM beside the poles' scratch, the one with the
// fewest pole rounds a row (the rows' blocks taken ROUND at a time, a
// round of each width counted alike), the smallest on a tie.
inline int rows_per_cta_of(int row_floats, int nb, int nb2, int sm_smem,
                           int cta_reserved) {
  const int room = sm_smem / MIN_CTAS - cta_reserved -
                   RED_FLOATS * (int)sizeof(float);
  int fit = room / (row_floats * (int)sizeof(float));
  fit = fit < 1 ? 1 : fit > ROUND ? ROUND : fit;
  const auto rounds = [=](int r) {
    return (r * nb + ROUND - 1) / ROUND + (r * nb2 + ROUND - 1) / ROUND;
  };
  int best = 1, best_rounds = rounds(1);
  for (int r = 2; r <= fit; ++r) {
    if (rounds(r) * best < best_rounds * r) {   // rounds / r < best's
      best = r;
      best_rounds = rounds(r);
    }
  }
  return best;
}

#ifdef __CUDACC__
}  // namespace cvsim

// Rows a CTA that the multi-row kernels take in place of rows_per_cta_of's
// choice, when above 0 (tests set it to hold the kernels at other counts);
// defined in fused_iir.cu.
extern "C" int cvsim_rows_per_cta_override;

namespace cvsim {

// rows_per_cta_of on the current device, or the override.
inline int rows_per_cta_of(int row_floats, int nb, int nb2) {
  if (cvsim_rows_per_cta_override > 0) return cvsim_rows_per_cta_override;
  int dev = 0, sm_smem = 0, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sm_smem,
                         cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  return rows_per_cta_of(row_floats, nb, nb2, sm_smem, reserved);
}

// rows_per_cta_of on the current device for rows of `planes` planes of wp
// floats (#2 yiq_a, #3 yiq_b1, #9 fused_iir). On an H100 (228 KB an SM, 1
// KB a CTA): 3 planes (#9) 5 rows at 360 and 720 samples, 1 at 1888; 5
// planes (#2, #3) 2 at 704-720, 1 at 1888.
inline int rows_per_cta(int wp, int planes) {
  return rows_per_cta_of(planes * wp, wp / BLOCK, 0);
}
#endif

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

// The carries into a block: of the single pole (c1), or of the three
// poles of a cascade (c1, c2, c3).
struct Carries {
  float c1, c2, c3;
};

// Steps j..j+3 of the products of KB blocks (samples at xb + qs[i]).
// BOTH: j is below the end of the low columns of the warp's range, where
// every high column is still active; else only the high column is left.
template <int KB, bool BOTH>
__device__ __forceinline__ void product_steps(
    const float4* xb, const int (&qs)[KB], int j, int lo, int hi,
    const float* tab, float (&ahi)[KB], float (&alo)[KB]) {
  float th[4], tl[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    th[k] = __ldg(tab + (j + k) * BLOCK + hi);
    tl[k] = BOTH ? __ldg(tab + (j + k) * BLOCK + lo) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const float4 v = xb[qs[i] + j / 4];
    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (BOTH || j + k <= hi) ahi[i] = fmaf(xv[k], th[k], ahi[i]);
      if (BOTH && j + k <= lo) alo[i] = fmaf(xv[k], tl[k], alo[i]);
    }
  }
}

// pole3's block-end responses of its first two poles with zero carry-in,
// u1 = T[127][:] . x_q and u2 = T^2[127][:] . x_q, into red[3q] and
// red[3q+1], on one warp: lane L takes block q = L % 16 and vt column
// L / 16, each one sequential j = 0..127 chain, four samples a step. Lane
// q starts q steps late, so that the eight lanes of each quarter-warp read
// eight different bank groups of the samples and of vt's columns (staged
// in shared memory at vts).
__device__ inline void block_end_dots(const float* in, const float* vt,
                                      float* vts, float* red, int b0, int n) {
  const int lane = threadIdx.x % 32, q = lane % 16, col = lane / 16;
  for (int k = lane; k < 2 * BLOCK; k += 32)
    vts[k] = __ldg(vt + (k % BLOCK) * 8 + k / BLOCK);
  __syncwarp();
  if (q >= n) return;
  const float4* x4 = reinterpret_cast<const float4*>(in + (b0 + q) * BLOCK);
  const float4* v4 = reinterpret_cast<const float4*>(vts + col * BLOCK);
  float u = 0.f;
  for (int s = 0; s < BLOCK / 4 + n - 1; ++s) {
    const int jq = s - q;  // this lane's step
    if (jq >= 0 && jq < BLOCK / 4) {
      const float4 x = x4[jq], v = v4[jq];
      u = fmaf(x.x, v.x, u);
      u = fmaf(x.y, v.y, u);
      u = fmaf(x.z, v.z, u);
      u = fmaf(x.w, v.w, u);
    }
  }
  red[3 * q + col] = u;
}

// Phase 1 of a round over blocks b0 .. b0+n-1 (n <= 2*KB): every block's
// zero-carry product into the thread's sums (a thread of half 1 holds a
// copy of the last block when n is odd, and discards it), column 127's
// sums into red; pole3's block-end dots on the last warp.
template <bool THREE, int KB>
__device__ __forceinline__ void round_products(const float* in,
                                               const PoleTables& p,
                                               float* red, int b0, int n,
                                               float (&ahi)[KB],
                                               float (&alo)[KB]) {
  const int t = threadIdx.x;
  const int h = t / HALF, lo = t % HALF, hi = BLOCK - 1 - lo;
  // a warp holds 32 consecutive low columns: 32*m .. 32*m+31
  const int m = (t / 32) % 2;
  const int j_both = 32 * m + 32, j_end = BLOCK - 32 * m;
  const float* tab = THREE ? p.tt3 : p.tt;

  if (THREE && t / 32 == 3)
    block_end_dots(in, p.vt, red + 3 * ROUND, red, b0, n);
  const float4* xb = reinterpret_cast<const float4*>(in + b0 * BLOCK);
  int qs[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    qs[i] = min(2 * i + h, n - 1) * (BLOCK / 4);
    ahi[i] = alo[i] = 0.f;
  }
  for (int j = 0; j < j_both; j += 4)
    product_steps<KB, true>(xb, qs, j, lo, hi, tab, ahi, alo);
  for (int j = j_both; j < j_end; j += 4)
    product_steps<KB, false>(xb, qs, j, lo, hi, tab, ahi, alo);
  // column 127 (the high column of lo 0) ends every block
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const int q = 2 * i + h;
    if (lo == 0 && q < n) red[THREE ? 3 * q + 2 : q] = ahi[i];
  }
}

// Phase 2, on one thread: the carry chain over n consecutive blocks whose
// phase-1 values sit at red (red[q], or red[3q..3q+2]), entered with the
// carries into the first; red's entries become the carries into each
// block, and the carries out of the last are returned. Each step's inputs
// are read one step ahead, so that only the arithmetic is serial.
template <bool THREE>
__device__ __forceinline__ Carries carry_chain(float* red, int n,
                                               const PoleTables& p,
                                               Carries c) {
  const float dl = __ldg(p.d + BLOCK - 1);
  if (!THREE) {
    float e = red[0];
    for (int q = 0; q < n; ++q) {
      const float next = q + 1 < n ? red[q + 1] : 0.f;
      red[q] = c.c1;
      c.c1 = e + dl * c.c1;
      e = next;
    }
  } else {
    const float s1 = __ldg(p.d3 + BLOCK - 1);
    const float s2 = __ldg(p.d3 + 2 * BLOCK - 1);
    float u1 = red[0], u2 = red[1], e = red[2];
    for (int q = 0; q < n; ++q) {
      float* r = red + 3 * q;
      float n1 = 0.f, n2 = 0.f, ne = 0.f;
      if (q + 1 < n) {
        n1 = r[3];
        n2 = r[4];
        ne = r[5];
      }
      r[0] = c.c1;
      r[1] = c.c2;
      r[2] = c.c3;
      c = {u1 + dl * c.c1, u2 + s2 * c.c1 + dl * c.c2,
           e + s1 * c.c1 + s2 * c.c2 + dl * c.c3};
      u1 = n1;
      u2 = n2;
      e = ne;
    }
  }
  return c;
}

// Phase 3: each thread adds its blocks' carry terms (red, from phase 2) to
// the sums it holds and writes them.
template <bool THREE, int KB>
__device__ __forceinline__ void round_outputs(float* out, const PoleTables& p,
                                              const float* red, int b0, int n,
                                              const float (&ahi)[KB],
                                              const float (&alo)[KB]) {
  const int t = threadIdx.x;
  const int h = t / HALF, lo = t % HALF, hi = BLOCK - 1 - lo;
  const float dh = __ldg(p.d + hi), dlo = __ldg(p.d + lo);
  float e1h = 0.f, e1l = 0.f, e2h = 0.f, e2l = 0.f;
  if (THREE) {
    e1h = __ldg(p.d3 + hi);
    e1l = __ldg(p.d3 + lo);
    e2h = __ldg(p.d3 + BLOCK + hi);
    e2l = __ldg(p.d3 + BLOCK + lo);
  }
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const int q = 2 * i + h;
    if (q < n) {
      float* ob = out + (b0 + q) * BLOCK;
      if (!THREE) {
        const float cb = red[q];
        ob[hi] = ahi[i] + dh * cb;
        ob[lo] = alo[i] + dlo * cb;
      } else {
        const float c1 = red[3 * q], c2 = red[3 * q + 1];
        const float c3 = red[3 * q + 2];
        ob[hi] = ahi[i] + e1h * c1 + e2h * c2 + dh * c3;
        ob[lo] = alo[i] + e1l * c1 + e2l * c2 + dlo * c3;
      }
    }
  }
}

// One round of one row: blocks b0 .. b0+n-1 (n <= 2*KB) of a single pole
// (THREE false) or of a three-pole cascade, entered with the carries into
// block b0; returns the carries out of its last block (in thread 0).
template <bool THREE, int KB>
__device__ __noinline__ Carries pole_round(const float* in, float* out,
                                           PoleTables p, float* red, int b0,
                                           int n, Carries c) {
  float ahi[KB], alo[KB];
  round_products<THREE, KB>(in, p, red, b0, n, ahi, alo);
  __syncthreads();
  if (threadIdx.x == 0) c = carry_chain<THREE>(red, n, p, c);
  __syncthreads();
  round_outputs<THREE, KB>(out, p, red, b0, n, ahi, alo);
  __syncthreads();
  return c;
}

// The rows of a multi-row call: nb blocks each, reset to y0_rows[row] when
// given, else to y0.
struct RowSet {
  int nb;
  float y0;
  const float* y0_rows;
};

// One round of several rows of nb blocks each, held one after another
// (block q belongs to row q / nb): blocks b0 .. b0+n-1 (n <= 2*KB) of the
// rows together. Phases 1 and 3 are pole_round's, so each table entry a
// thread loads serves blocks of every row in the round; phase 2 runs one
// thread per row in the round, each chain restarting at its row's first
// block with the row's reset value. A row that began in an earlier round
// goes on from c, the carries that round returned (in thread 0); the
// carries out of the round's last block are returned the same way, passed
// through red[3 * ROUND ..], free after phase 1.
template <bool THREE, int KB>
__device__ __noinline__ Carries pole_rows_round(const float* in, float* out,
                                                PoleTables p, float* red,
                                                int b0, int n, RowSet rs,
                                                Carries c) {
  float ahi[KB], alo[KB];
  round_products<THREE, KB>(in, p, red, b0, n, ahi, alo);
  __syncthreads();
  const int t = threadIdx.x;
  const int nb = rs.nb;
  const int r0 = b0 / nb, n_rows = (b0 + n - 1) / nb - r0 + 1;
  if (t < n_rows) {
    const int row = r0 + t;
    const int q0 = max(row * nb, b0), q1 = min(row * nb + nb, b0 + n);
    if (q0 == row * nb) {
      const float y = rs.y0_rows ? rs.y0_rows[row] : rs.y0;
      c = {y, y, y};
    }
    c = carry_chain<THREE>(red + (THREE ? 3 : 1) * (q0 - b0), q1 - q0, p, c);
    if (t == n_rows - 1) {
      red[3 * ROUND] = c.c1;
      red[3 * ROUND + 1] = c.c2;
      red[3 * ROUND + 2] = c.c3;
    }
  }
  __syncthreads();
  if (t == 0)
    c = {red[3 * ROUND], red[3 * ROUND + 1], red[3 * ROUND + 2]};
  round_outputs<THREE, KB>(out, p, red, b0, n, ahi, alo);
  __syncthreads();
  return c;
}

template <bool THREE>
__device__ inline void pole_rounds(const float* in, float* out,
                                   const PoleTables& p, float y0, int nb,
                                   float* red) {
  Carries c{y0, y0, y0};
  for (int b0 = 0; b0 < nb; b0 += ROUND) {
    const int n = min(nb - b0, ROUND);
    switch ((n + 1) / 2) {
      case 1: c = pole_round<THREE, 1>(in, out, p, red, b0, n, c); break;
      case 2: c = pole_round<THREE, 2>(in, out, p, red, b0, n, c); break;
      case 3: c = pole_round<THREE, 3>(in, out, p, red, b0, n, c); break;
      case 4: c = pole_round<THREE, 4>(in, out, p, red, b0, n, c); break;
      case 5: c = pole_round<THREE, 5>(in, out, p, red, b0, n, c); break;
      case 6: c = pole_round<THREE, 6>(in, out, p, red, b0, n, c); break;
      case 7: c = pole_round<THREE, 7>(in, out, p, red, b0, n, c); break;
      default: c = pole_round<THREE, MAX_KB>(in, out, p, red, b0, n, c);
    }
  }
}

// One pole over nb blocks, register reset to y0. red: RED_FLOATS floats of
// shared memory.
__device__ inline void pole(const float* in, float* out, const PoleTables& p,
                            float y0, int nb, float* red) {
  pole_rounds<false>(in, out, p, y0, nb, red);
}

// Three identical poles in series (all registers reset to y0) as one T^3
// product per block. red: RED_FLOATS floats of shared memory.
__device__ inline void pole3(const float* in, float* out, const PoleTables& p,
                             float y0, int nb, float* red) {
  pole_rounds<true>(in, out, p, y0, nb, red);
}

// The multi-row forms: nrows rows of nb blocks each, held one after
// another in shared memory (row r at in + r * nb * BLOCK), taken in rounds
// of ROUND blocks of the rows together, so that the barriers of a round
// and each table entry a thread loads serve every row in it. Row r resets
// to y0_rows[r] when given, else to y0.
// Every output equals that of `pole` or `pole3` on the row alone, bit for
// bit.
template <bool THREE>
__device__ inline void pole_rows_rounds(const float* in, float* out,
                                        const PoleTables& p, float y0,
                                        int nrows, int nb, float* red,
                                        const float* y0_rows) {
  const RowSet rs{nb, y0, y0_rows};
  Carries c{y0, y0, y0};
  const int total = nrows * nb;
  for (int b0 = 0; b0 < total; b0 += ROUND) {
    const int n = min(total - b0, ROUND);
    switch ((n + 1) / 2) {
      case 1: c = pole_rows_round<THREE, 1>(in, out, p, red, b0, n, rs, c); break;
      case 2: c = pole_rows_round<THREE, 2>(in, out, p, red, b0, n, rs, c); break;
      case 3: c = pole_rows_round<THREE, 3>(in, out, p, red, b0, n, rs, c); break;
      case 4: c = pole_rows_round<THREE, 4>(in, out, p, red, b0, n, rs, c); break;
      case 5: c = pole_rows_round<THREE, 5>(in, out, p, red, b0, n, rs, c); break;
      case 6: c = pole_rows_round<THREE, 6>(in, out, p, red, b0, n, rs, c); break;
      case 7: c = pole_rows_round<THREE, 7>(in, out, p, red, b0, n, rs, c); break;
      default: c = pole_rows_round<THREE, MAX_KB>(in, out, p, red, b0, n, rs, c);
    }
  }
}

// `pole` over nrows rows (see pole_rows_rounds).
__device__ inline void pole_rows(const float* in, float* out,
                                 const PoleTables& p, float y0, int nrows,
                                 int nb, float* red,
                                 const float* y0_rows = nullptr) {
  pole_rows_rounds<false>(in, out, p, y0, nrows, nb, red, y0_rows);
}

// `pole3` over nrows rows (see pole_rows_rounds).
__device__ inline void pole3_rows(const float* in, float* out,
                                  const PoleTables& p, float y0, int nrows,
                                  int nb, float* red,
                                  const float* y0_rows = nullptr) {
  pole_rows_rounds<true>(in, out, p, y0, nrows, nb, red, y0_rows);
}

}  // namespace cvsim
