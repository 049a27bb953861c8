// The gen-2 composite chain (ffmpeg_ntsc) for a batch of fields: kernel #1,
// the whole chain, and kernels #2-#4, its three row-local stage groups for
// row shards of a field.
//
// Kernel #1 replaces the TPU kernel cvsim_tpu/models/fused_yiq.py
// _make_kernel_ab (launched by _fused_stage_ab): RGB->YIQ, input chroma
// lowpass, QAM encode, preemphasis, luma noise, VHS head switch, Y/C
// separation + QAM decode, chroma AM and phase noise, VHS bandlimit,
// 2-line chroma blend, sharpen, re-encode/decode, dropout, Y/C recombine,
// output lowpass, YIQ->RGB. Its plain version is
// models/fused_yiq.chain_reference.
//
// Kernels #2-#4 replace the TPU kernels of the split program that the
// line-sharded mesh path runs (cvsim_tpu/parallel/mesh.py
// _fused_lines_bodies): yiq_a for _make_kernel_a (RGB->YIQ through the
// luma noise), yiq_b1 for _make_kernel_b1 (decode through the VHS
// bandlimit), yiq_b2 for _make_kernel_b2 (sharpen through YIQ->RGB, with
// the crop-and-cast to uint8). The head switch and the vertical blend run
// between them. Their plain versions are models/fused_yiq.stage_*_reference.
// A shard holds rows row0 .. row0+l-1 of fields l_glob rows high: the noise
// words are addressed by global row, and the Q walk sits at plane offset
// l_glob*w, so every shard draws its rows of the whole field's streams.
//
// All kernels compute what the TPU kernels compute, sample for sample, from
// the same row functions (stage_a_row, stage_b1_row, stage_b2_row).
//
// Design. Every stage is local to one scanline except the chroma vertical
// blend, which reads the line above, and the head switch is a per-row
// rotation by a precomputed shift. So kernel #1's launches run one CTA of
// 128 threads per (field, row), and yiq_a, yiq_b1 and yiq_b2 one per R
// rows:
//   yiq_front: uint8 RGB in -> group A, head switch, group B1 -> y, i, q
//              float planes in scratch;
//   yiq_back:  the blend against row l-1's front output, then group B2 and
//              YIQ->RGB -> uint8 out.
//   yiq_a, yiq_b1, yiq_b2: one group each; between launches the planes are
//              f32 [B, L, Wp] in device memory.
// The row's planes live in shared memory (5 x Wp floats: 38 KB at
// Wp = 1920; the R rows of yiq_a, yiq_b1 and yiq_b2 take R times that, R
// chosen per width by pole.cuh's rows_per_cta: 2 at 704-720, 1 at 1888;
// one row runs a one-row instance of each), so only the RGB bytes, the
// float planes and the output bytes touch device memory. The noise walks
// are generated in-kernel from the same splitmix32 words as the TPU
// kernel (_walk_rows_kernel).
//
// What bounds it. Each pole is a 128x128 lower-triangular product per
// 128-sample block (8,256 multiply-adds), and a row of the bench
// configuration runs twelve of them: at 480i B=64 some 9.1e9 multiply-adds,
// 0.27 ms at the float32 peak, against about 0.02 ms for the bytes #1 must
// move (about 30 bytes a sample; the split program adds an f32 plane out of
// #2 and into #3, 8 bytes a sample, plus what its seams move). The kernel
// takes about ten times that floor on an H100 (PERF.md): the load units,
// which bring each table entry from L1 and each sample from shared memory,
// the calls into the pole primitives, and the barriers of a 128-thread row
// set the pace, with four rows an SM to hide them.
// What the design does about it: pole.cuh computes every block's product
// before any carry (three barriers a pole, none waiting on a serial carry
// per block), a thread reuses each table entry it loads for all of its
// blocks and reads the samples as float4 broadcasts, the triangular loops
// skip the exact-zero upper half of every table, three-pole cascades run
// as one T^3 product, and all intermediates of a group stay on chip.
// yiq_a, yiq_b1 and yiq_b2 run their rows' poles through the multi-row
// primitives (pole_rows, pole3_rows, add_walk_rows), so that each table
// entry a thread loads and each barrier serve the blocks of all their
// rows, and each element-wise pass (QAM re-encode and decode, chroma
// dropout, Y/C recombine, the lowpass writebacks) covers all rows before
// its barrier. Group B1's row functions take ROWS = true for yiq_b1 and
// stay one-row code for the other kernels; the multi-row forms of groups
// A and B2 (stage_a_rows, stage_b2_rows) are written beside their one-row
// forms, which kernel #1 runs as it always compiled them. yiq_b2 stores
// each row's RGB bytes with kernel #1's store_rgb. Each output keeps the
// TPU kernel's operation sequence (the CRC32s of
// testing.PINNED_CHAIN_CRC32 and PINNED_CASE_CRC32 hold the bits). Fusing
// the launches with a recomputed halo row is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "noise.cuh"
#include "pole.cuh"

namespace cvsim {

// Launch arguments; mirrored by models/fused_yiq._ChainParams.
struct ChainParams {
  int b, l, w, wp;
  int amp, amp_back;
  int in_lowpass, preemph;
  float pre_gain;
  int video_noise, nocolor, chroma_noise, phase_noise, gen1_bug;
  int vhs, chroma_delay, vblend;
  float sharpen_gain;
  int svideo, chroma_loss, yc_recombine;
  int out_lowpass;  // 0 none, 1 'tv' 2.6MHz delay 1, 2 full (1.3/0.6MHz)
  int row0, l_glob;  // global index of row 0 of the launch; field height
};

// table rows (fused_yiq._alpha_consts)
enum { TAB_I = 0, TAB_Q = 1, TAB_PRE = 2, TAB_VLUMA = 3, TAB_VCHROMA = 4,
       TAB_SHARPEN = 5, TAB_TV = 6, TAB_WALK = 7 };

// Shared-memory working set of a CTA: ROW_PLANES planes, each of n rows of
// wp floats one after another (n = 1 in kernel #1 and in the one-row
// instances).
constexpr int ROW_PLANES = 5;
struct Row {
  float *y, *i, *q, *t1, *t2;
  float* red;  // RED_FLOATS floats: the poles' block carries
  int w, wp, nb;
  int n;       // rows held
};

// The row functions run on one row (ROWS false), or on the r.n rows of a
// multi-row CTA (ROWS true: yiq_a, yiq_b1, yiq_b2), each plane's row k at
// offset k * wp.
template <bool ROWS>
__device__ __forceinline__ int rows_of(const Row& r) {
  return ROWS ? r.n : 1;
}

// One pole (THREE false) or a three-pole cascade over the rows held: the
// one-row primitives, or their multi-row forms (pole.cuh).
template <bool ROWS, bool THREE>
__device__ __forceinline__ void poles(const float* in, float* out,
                                      const PoleTables& p, float y0,
                                      const Row& r) {
  if constexpr (ROWS && THREE)
    pole3_rows(in, out, p, y0, r.n, r.nb, r.red);
  else if constexpr (ROWS)
    pole_rows(in, out, p, y0, r.n, r.nb, r.red);
  else if constexpr (THREE)
    pole3(in, out, p, y0, r.nb, r.red);
  else
    pole(in, out, p, y0, r.nb, r.red);
}

// 3-pole cascade + the reference's delayed in-place writeback:
// p[x] = trunc(f[x+delay]) for x < w-delay, unchanged up to w, 0 beyond.
template <bool ROWS = false>
__device__ void lowpass_writeback(Row& r, float* p, const PoleTables& tab,
                                  int delay) {
  poles<ROWS, true>(p, r.t1, tab, 0.f, r);
  for (int k = 0; k < rows_of<ROWS>(r); ++k) {
    float* pk = p + k * r.wp;
    const float* fk = r.t1 + k * r.wp;
    for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
      const float v = (x < r.w - delay) ? truncf(fk[x + delay]) : pk[x];
      pk[x] = (x < r.w) ? v : 0.f;
    }
  }
  __syncthreads();
}

// y += trunc((i*amp*U + q*amp*V) / 50) with the subcarrier phase xi.
__device__ void qam_encode(Row& r, int xi, int amp) {
  const float a = (float)amp;
  for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
    const int s = (xi + x) & 3;
    const float um = s == 0 ? 1.f : (s == 2 ? -1.f : 0.f);
    const float vm = s == 1 ? 1.f : (s == 3 ? -1.f : 0.f);
    const float chroma = r.i[x] * (a * um) + r.q[x] * (a * vm);
    r.y[x] = r.y[x] + truncf(chroma / 50.f);
  }
  __syncthreads();
}

// qam_encode on the r.n rows held, row k at subcarrier phase xi_of(k).
template <class XiOf>
__device__ void qam_encode_rows(Row& r, XiOf xi_of, int amp) {
  const float a = (float)amp;
  for (int k = 0; k < r.n; ++k) {
    const int xi = xi_of(k);
    float* y = r.y + k * r.wp;
    const float* i = r.i + k * r.wp;
    const float* q = r.q + k * r.wp;
    for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
      const int s = (xi + x) & 3;
      const float um = s == 0 ? 1.f : (s == 2 ? -1.f : 0.f);
      const float vm = s == 1 ? 1.f : (s == 3 ? -1.f : 0.f);
      const float chroma = i[x] * (a * um) + q[x] * (a * vm);
      y[x] = y[x] + truncf(chroma / 50.f);
    }
  }
  __syncthreads();
}

// Y/C separation + demux (ffmpeg_ntsc.cpp:1497-1567) of the rows held,
// row k at subcarrier phase xi_of(k). Rotates the plane pointers: the new
// y, i, q land in former scratch planes.
template <bool ROWS, class XiOf>
__device__ void qam_decode_rows(Row& r, XiOf xi_of, int amp_back) {
  const int w = r.w, wp = r.wp;
  const float ab = (float)amp_back;
  // new luma -> t1, rescaled chroma -> t2
  for (int k = 0; k < rows_of<ROWS>(r); ++k) {
    const int x0 = (4 - xi_of(k)) & 3;
    const float* y = r.y + k * wp;
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const float prev = x == 0 ? 0.f : y[x - 1];
      const float n1 = x + 1 < w ? y[x + 1] : 0.f;
      const float n2 = x + 2 < w ? y[x + 2] : 0.f;
      const float ny = truncf((prev + y[x] + n1 + n2) / 4.f);
      float c = n2 - ny;
      const int rr = (x - x0) & 3;
      const int base = x - rr;
      if (rr >= 2 && base >= x0 && base + 3 < w) c = -c;
      r.t2[k * wp + x] = truncf((c * 50.f) / ab);
      r.t1[k * wp + x] = x < w ? ny : 0.f;
    }
  }
  __syncthreads();
  // even samples: I[x] = -chroma[x+xi], Q[x] = -chroma[x+xi+1] while
  // x+xi+1 < w (the wp-cyclic reads past that are masked off)
  for (int k = 0; k < rows_of<ROWS>(r); ++k) {
    const int xi = xi_of(k);
    const float* t2 = r.t2 + k * wp;
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const bool on = ((x & 1) == 0) && (x + xi + 1 < w);
      r.i[k * wp + x] = on ? -t2[(x + xi) % wp] : 0.f;
      r.q[k * wp + x] = on ? -t2[(x + xi + 1) % wp] : 0.f;
    }
  }
  __syncthreads();
  // odd samples: floor((p[x-1] + p[x+1]) / 2); zero tail
  const int tail = (w % 2 == 0) ? w - 2 : w - 1;
  for (int k = 0; k < rows_of<ROWS>(r); ++k) {
    const float* i = r.i + k * wp;
    const float* q = r.q + k * wp;
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const int xm = (x + wp - 1) % wp, xp = (x + 1) % wp;
      const bool even = (x & 1) == 0;
      const float iv = even ? i[x] : floorf((i[xm] + i[xp]) / 2.f);
      const float qv = even ? q[x] : floorf((q[xm] + q[xp]) / 2.f);
      r.t2[k * wp + x] = x >= tail ? 0.f : iv;
      r.y[k * wp + x] = x >= tail ? 0.f : qv;
    }
  }
  __syncthreads();
  float* ny = r.t1;
  float* ni = r.t2;
  float* nq = r.y;
  r.t1 = r.i;
  r.t2 = r.q;
  r.y = ny;
  r.i = ni;
  r.q = nq;
}

// qam_decode_rows on one row.
__device__ void qam_decode(Row& r, int xi, int amp_back) {
  qam_decode_rows<false>(r, [=](int) { return xi; }, amp_back);
}

// The planes of a CTA that holds n of up to `rows` rows (each plane
// rows * wp floats), then the carry scratch.
__device__ Row row_planes(float* sm, int w, int wp, int rows = 1,
                          int n = 1) {
  const int pw = rows * wp;
  return Row{sm,          sm + pw, sm + 2 * pw, sm + 3 * pw, sm + 4 * pw,
             sm + 5 * pw, w,       wp,          wp / BLOCK,  n};
}

// ---- the three stage groups, one row each (the TPU kernels' math:
// _kernel_a_math, _kernel_b_front, _kernel_b_back). grow is the row's
// global index in its field, which addresses the noise streams.

// Group A: RGB -> YIQ (x256, truncated), input chroma lowpass, QAM encode,
// preemphasis, luma noise. Leaves the encoded luma in r.y, zero past w.
__device__ void stage_a_row(Row& r, const uint8_t* px, int xi, uint32_t key,
                            int grow, const Tables& tab, const ChainParams& P) {
  const int w = P.w, wp = P.wp;
  for (int x = threadIdx.x; x < wp; x += BLOCK) {
    float yv = 0.f, iv = 0.f, qv = 0.f;
    if (x < w) {
      const float R = px[3 * x], G = px[3 * x + 1], B = px[3 * x + 2];
      const float dy = 0.30f * R + 0.59f * G + 0.11f * B;
      yv = truncf(256.f * dy);
      iv = truncf(256.f * ((-0.27f * (B - dy)) + (0.74f * (R - dy))));
      qv = truncf(256.f * ((0.41f * (B - dy)) + (0.48f * (R - dy))));
    }
    r.y[x] = yv;
    r.i[x] = iv;
    r.q[x] = qv;
  }
  __syncthreads();

  if (P.in_lowpass) {
    lowpass_writeback(r, r.i, tab[TAB_I], 2);
    lowpass_writeback(r, r.q, tab[TAB_Q], 4);
  }
  qam_encode(r, xi, P.amp);

  if (P.preemph) {
    pole(r.y, r.t1, tab[TAB_PRE], 16.f, r.nb, r.red);
    for (int x = threadIdx.x; x < wp; x += BLOCK)
      r.y[x] = truncf(r.y[x] + (r.y[x] - r.t1[x]) * P.pre_gain);
    __syncthreads();
  }
  if (P.video_noise)
    add_walk(r.y, r.t1, r.red, tab[TAB_WALK], key, grow, P.video_noise, 0u,
             w, wp, false);
  for (int x = threadIdx.x; x < wp; x += BLOCK)
    if (x >= w) r.y[x] = 0.f;
  __syncthreads();
}

// A row's inputs of group A: subcarrier phase, luma noise stream, global
// row in its field.
struct ARow {
  int xi;
  uint32_t key;
  int grow;
};

// stage_a_row on the r.n rows held, row k's RGB at px + k*w*3 and its
// inputs args_of(k) (an ARow); the poles and the luma noise walk of all
// rows in one multi-row call each.
template <class ArgsOf>
__device__ void stage_a_rows(Row& r, const uint8_t* px, ArgsOf args_of,
                             const Tables& tab, const ChainParams& P) {
  const int w = P.w, wp = P.wp;
  for (int k = 0; k < r.n; ++k) {
    const uint8_t* pk = px + (size_t)k * w * 3;
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      float yv = 0.f, iv = 0.f, qv = 0.f;
      if (x < w) {
        const float R = pk[3 * x], G = pk[3 * x + 1], B = pk[3 * x + 2];
        const float dy = 0.30f * R + 0.59f * G + 0.11f * B;
        yv = truncf(256.f * dy);
        iv = truncf(256.f * ((-0.27f * (B - dy)) + (0.74f * (R - dy))));
        qv = truncf(256.f * ((0.41f * (B - dy)) + (0.48f * (R - dy))));
      }
      r.y[k * wp + x] = yv;
      r.i[k * wp + x] = iv;
      r.q[k * wp + x] = qv;
    }
  }
  __syncthreads();

  if (P.in_lowpass) {
    lowpass_writeback<true>(r, r.i, tab[TAB_I], 2);
    lowpass_writeback<true>(r, r.q, tab[TAB_Q], 4);
  }
  qam_encode_rows(r, [&](int k) { return args_of(k).xi; }, P.amp);

  if (P.preemph) {
    poles<true, false>(r.y, r.t1, tab[TAB_PRE], 16.f, r);
    for (int x = threadIdx.x; x < r.n * wp; x += BLOCK)
      r.y[x] = truncf(r.y[x] + (r.y[x] - r.t1[x]) * P.pre_gain);
    __syncthreads();
  }
  if (P.video_noise) {
    const auto stream = [&](int k) {
      const ARow a = args_of(k);
      return WalkRow{a.key, a.grow};
    };
    add_walk_rows(r.y, r.t1, r.red, tab[TAB_WALK], stream, r.n,
                  P.video_noise, 0u, w, wp);
  }
  for (int k = 0; k < r.n; ++k)
    for (int x = threadIdx.x + w; x < wp; x += BLOCK) r.y[k * wp + x] = 0.f;
  __syncthreads();
}

// VHS head switch: out[x] = pad[(x + s) mod twidth], pad = row then zeros.
__device__ void head_switch_row(Row& r, int s) {
  if (s == 0) return;
  const int w = r.w;
  const int twidth = w + w / 10;
  const int sp = ((s % twidth) + twidth) % twidth;
  for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
    float v = r.y[x];
    if (x < w) {
      const int j = x + sp;
      v = j < w ? r.y[j] : (j >= twidth ? r.y[j - twidth] : 0.f);
    }
    r.t1[x] = v;
  }
  __syncthreads();
  float* t = r.y;
  r.y = r.t1;
  r.t1 = t;
}

// A row's inputs of group B1: subcarrier phase, chroma noise stream,
// global row in its field, chroma phase-noise sin and cos.
struct B1Row {
  int xi;
  uint32_t key;
  int grow;
  float sa, ca;
};

// Group B1 on the head-switched luma in r.y of the rows held, row k's
// inputs args_of(k) (a B1Row): Y/C separation + QAM decode (zeros under
// nocolor), chroma noise (the Q walk at plane offset l_glob*w), chroma
// phase noise, VHS luma and chroma bandlimit.
template <bool ROWS, class ArgsOf>
__device__ void stage_b1_rows(Row& r, ArgsOf args_of, const Tables& tab,
                              const ChainParams& P) {
  const int w = P.w, wp = P.wp;
  if (!P.nocolor) {
    qam_decode_rows<ROWS>(r, [&](int k) { return args_of(k).xi; },
                          P.amp_back);
  } else {
    for (int x = threadIdx.x; x < rows_of<ROWS>(r) * wp; x += BLOCK)
      r.i[x] = r.q[x] = 0.f;
    __syncthreads();
  }

  if (P.chroma_noise) {
    const uint32_t q_off = (uint32_t)P.l_glob * (uint32_t)w;
    if constexpr (ROWS) {
      const auto stream = [&](int k) {
        const B1Row a = args_of(k);
        return WalkRow{a.key, a.grow};
      };
      add_walk_rows(r.i, r.t1, r.red, tab[TAB_WALK], stream, r.n,
                    P.chroma_noise, 0u, w, wp);
      add_walk_rows(r.q, r.t1, r.red, tab[TAB_WALK], stream, r.n,
                    P.chroma_noise, q_off, w, wp);
    } else {
      const B1Row a = args_of(0);
      add_walk(r.i, r.t1, r.red, tab[TAB_WALK], a.key, a.grow,
               P.chroma_noise, 0u, w, wp, false);
      add_walk(r.q, r.t1, r.red, tab[TAB_WALK], a.key, a.grow,
               P.chroma_noise, q_off, w, wp, false);
    }
  }

  if (P.phase_noise) {
    for (int k = 0; k < rows_of<ROWS>(r); ++k) {
      const B1Row a = args_of(k);
      const float sa = a.sa, ca = a.ca;
      float* pi = r.i + k * wp;
      float* pq = r.q + k * wp;
      for (int x = threadIdx.x; x < wp; x += BLOCK) {
        const float iv = pi[x], qv = pq[x];
        float i2, q2;
        if (P.gen1_bug) {
          i2 = iv * ca - iv * sa;
          q2 = qv * ca + qv * sa;
        } else {
          i2 = iv * ca - qv * sa;
          q2 = iv * sa + qv * ca;
        }
        pi[x] = truncf(i2);
        pq[x] = truncf(q2);
      }
    }
    __syncthreads();
  }

  if (P.vhs) {
    poles<ROWS, true>(r.y, r.t1, tab[TAB_VLUMA], 16.f, r);
    poles<ROWS, false>(r.t1, r.t2, tab[TAB_VLUMA], 16.f, r);
    for (int k = 0; k < rows_of<ROWS>(r); ++k) {
      float* y = r.y + k * wp;
      const float* s1 = r.t1 + k * wp;
      const float* s2 = r.t2 + k * wp;
      for (int x = threadIdx.x; x < wp; x += BLOCK) {
        const float sv = s1[x];
        y[x] = x < w ? truncf(sv + (sv - s2[x]) * 1.6f) : 0.f;
      }
    }
    __syncthreads();
    lowpass_writeback<ROWS>(r, r.i, tab[TAB_VCHROMA], P.chroma_delay);
    lowpass_writeback<ROWS>(r, r.q, tab[TAB_VCHROMA], P.chroma_delay);
  }
}

// stage_b1_rows on one row.
__device__ void stage_b1_row(Row& r, int xi, uint32_t key, int grow,
                             float sa, float ca, const Tables& tab,
                             const ChainParams& P) {
  stage_b1_rows<false>(r, [=](int) { return B1Row{xi, key, grow, sa, ca}; },
                       tab, P);
}

// Group B2 on the blended planes: VHS sharpen and re-encode/decode, chroma
// dropout, Y/C recombine, output chroma lowpass.
__device__ void stage_b2_row(Row& r, int xi, float keep, const Tables& tab,
                             const ChainParams& P) {
  const int w = P.w, wp = P.wp;
  if (P.vhs) {
    pole3(r.y, r.t1, tab[TAB_SHARPEN], 0.f, r.nb, r.red);
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const float yv = r.y[x];
      r.y[x] = x < w ? truncf(yv + (yv - r.t1[x]) * P.sharpen_gain) : 0.f;
    }
    __syncthreads();
    if (!P.svideo) {
      qam_encode(r, xi, P.amp);
      qam_decode(r, xi, P.amp);
    }
  }

  if (P.chroma_loss) {
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      r.i[x] = r.i[x] * keep;
      r.q[x] = r.q[x] * keep;
    }
    __syncthreads();
  }

  for (int n = 0; n < P.yc_recombine; ++n) {
    qam_encode(r, xi, P.amp);
    qam_decode(r, xi, P.amp);
  }

  if (P.out_lowpass == 1) {
    lowpass_writeback(r, r.i, tab[TAB_TV], 1);
    lowpass_writeback(r, r.q, tab[TAB_TV], 1);
  } else if (P.out_lowpass == 2) {
    lowpass_writeback(r, r.i, tab[TAB_I], 2);
    lowpass_writeback(r, r.q, tab[TAB_Q], 4);
  }
}

// A row's inputs of group B2: subcarrier phase, chroma dropout factor.
struct B2Row {
  int xi;
  float keep;
};

// stage_b2_row on the r.n rows held, row k's inputs args_of(k) (a B2Row):
// the sharpen and each output lowpass of all rows in one multi-row pole
// call, each element-wise pass over all rows before its barrier.
template <class ArgsOf>
__device__ void stage_b2_rows(Row& r, ArgsOf args_of, const Tables& tab,
                              const ChainParams& P) {
  const int w = P.w, wp = P.wp;
  const auto xi_of = [&](int k) { return args_of(k).xi; };
  if (P.vhs) {
    poles<true, true>(r.y, r.t1, tab[TAB_SHARPEN], 0.f, r);
    for (int k = 0; k < r.n; ++k) {
      float* y = r.y + k * wp;
      const float* s = r.t1 + k * wp;
      for (int x = threadIdx.x; x < wp; x += BLOCK) {
        const float yv = y[x];
        y[x] = x < w ? truncf(yv + (yv - s[x]) * P.sharpen_gain) : 0.f;
      }
    }
    __syncthreads();
    if (!P.svideo) {
      qam_encode_rows(r, xi_of, P.amp);
      qam_decode_rows<true>(r, xi_of, P.amp);
    }
  }

  if (P.chroma_loss) {
    for (int k = 0; k < r.n; ++k) {
      const float keep = args_of(k).keep;
      float* i = r.i + k * wp;
      float* q = r.q + k * wp;
      for (int x = threadIdx.x; x < wp; x += BLOCK) {
        i[x] = i[x] * keep;
        q[x] = q[x] * keep;
      }
    }
    __syncthreads();
  }

  for (int n = 0; n < P.yc_recombine; ++n) {
    qam_encode_rows(r, xi_of, P.amp);
    qam_decode_rows<true>(r, xi_of, P.amp);
  }

  if (P.out_lowpass == 1) {
    lowpass_writeback<true>(r, r.i, tab[TAB_TV], 1);
    lowpass_writeback<true>(r, r.q, tab[TAB_TV], 1);
  } else if (P.out_lowpass == 2) {
    lowpass_writeback<true>(r, r.i, tab[TAB_I], 2);
    lowpass_writeback<true>(r, r.q, tab[TAB_Q], 4);
  }
}

// YIQ -> RGB, truncated and clamped to 0..255: the TPU path's crop-and-cast.
__device__ void store_rgb(const Row& r, uint8_t* px) {
  for (int x = threadIdx.x; x < r.w; x += BLOCK) {
    const float yv = r.y[x], iv = r.i[x], qv = r.q[x];
    const float R = truncf((1.000f * yv + 0.956f * iv + 0.621f * qv) / 256.f);
    const float G = truncf((1.000f * yv - 0.272f * iv - 0.647f * qv) / 256.f);
    const float B = truncf((1.000f * yv - 1.106f * iv + 1.703f * qv) / 256.f);
    px[3 * x] = (uint8_t)fminf(fmaxf(R, 0.f), 255.f);
    px[3 * x + 1] = (uint8_t)fminf(fmaxf(G, 0.f), 255.f);
    px[3 * x + 2] = (uint8_t)fminf(fmaxf(B, 0.f), 255.f);
  }
}

// ---- kernel #1: the whole chain in two launches

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yiq_front(const uint8_t* __restrict__ rgb, const int* __restrict__ xi_tab,
          const uint32_t* __restrict__ keys, const float* __restrict__ sincos,
          const int* __restrict__ shifts, Tables tab, ChainParams P,
          float* __restrict__ y_out, float* __restrict__ i_out,
          float* __restrict__ q_out) {
  extern __shared__ float sm[];
  const int row = blockIdx.x;           // field * L + line
  const int fld = row / P.l, grow = P.row0 + row % P.l;
  const int wp = P.wp;
  Row r = row_planes(sm, P.w, wp);
  const int xi = xi_tab[row];

  stage_a_row(r, rgb + (size_t)row * P.w * 3, xi, keys[2 * fld], grow, tab, P);
  head_switch_row(r, shifts[row]);
  stage_b1_row(r, xi, keys[2 * fld + 1], grow, sincos[2 * row],
               sincos[2 * row + 1], tab, P);

  const size_t off = (size_t)row * wp;
  for (int x = threadIdx.x; x < wp; x += BLOCK) {
    y_out[off + x] = r.y[x];
    i_out[off + x] = r.i[x];
    q_out[off + x] = r.q[x];
  }
}

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yiq_back(const float* __restrict__ y_in, const float* __restrict__ i_in,
         const float* __restrict__ q_in, const int* __restrict__ xi_tab,
         const float* __restrict__ keep, Tables tab, ChainParams P,
         uint8_t* __restrict__ out) {
  extern __shared__ float sm[];
  const int row = blockIdx.x;
  const int line = row % P.l;
  const int wp = P.wp;
  Row r = row_planes(sm, P.w, wp);
  const size_t off = (size_t)row * wp;

  // 2-line chroma blend against the front output of the line above: line
  // 0 kept, line 1 blended with 0 (reference quirk), floor((p+c+1)/2)
  const bool blend = P.vblend && line > 0;
  for (int x = threadIdx.x; x < wp; x += BLOCK) {
    float iv = i_in[off + x], qv = q_in[off + x];
    if (blend) {
      const float pi = line == 1 ? 0.f : i_in[off - wp + x];
      const float pq = line == 1 ? 0.f : q_in[off - wp + x];
      iv = floorf((pi + iv + 1.f) / 2.f);
      qv = floorf((pq + qv + 1.f) / 2.f);
    }
    r.y[x] = y_in[off + x];
    r.i[x] = iv;
    r.q[x] = qv;
  }
  __syncthreads();

  stage_b2_row(r, xi_tab[row], keep[row], tab, P);
  store_rgb(r, out + (size_t)row * P.w * 3);
}

// ---- kernels #2-#4: the split chain of a row shard (rows row0 ..
// row0 + l - 1 of fields l_glob rows high). The head switch and the
// vertical blend run between the launches (models/fused_yiq.py), as the
// TPU program runs them between its kernels.

// #2: uint8 RGB -> encoded luma plane (zero past w). ROWS false: one
// (field, line) row a CTA (rows_per_cta == 1), through the one-row
// function #1 runs; true: the rows_per_cta consecutive rows of a CTA
// together (the last CTA may hold fewer), which on a shard of odd height
// may belong to two fields.
template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yiq_a(const uint8_t* __restrict__ rgb, const int* __restrict__ xi_tab,
      const uint32_t* __restrict__ keys, Tables tab, ChainParams P,
      int rows_per_cta, float* __restrict__ y_out) {
  extern __shared__ float sm[];
  if constexpr (!ROWS) {
    const int row = blockIdx.x;
    const int fld = row / P.l, grow = P.row0 + row % P.l;
    Row r = row_planes(sm, P.w, P.wp);
    stage_a_row(r, rgb + (size_t)row * P.w * 3, xi_tab[row], keys[2 * fld],
                grow, tab, P);
    const size_t off = (size_t)row * P.wp;
    for (int x = threadIdx.x; x < P.wp; x += BLOCK) y_out[off + x] = r.y[x];
  } else {
    const int row0 = blockIdx.x * rows_per_cta;  // field * L + line
    const int n = min(rows_per_cta, P.b * P.l - row0);
    Row r = row_planes(sm, P.w, P.wp, rows_per_cta, n);
    stage_a_rows(r, rgb + (size_t)row0 * P.w * 3, [&](int k) {
      const int row = row0 + k;
      return ARow{xi_tab[row], keys[2 * (row / P.l)], P.row0 + row % P.l};
    }, tab, P);
    const size_t off = (size_t)row0 * P.wp;
    for (int x = threadIdx.x; x < n * P.wp; x += BLOCK) y_out[off + x] = r.y[x];
  }
}

// #3: head-switched luma plane -> y, i, q planes (zero past w). ROWS
// false: one (field, line) row a CTA (rows_per_cta == 1), through the
// one-row functions #1 runs; true: the rows_per_cta consecutive rows of a
// CTA together (the last CTA may hold fewer).
template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yiq_b1(const float* __restrict__ y_in, const int* __restrict__ xi_tab,
       const uint32_t* __restrict__ keys, const float* __restrict__ sincos,
       Tables tab, ChainParams P, int rows_per_cta, float* __restrict__ y_out,
       float* __restrict__ i_out, float* __restrict__ q_out) {
  extern __shared__ float sm[];
  const int R = ROWS ? rows_per_cta : 1;
  const int row0 = blockIdx.x * R;    // field * L + line of the first row
  const int n = ROWS ? min(R, P.b * P.l - row0) : 1;
  const int w = P.w, wp = P.wp;
  Row r = row_planes(sm, w, wp, R, n);
  const size_t off = (size_t)row0 * wp;
  for (int x = threadIdx.x; x < n * wp; x += BLOCK) r.y[x] = y_in[off + x];
  __syncthreads();
  const auto args_of = [&](int k) {
    const int row = row0 + k, fld = row / P.l;
    return B1Row{xi_tab[row], keys[2 * fld + 1], P.row0 + row % P.l,
                 sincos[2 * row], sincos[2 * row + 1]};
  };
  if constexpr (ROWS) {
    stage_b1_rows<true>(r, args_of, tab, P);
  } else {
    const B1Row a = args_of(0);
    stage_b1_row(r, a.xi, a.key, a.grow, a.sa, a.ca, tab, P);
  }
  for (int k = 0; k < n; ++k) {
    const size_t o = off + (size_t)k * wp;
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const bool on = x < w;
      y_out[o + x] = on ? r.y[k * wp + x] : 0.f;
      i_out[o + x] = on ? r.i[k * wp + x] : 0.f;
      q_out[o + x] = on ? r.q[k * wp + x] : 0.f;
    }
  }
}

// #4: blended y, i, q planes -> uint8 RGB. ROWS false: one (field, line)
// row a CTA (rows_per_cta == 1), through the one-row functions #1 runs;
// true: the rows_per_cta consecutive rows of a CTA together (the last CTA
// may hold fewer), each row's bytes stored where one-row code stores them.
template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yiq_b2(const float* __restrict__ y_in, const float* __restrict__ i_in,
       const float* __restrict__ q_in, const int* __restrict__ xi_tab,
       const float* __restrict__ keep, Tables tab, ChainParams P,
       int rows_per_cta, uint8_t* __restrict__ out) {
  extern __shared__ float sm[];
  const int R = ROWS ? rows_per_cta : 1;
  const int row0 = blockIdx.x * R;    // field * L + line of the first row
  const int n = ROWS ? min(R, P.b * P.l - row0) : 1;
  const int wp = P.wp;
  Row r = row_planes(sm, P.w, wp, R, n);
  const size_t off = (size_t)row0 * wp;
  for (int x = threadIdx.x; x < n * wp; x += BLOCK) {
    r.y[x] = y_in[off + x];
    r.i[x] = i_in[off + x];
    r.q[x] = q_in[off + x];
  }
  __syncthreads();
  if constexpr (ROWS) {
    stage_b2_rows(r, [&](int k) {
      return B2Row{xi_tab[row0 + k], keep[row0 + k]};
    }, tab, P);
  } else {
    stage_b2_row(r, xi_tab[row0], keep[row0], tab, P);
  }
  for (int k = 0; k < n; ++k) {
    Row rk = r;
    rk.y += k * wp;
    rk.i += k * wp;
    rk.q += k * wp;
    store_rgb(rk, out + (size_t)(row0 + k) * P.w * 3);
  }
}

}  // namespace cvsim

using namespace cvsim;

namespace {

// Checks the launch shape and raises the dynamic shared-memory limit of
// `kernel` where the planes of a CTA of `rows` rows need more than the
// default 48 KB; returns 0 or a cudaError_t.
template <typename K>
int prepare_launch(K kernel, const ChainParams& P, size_t* smem,
                   int rows = 1) {
  if (P.wp % BLOCK != 0 || P.w > P.wp || P.w < 3) return (int)cudaErrorInvalidValue;
  if (P.row0 < 0 || P.row0 + P.l > P.l_glob) return (int)cudaErrorInvalidValue;
  if (rows < 1 || rows > ROUND) return (int)cudaErrorInvalidValue;
  *smem = (size_t)(ROW_PLANES * rows * P.wp + RED_FLOATS) * sizeof(float);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
}

Tables tables(const void* tt, const void* d, const void* tt3, const void* d3,
              const void* vt) {
  return Tables{static_cast<const float*>(tt), static_cast<const float*>(d),
                static_cast<const float*>(tt3), static_cast<const float*>(d3),
                static_cast<const float*>(vt)};
}

}  // namespace

// C entry points (bound with ctypes by cvsim_tpu_torch/kernels.py). Each
// launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() (0 on success).

// Kernel #1, the whole chain: both launches.
extern "C" int cvsim_yiq_chain(const void* rgb, const void* xi,
                               const void* keys, const void* sincos,
                               const void* keep, const void* shifts,
                               const void* tt, const void* d, const void* tt3,
                               const void* d3, const void* vt, void* scratch,
                               void* out, const void* params, void* stream) {
  const ChainParams P = *static_cast<const ChainParams*>(params);
  size_t smem = 0;
  int rc = prepare_launch(yiq_front, P, &smem);
  if (rc == 0) rc = prepare_launch(yiq_back, P, &smem);
  if (rc != 0) return rc;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const Tables tab = tables(tt, d, tt3, d3, vt);
  float* y = static_cast<float*>(scratch);
  float* i = y + (size_t)rows * P.wp;
  float* q = i + (size_t)rows * P.wp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  yiq_front<<<rows, BLOCK, smem, s>>>(
      static_cast<const uint8_t*>(rgb), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), static_cast<const float*>(sincos),
      static_cast<const int*>(shifts), tab, P, y, i, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  yiq_back<<<rows, BLOCK, smem, s>>>(y, i, q, static_cast<const int*>(xi),
                                     static_cast<const float*>(keep), tab, P,
                                     static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// The rows a CTA of cvsim_yiq_a, cvsim_yiq_b1 and cvsim_yiq_b2 at padded
// width wp on the current device.
extern "C" int cvsim_yiq_a_rows_per_cta(int wp) {
  return rows_per_cta(wp, ROW_PLANES);
}

extern "C" int cvsim_yiq_b1_rows_per_cta(int wp) {
  return rows_per_cta(wp, ROW_PLANES);
}

extern "C" int cvsim_yiq_b2_rows_per_cta(int wp) {
  return rows_per_cta(wp, ROW_PLANES);
}

// Kernel #2: uint8 RGB [b, l, w, 3] -> encoded luma f32 [b, l, wp],
// cvsim_yiq_a_rows_per_cta(wp) rows a CTA.
extern "C" int cvsim_yiq_a(const void* rgb, const void* xi, const void* keys,
                           const void* tt, const void* d, const void* tt3,
                           const void* d3, const void* vt, void* y_out,
                           const void* params, void* stream) {
  const ChainParams P = *static_cast<const ChainParams*>(params);
  size_t smem = 0;
  const int R = rows_per_cta(P.wp, ROW_PLANES);
  const auto kernel = R == 1 ? yiq_a<false> : yiq_a<true>;
  const int rc = prepare_launch(kernel, P, &smem, R);
  if (rc != 0) return rc;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const int ctas = (rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), tables(tt, d, tt3, d3, vt), P, R,
      static_cast<float*>(y_out));
  return (int)cudaGetLastError();
}

// Kernel #3: head-switched luma f32 [b, l, wp] -> y, i, q f32 [b, l, wp],
// cvsim_yiq_b1_rows_per_cta(wp) rows a CTA.
extern "C" int cvsim_yiq_b1(const void* y_in, const void* xi, const void* keys,
                            const void* sincos, const void* tt, const void* d,
                            const void* tt3, const void* d3, const void* vt,
                            void* y_out, void* i_out, void* q_out,
                            const void* params, void* stream) {
  const ChainParams P = *static_cast<const ChainParams*>(params);
  size_t smem = 0;
  const int R = rows_per_cta(P.wp, ROW_PLANES);
  const auto kernel = R == 1 ? yiq_b1<false> : yiq_b1<true>;
  const int rc = prepare_launch(kernel, P, &smem, R);
  if (rc != 0) return rc;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const int ctas = (rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_in), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), static_cast<const float*>(sincos),
      tables(tt, d, tt3, d3, vt), P, R, static_cast<float*>(y_out),
      static_cast<float*>(i_out), static_cast<float*>(q_out));
  return (int)cudaGetLastError();
}

// Kernel #4: blended y, i, q f32 [b, l, wp] -> uint8 RGB [b, l, w, 3],
// cvsim_yiq_b2_rows_per_cta(wp) rows a CTA.
extern "C" int cvsim_yiq_b2(const void* y_in, const void* i_in,
                            const void* q_in, const void* xi, const void* keep,
                            const void* tt, const void* d, const void* tt3,
                            const void* d3, const void* vt, void* out,
                            const void* params, void* stream) {
  const ChainParams P = *static_cast<const ChainParams*>(params);
  size_t smem = 0;
  const int R = rows_per_cta(P.wp, ROW_PLANES);
  const auto kernel = R == 1 ? yiq_b2<false> : yiq_b2<true>;
  const int rc = prepare_launch(kernel, P, &smem, R);
  if (rc != 0) return rc;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const int ctas = (rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_in), static_cast<const float*>(i_in),
      static_cast<const float*>(q_in), static_cast<const int*>(xi),
      static_cast<const float*>(keep), tables(tt, d, tt3, d3, vt), P, R,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* cvsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
