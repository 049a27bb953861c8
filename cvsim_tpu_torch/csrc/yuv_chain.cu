// The whole gen-1 composite chain (ffmpeg_to_composite) for a batch of
// fields of 8-bit YUV 4:2:2.
//
// Replaces the TPU kernel cvsim_tpu/models/fused_yuv.py _make_kernel_ab
// (launched by composite_video_process_fused): input chroma lowpass, QAM
// encode, preemphasis, luma noise, VHS head switch, Y/C separation + QAM
// decode, chroma AM and phase noise (with the gen-1 rotation bug), VHS
// bandlimit, 2-line chroma blend, luma and chroma sharpen, re-encode/
// decode, dropout, Y/C recombine, output lowpass. It computes what that
// kernel computes, sample for sample, including the clampu8 at every
// place the reference writes back to its u8 planes; the plain version it
// is held against is models/fused_yuv.chain_reference.
//
// Design (that of yiq_chain.cu). Every stage is local to one scanline
// except the chroma vertical blend, and the head switch is a per-row
// rotation by a precomputed shift with luma-black (16) fill. So the chain
// runs as two launches with one CTA of 128 threads per (field, row):
//   yuv_front: uint8 planes in -> kernel-A math (_a_math), head switch,
//              _b_front (decode, chroma noise, phase noise, VHS bandlimit)
//              -> uint8 y, u, v planes in scratch;
//   yuv_back:  the blend against row l-1's front output (row 1 against
//              128), then _b_back (sharpen, recombine, dropout, output
//              lowpass) -> uint8 out.
// Every value the front hands over is a clamped integer, so the scratch
// planes are uint8 at the active widths. The row's planes live in shared
// memory: luma y and two luma temporaries (wp floats each), chroma u, v
// and one chroma temporary (wp2 floats each): 35 KB at 1080i (W = 1888).
// The TPU kernel's stride-2 pick matrices (_down/_up) are direct indexing
// here, and nothing is tiled or windowed.
//
// What bounds it: the pole products, as in yiq_chain.cu (a 128x128
// lower-triangular product per block, pole.cuh). The chroma poles run at
// half width (three blocks at 720 samples), so a row holds many short
// products, each with its three barriers and its serial carry chain over
// the blocks; the load units and those barriers, not the multiply-adds,
// set the pace (PERF.md). Device memory carries about 8 bytes per luma
// sample. The design answers it as yiq_chain.cu does: every block's
// product before any carry, table entries reused over a thread's blocks,
// the row on chip, four CTAs an SM.
//
// #6, #7 and #8 (the split program's A, B1 and B2, whose pole calls are
// mostly on the half-width chroma) take R consecutive rows a CTA, R chosen
// per width by gen1::rows_per_cta (4 at 576i, 1 at 1080i on an H100), and
// run the rows' poles through the multi-row primitives (pole_rows,
// pole3_rows, add_walk_rows), so that each table entry a thread loads and
// each barrier serve the blocks of all R rows. The multi-row functions (the
// *_rows section) repeat the one-row functions' operations row by row; the
// one-row functions are left as #5 (and #6-#8 at R = 1) compiled them,
// since a ROWS template parameter on them (as in yiq_chain.cu) made #5's
// yuv_back spill and run 4-7% slower (PERF.md). Each output keeps its
// operation sequence (testing.PINNED_CASE_CRC32).

#include <cuda_runtime.h>

#include <cstdint>

#include "noise.cuh"
#include "pole.cuh"

namespace cvsim {
namespace gen1 {

// Launch arguments; mirrored by models/fused_yuv._YuvParams.
struct Params {
  int b, l, w, wp, w2, wp2;
  int amp, amp_back;
  int in_lowpass, v_delay;  // U delay is always 2
  int preemph;
  float pre_gain;
  int video_noise, chroma_noise, phase_noise;
  int vhs, chroma_delay, vblend;
  float sharpen_gain, sharpen_chroma_gain;
  int svideo, chroma_loss, yc_recombine;
  int out_lowpass;  // 0 none, 1 lite (rate/4, delay 1), 2 full
};

// table rows (fused_yuv._alpha_consts_gen1)
enum { TAB_U = 0, TAB_U_HP = 1, TAB_V = 2, TAB_V_HP = 3, TAB_PRE = 4,
       TAB_VLUMA = 5, TAB_VCHROMA = 6, TAB_SHARP_Y = 7, TAB_SHARP_C = 8,
       TAB_LITE = 9, TAB_WALK = 10 };

// Shared-memory working set of a CTA: luma y and two luma temporaries, each
// n rows of wp floats one after another, and chroma u, v and one chroma
// temporary, each n rows of wp2 floats (n = 1 in the one-row kernels).
constexpr int LUMA_PLANES = 3, CHROMA_PLANES = 3;
struct Row {
  float *y, *t1, *t2;  // luma and two luma temporaries
  float *u, *v, *tc;   // chroma and one chroma temporary
  float* red;          // RED_FLOATS floats: the poles' block carries
  int w, wp, nb, w2, wp2, nb2;
  int n;               // rows held
};

// Floats of one row's planes.
__host__ __device__ inline int row_floats(const Params& P) {
  return LUMA_PLANES * P.wp + CHROMA_PLANES * P.wp2;
}

// The planes of a CTA that holds n of up to `rows` rows, then the carry
// scratch.
__device__ Row row_planes(float* sm, const Params& P, int rows = 1,
                          int n = 1) {
  const int pw = rows * P.wp, pw2 = rows * P.wp2;
  Row r;
  r.y = sm;
  r.t1 = sm + pw;
  r.t2 = sm + 2 * pw;
  r.u = sm + 3 * pw;
  r.v = r.u + pw2;
  r.tc = r.v + pw2;
  r.red = r.tc + pw2;
  r.w = P.w;
  r.wp = P.wp;
  r.nb = P.wp / BLOCK;
  r.w2 = P.w2;
  r.wp2 = P.wp2;
  r.nb2 = P.wp2 / BLOCK;
  r.n = n;
  return r;
}

// The reference's delayed in-place writeback of a filtered chroma plane
// (r.tc): p[x] = clampu8(tc[x+delay]) for x < w2-delay, unchanged up to
// w2, 0 beyond.
__device__ void chroma_writeback(Row& r, float* p, int delay) {
  for (int x = threadIdx.x; x < r.wp2; x += BLOCK) {
    const float v = (x < r.w2 - delay) ? u8f(r.tc[x + delay]) : p[x];
    p[x] = (x < r.w2) ? v : 0.f;
  }
  __syncthreads();
}

// composite_video_chroma_lowpass on one plane: s = 2p - pole_{cut/2}(p),
// then three poles at the cut, clampu8 delayed writeback.
__device__ void chroma_lowpass_full(Row& r, float* p, const PoleTables& hp,
                                    const PoleTables& lp, int delay) {
  pole(p, r.tc, hp, 128.f, r.nb2, r.red);
  for (int x = threadIdx.x; x < r.wp2; x += BLOCK) r.tc[x] = 2.f * p[x] - r.tc[x];
  __syncthreads();
  pole3(r.tc, r.tc, lp, 128.f, r.nb2, r.red);
  chroma_writeback(r, p, delay);
}

// Three poles with register reset 128, clampu8 delayed writeback (the
// VHS chroma bandlimit and the _lite output lowpass).
__device__ void chroma_lowpass3(Row& r, float* p, const PoleTables& tab,
                                int delay) {
  pole3(p, r.tc, tab, 128.f, r.nb2, r.red);
  chroma_writeback(r, p, delay);
}

// yuv_to_ntsc: y = clampu8(y + trunc(chroma / 50)) with the 4:2:2 chroma
// repeated to full width; 0 past w.
__device__ void qam_encode_u8(Row& r, int xi, int amp) {
  const float a = (float)amp;
  for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
    float out = 0.f;
    if (x < r.w) {
      const int s = (xi + x) & 3;
      const float um = s == 0 ? 1.f : (s == 2 ? -1.f : 0.f);
      const float vm = s == 1 ? 1.f : (s == 3 ? -1.f : 0.f);
      const int x2 = x >> 1;
      const float u2 = (x2 < r.w2 ? r.u[x2] : 0.f) - 128.f;
      const float v2 = (x2 < r.w2 ? r.v[x2] : 0.f) - 128.f;
      const float chroma = u2 * (a * um) + v2 * (a * vm);
      out = u8f(r.y[x] + truncf(chroma / 50.f));
    }
    r.y[x] = out;
  }
  __syncthreads();
}

// ntsc_to_yuv: box blur precharged with luma black 16, chroma =
// clampu8(y[x+2] + 128 - new_y), 255-c flip on the negative half-cycles
// (in-range samples only), biased rescale, phase-swapped demux of the
// even/odd samples into U, V. Rotates the luma plane pointers.
__device__ void qam_decode_u8(Row& r, int xi, int amp_back) {
  const int w = r.w;
  const int x0 = (4 - xi) & 3;
  const float ab = (float)amp_back;
  for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
    const float prev = x == 0 ? 16.f : r.y[x - 1];
    const float n1 = x + 1 < w ? r.y[x + 1] : 16.f;
    const float n2 = x + 2 < w ? r.y[x + 2] : 16.f;
    const float ny = floorf((prev + r.y[x] + n1 + n2) / 4.f);
    float c = u8f(n2 + 128.f - ny);
    const int rr = (x - x0) & 3;
    if (rr >= 2 && x - rr >= x0) c = 255.f - c;
    r.t2[x] = u8f(truncf(((c - 128.f) * 50.f) / ab) + 128.f);
    r.t1[x] = x < w ? ny : 0.f;
  }
  __syncthreads();
  const bool odd = (xi & 1) == 1;
  for (int x = threadIdx.x; x < r.wp2; x += BLOCK) {
    float nu = 0.f, nv = 0.f;
    if (x < r.w2) {
      const float ce = r.t2[2 * x], co = r.t2[2 * x + 1];
      nu = odd ? 255.f - co : 255.f - ce;
      nv = odd ? 255.f - ce : 255.f - co;
    }
    r.u[x] = nu;
    r.v[x] = nv;
  }
  __syncthreads();
  float* t = r.y;
  r.y = r.t1;
  r.t1 = t;
}

__device__ void mask_luma(Row& r) {
  for (int x = threadIdx.x + r.w; x < r.wp; x += BLOCK) r.y[x] = 0.f;
  __syncthreads();
}

// ---- the row functions: the TPU kernels' three groups and the seam
// between the first two. Each is entered and left by all 128 threads and
// ends synchronised.

// Loads uint8 row planes, zero past the active widths. With `blend`, the
// chroma of line `line` > 0 is the 2-line vertical blend against the
// previous line of the same planes (pu - w2), or against 128 for line 1
// (the reference's delay line starts at 128): floor((p + c + 1) / 2).
__device__ void load_planes(Row& r, const uint8_t* py, const uint8_t* pu,
                            const uint8_t* pv, bool blend, int line) {
  const int w2 = r.w2;
  for (int x = threadIdx.x; x < r.wp; x += BLOCK) r.y[x] = x < r.w ? (float)py[x] : 0.f;
  if (pu != nullptr) {
    for (int x = threadIdx.x; x < r.wp2; x += BLOCK) {
      float uv = 0.f, vv = 0.f;
      if (x < w2) {
        uv = pu[x];
        vv = pv[x];
        if (blend) {
          const float qu = line == 1 ? 128.f : (float)pu[x - w2];
          const float qv = line == 1 ? 128.f : (float)pv[x - w2];
          uv = floorf((qu + uv + 1.f) / 2.f);
          vv = floorf((qv + vv + 1.f) / 2.f);
        }
      }
      r.u[x] = uv;
      r.v[x] = vv;
    }
  }
  __syncthreads();
}

// Stores the active samples of the row planes as uint8 (each value is a
// clamped integer); u and v only when ou is given.
__device__ void store_planes(const Row& r, uint8_t* oy, uint8_t* ou,
                             uint8_t* ov) {
  for (int x = threadIdx.x; x < r.w; x += BLOCK) oy[x] = (uint8_t)r.y[x];
  if (ou != nullptr) {
    for (int x = threadIdx.x; x < r.w2; x += BLOCK) {
      ou[x] = (uint8_t)r.u[x];
      ov[x] = (uint8_t)r.v[x];
    }
  }
}

// _a_math: input chroma lowpass, QAM encode, preemphasis, luma noise ->
// the encoded luma in r.y (0 past w).
__device__ void a_row(Row& r, const Tables& tab, const Params& P, int xi,
                      uint32_t key, int line) {
  if (P.in_lowpass) {
    chroma_lowpass_full(r, r.u, tab[TAB_U_HP], tab[TAB_U], 2);
    chroma_lowpass_full(r, r.v, tab[TAB_V_HP], tab[TAB_V], P.v_delay);
  }
  qam_encode_u8(r, xi, P.amp);
  if (P.preemph) {
    pole(r.y, r.t1, tab[TAB_PRE], 16.f, r.nb, r.red);
    for (int x = threadIdx.x; x < r.wp; x += BLOCK)
      r.y[x] = u8f(r.y[x] + (r.y[x] - r.t1[x]) * P.pre_gain);
    __syncthreads();
  }
  if (P.video_noise)
    add_walk(r.y, r.t1, r.red, tab[TAB_WALK], key, line, P.video_noise, 0u,
             r.w, r.wp, true);
  mask_luma(r);
}

// The VHS head switch: out[x] = pad[(x + s) mod twidth] over the row
// padded with luma black (16) to twidth = w + w/10; gen-1 takes the switch
// point for both axes, so s comes from the shared shift table.
__device__ void head_switch_row(Row& r, int s) {
  if (s == 0) return;
  const int w = r.w;
  const int twidth = w + w / 10;
  const int sp = ((s % twidth) + twidth) % twidth;
  for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
    float v = r.y[x];
    if (x < w) {
      const int j = x + sp;
      v = j < w ? r.y[j] : (j >= twidth ? r.y[j - twidth] : 16.f);
    }
    r.t1[x] = v;
  }
  __syncthreads();
  float* t = r.y;
  r.y = r.t1;
  r.t1 = t;
}

// _b_front: decode, chroma noise, chroma phase noise (the gen-1 rotation
// bug), VHS bandlimit -> y, u, v in r.
__device__ void b1_row(Row& r, const Tables& tab, const Params& P, int xi,
                       uint32_t key, int line, float sa, float ca) {
  const int w = r.w, wp = r.wp, w2 = r.w2, wp2 = r.wp2;
  qam_decode_u8(r, xi, P.amp_back);
  if (P.chroma_noise) {
    add_walk(r.u, r.tc, r.red, tab[TAB_WALK], key, line, P.chroma_noise, 0u,
             w2, wp2, true);
    add_walk(r.v, r.tc, r.red, tab[TAB_WALK], key, line, P.chroma_noise,
             (uint32_t)P.l * (uint32_t)w2, w2, wp2, true);
  }
  if (P.phase_noise) {
    // the gen-1 rotation bug: u' = u cos - u sin, v' = v cos + v sin
    for (int x = threadIdx.x; x < wp2; x += BLOCK) {
      const float uu = r.u[x] - 128.f, vv = r.v[x] - 128.f;
      r.u[x] = x < w2 ? u8f(uu * ca - uu * sa + 128.f) : 0.f;
      r.v[x] = x < w2 ? u8f(vv * ca + vv * sa + 128.f) : 0.f;
    }
    __syncthreads();
  }
  if (P.vhs) {
    // luma: 3 lowpasses, then emphasis against a 4th same-cut pole
    pole3(r.y, r.t1, tab[TAB_VLUMA], 16.f, r.nb, r.red);
    pole(r.t1, r.t2, tab[TAB_VLUMA], 16.f, r.nb, r.red);
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const float t = r.t1[x];
      r.y[x] = x < w ? u8f(t + (t - r.t2[x]) * 1.6f) : 0.f;
    }
    __syncthreads();
    chroma_lowpass3(r, r.u, tab[TAB_VCHROMA], P.chroma_delay);
    chroma_lowpass3(r, r.v, tab[TAB_VCHROMA], P.chroma_delay);
  }
}

// _b_back: luma and chroma sharpen, re-encode/decode, dropout, Y/C
// recombine, output lowpass.
__device__ void b2_row(Row& r, const Tables& tab, const Params& P, int xi,
                       float keep) {
  const int w = r.w, wp = r.wp, w2 = r.w2, wp2 = r.wp2;
  if (P.vhs) {
    pole3(r.y, r.t1, tab[TAB_SHARP_Y], 16.f, r.nb, r.red);
    for (int x = threadIdx.x; x < wp; x += BLOCK) {
      const float yv = r.y[x];
      r.y[x] = x < w ? u8f(yv + (yv - r.t1[x]) * P.sharpen_gain) : 0.f;
    }
    __syncthreads();
    float* planes[2] = {r.u, r.v};
    for (float* p : planes) {
      pole3(p, r.tc, tab[TAB_SHARP_C], 128.f, r.nb2, r.red);
      for (int x = threadIdx.x; x < wp2; x += BLOCK) {
        const float pv2 = p[x];
        p[x] = x < w2 ? u8f(pv2 + (pv2 - r.tc[x]) * P.sharpen_chroma_gain) : 0.f;
      }
      __syncthreads();
    }
    if (!P.svideo) {
      qam_encode_u8(r, xi, P.amp);
      qam_decode_u8(r, xi, P.amp);
    }
  }
  if (P.chroma_loss) {
    for (int x = threadIdx.x; x < wp2; x += BLOCK) {
      r.u[x] = x < w2 ? r.u[x] * keep + 128.f * (1.f - keep) : 0.f;
      r.v[x] = x < w2 ? r.v[x] * keep + 128.f * (1.f - keep) : 0.f;
    }
    __syncthreads();
  }
  for (int n = 0; n < P.yc_recombine; ++n) {
    qam_encode_u8(r, xi, P.amp);
    qam_decode_u8(r, xi, P.amp);
  }
  if (P.out_lowpass == 2) {
    chroma_lowpass_full(r, r.u, tab[TAB_U_HP], tab[TAB_U], 2);
    chroma_lowpass_full(r, r.v, tab[TAB_V_HP], tab[TAB_V], P.v_delay);
  } else if (P.out_lowpass == 1) {
    chroma_lowpass3(r, r.u, tab[TAB_LITE], 1);
    chroma_lowpass3(r, r.v, tab[TAB_LITE], 1);
  }
}

// ---- the multi-row forms of #6 (_a_math), #7 (_b_front) and #8
// (_b_back): the one-row
// functions' operations on each of the r.n rows held (each plane's row k
// at offset k * wp, or k * wp2 for chroma), the poles of all rows in one
// multi-row call (pole.cuh). Each output is computed as the one-row
// function computes it on that row alone.

// chroma_writeback on the rows held.
__device__ void chroma_writeback_rows(Row& r, float* p, int delay) {
  for (int k = 0; k < r.n; ++k) {
    float* pk = p + k * r.wp2;
    const float* tk = r.tc + k * r.wp2;
    for (int x = threadIdx.x; x < r.wp2; x += BLOCK) {
      const float v = (x < r.w2 - delay) ? u8f(tk[x + delay]) : pk[x];
      pk[x] = (x < r.w2) ? v : 0.f;
    }
  }
  __syncthreads();
}

// chroma_lowpass_full on the rows held.
__device__ void chroma_lowpass_full_rows(Row& r, float* p,
                                         const PoleTables& hp,
                                         const PoleTables& lp, int delay) {
  pole_rows(p, r.tc, hp, 128.f, r.n, r.nb2, r.red);
  for (int x = threadIdx.x; x < r.n * r.wp2; x += BLOCK)
    r.tc[x] = 2.f * p[x] - r.tc[x];
  __syncthreads();
  pole3_rows(r.tc, r.tc, lp, 128.f, r.n, r.nb2, r.red);
  chroma_writeback_rows(r, p, delay);
}

// chroma_lowpass3 on the rows held.
__device__ void chroma_lowpass3_rows(Row& r, float* p, const PoleTables& tab,
                                     int delay) {
  pole3_rows(p, r.tc, tab, 128.f, r.n, r.nb2, r.red);
  chroma_writeback_rows(r, p, delay);
}

// qam_encode_u8 on the rows held, row k at subcarrier phase xi_of(k).
template <class XiOf>
__device__ void qam_encode_rows(Row& r, XiOf xi_of, int amp) {
  const float a = (float)amp;
  for (int k = 0; k < r.n; ++k) {
    const int xi = xi_of(k);
    float* y = r.y + k * r.wp;
    const float* u = r.u + k * r.wp2;
    const float* v = r.v + k * r.wp2;
    for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
      float out = 0.f;
      if (x < r.w) {
        const int s = (xi + x) & 3;
        const float um = s == 0 ? 1.f : (s == 2 ? -1.f : 0.f);
        const float vm = s == 1 ? 1.f : (s == 3 ? -1.f : 0.f);
        const int x2 = x >> 1;
        const float u2 = (x2 < r.w2 ? u[x2] : 0.f) - 128.f;
        const float v2 = (x2 < r.w2 ? v[x2] : 0.f) - 128.f;
        const float chroma = u2 * (a * um) + v2 * (a * vm);
        out = u8f(y[x] + truncf(chroma / 50.f));
      }
      y[x] = out;
    }
  }
  __syncthreads();
}

// qam_decode_u8 on the rows held, row k at subcarrier phase xi_of(k).
// Rotates the luma plane pointers.
template <class XiOf>
__device__ void qam_decode_rows(Row& r, XiOf xi_of, int amp_back) {
  const int w = r.w;
  const float ab = (float)amp_back;
  for (int k = 0; k < r.n; ++k) {
    const int x0 = (4 - xi_of(k)) & 3;
    const float* y = r.y + k * r.wp;
    float* t1 = r.t1 + k * r.wp;
    float* t2 = r.t2 + k * r.wp;
    for (int x = threadIdx.x; x < r.wp; x += BLOCK) {
      const float prev = x == 0 ? 16.f : y[x - 1];
      const float n1 = x + 1 < w ? y[x + 1] : 16.f;
      const float n2 = x + 2 < w ? y[x + 2] : 16.f;
      const float ny = floorf((prev + y[x] + n1 + n2) / 4.f);
      float c = u8f(n2 + 128.f - ny);
      const int rr = (x - x0) & 3;
      if (rr >= 2 && x - rr >= x0) c = 255.f - c;
      t2[x] = u8f(truncf(((c - 128.f) * 50.f) / ab) + 128.f);
      t1[x] = x < w ? ny : 0.f;
    }
  }
  __syncthreads();
  for (int k = 0; k < r.n; ++k) {
    const bool odd = (xi_of(k) & 1) == 1;
    const float* t2 = r.t2 + k * r.wp;
    float* u = r.u + k * r.wp2;
    float* v = r.v + k * r.wp2;
    for (int x = threadIdx.x; x < r.wp2; x += BLOCK) {
      float nu = 0.f, nv = 0.f;
      if (x < r.w2) {
        const float ce = t2[2 * x], co = t2[2 * x + 1];
        nu = odd ? 255.f - co : 255.f - ce;
        nv = odd ? 255.f - ce : 255.f - co;
      }
      u[x] = nu;
      v[x] = nv;
    }
  }
  __syncthreads();
  float* t = r.y;
  r.y = r.t1;
  r.t1 = t;
}

// load_planes (without the blend) on the rows held: row k at py + k*w and
// pu, pv + k*w2; u and v only when pu is given.
__device__ void load_rows(Row& r, const uint8_t* py, const uint8_t* pu,
                          const uint8_t* pv) {
  for (int k = 0; k < r.n; ++k) {
    const uint8_t* yk = py + k * r.w;
    float* y = r.y + k * r.wp;
    for (int x = threadIdx.x; x < r.wp; x += BLOCK)
      y[x] = x < r.w ? (float)yk[x] : 0.f;
  }
  if (pu != nullptr) {
    for (int k = 0; k < r.n; ++k) {
      const uint8_t* uk = pu + k * r.w2;
      const uint8_t* vk = pv + k * r.w2;
      float* u = r.u + k * r.wp2;
      float* v = r.v + k * r.wp2;
      for (int x = threadIdx.x; x < r.wp2; x += BLOCK) {
        u[x] = x < r.w2 ? (float)uk[x] : 0.f;
        v[x] = x < r.w2 ? (float)vk[x] : 0.f;
      }
    }
  }
  __syncthreads();
}

// store_planes on the rows held (row k at oy + k*w and ou, ov + k*w2); u
// and v only when ou is given.
__device__ void store_rows(const Row& r, uint8_t* oy, uint8_t* ou,
                           uint8_t* ov) {
  for (int k = 0; k < r.n; ++k) {
    const float* y = r.y + k * r.wp;
    for (int x = threadIdx.x; x < r.w; x += BLOCK)
      oy[k * r.w + x] = (uint8_t)y[x];
    if (ou == nullptr) continue;
    const float* u = r.u + k * r.wp2;
    const float* v = r.v + k * r.wp2;
    for (int x = threadIdx.x; x < r.w2; x += BLOCK) {
      ou[k * r.w2 + x] = (uint8_t)u[x];
      ov[k * r.w2 + x] = (uint8_t)v[x];
    }
  }
}

// A row's inputs of _a_math: subcarrier phase, luma noise stream, line in
// its field.
struct ARow {
  int xi;
  uint32_t key;
  int line;
};

// a_row on the rows held, row k's inputs args_of(k) (an ARow); the luma
// noise walk of all rows in one add_walk_rows call.
template <class ArgsOf>
__device__ void a_rows(Row& r, const Tables& tab, const Params& P,
                       ArgsOf args_of) {
  const int w = r.w, wp = r.wp;
  if (P.in_lowpass) {
    chroma_lowpass_full_rows(r, r.u, tab[TAB_U_HP], tab[TAB_U], 2);
    chroma_lowpass_full_rows(r, r.v, tab[TAB_V_HP], tab[TAB_V], P.v_delay);
  }
  qam_encode_rows(r, [=](int k) { return args_of(k).xi; }, P.amp);
  if (P.preemph) {
    pole_rows(r.y, r.t1, tab[TAB_PRE], 16.f, r.n, r.nb, r.red);
    for (int x = threadIdx.x; x < r.n * wp; x += BLOCK)
      r.y[x] = u8f(r.y[x] + (r.y[x] - r.t1[x]) * P.pre_gain);
    __syncthreads();
  }
  if (P.video_noise) {
    const auto stream = [=](int k) {
      const ARow a = args_of(k);
      return WalkRow{a.key, a.line};
    };
    add_walk_rows(r.y, r.t1, r.red, tab[TAB_WALK], stream, r.n,
                  P.video_noise, 0u, w, wp, true);
  }
  for (int k = 0; k < r.n; ++k)
    for (int x = threadIdx.x + w; x < wp; x += BLOCK) r.y[k * wp + x] = 0.f;
  __syncthreads();
}

// A row's inputs of _b_front: subcarrier phase, chroma noise stream, line
// in its field, chroma phase-noise sin and cos.
struct B1Row {
  int xi;
  uint32_t key;
  int line;
  float sa, ca;
};

// b1_row on the rows held, row k's inputs args_of(k) (a B1Row); the two
// chroma noise walks of all rows in one add_walk_rows call each.
template <class ArgsOf>
__device__ void b1_rows(Row& r, const Tables& tab, const Params& P,
                        ArgsOf args_of) {
  const int w = r.w, wp = r.wp, w2 = r.w2, wp2 = r.wp2;
  qam_decode_rows(r, [=](int k) { return args_of(k).xi; }, P.amp_back);
  if (P.chroma_noise) {
    const auto stream = [=](int k) {
      const B1Row a = args_of(k);
      return WalkRow{a.key, a.line};
    };
    add_walk_rows(r.u, r.tc, r.red, tab[TAB_WALK], stream, r.n,
                  P.chroma_noise, 0u, w2, wp2, true);
    add_walk_rows(r.v, r.tc, r.red, tab[TAB_WALK], stream, r.n,
                  P.chroma_noise, (uint32_t)P.l * (uint32_t)w2, w2, wp2,
                  true);
  }
  if (P.phase_noise) {
    // the gen-1 rotation bug: u' = u cos - u sin, v' = v cos + v sin
    for (int k = 0; k < r.n; ++k) {
      const B1Row a = args_of(k);
      const float sa = a.sa, ca = a.ca;
      float* u = r.u + k * wp2;
      float* v = r.v + k * wp2;
      for (int x = threadIdx.x; x < wp2; x += BLOCK) {
        const float uu = u[x] - 128.f, vv = v[x] - 128.f;
        u[x] = x < w2 ? u8f(uu * ca - uu * sa + 128.f) : 0.f;
        v[x] = x < w2 ? u8f(vv * ca + vv * sa + 128.f) : 0.f;
      }
    }
    __syncthreads();
  }
  if (P.vhs) {
    // luma: 3 lowpasses, then emphasis against a 4th same-cut pole
    pole3_rows(r.y, r.t1, tab[TAB_VLUMA], 16.f, r.n, r.nb, r.red);
    pole_rows(r.t1, r.t2, tab[TAB_VLUMA], 16.f, r.n, r.nb, r.red);
    for (int k = 0; k < r.n; ++k) {
      float* y = r.y + k * wp;
      const float* s1 = r.t1 + k * wp;
      const float* s2 = r.t2 + k * wp;
      for (int x = threadIdx.x; x < wp; x += BLOCK) {
        const float t = s1[x];
        y[x] = x < w ? u8f(t + (t - s2[x]) * 1.6f) : 0.f;
      }
    }
    __syncthreads();
    chroma_lowpass3_rows(r, r.u, tab[TAB_VCHROMA], P.chroma_delay);
    chroma_lowpass3_rows(r, r.v, tab[TAB_VCHROMA], P.chroma_delay);
  }
}

// A row's inputs of _b_back: subcarrier phase, chroma dropout keep.
struct B2Row {
  int xi;
  float keep;
};

// b2_row on the rows held, row k's inputs args_of(k) (a B2Row).
template <class ArgsOf>
__device__ void b2_rows(Row& r, const Tables& tab, const Params& P,
                        ArgsOf args_of) {
  const int w = r.w, wp = r.wp, w2 = r.w2, wp2 = r.wp2;
  const auto xi_of = [=](int k) { return args_of(k).xi; };
  if (P.vhs) {
    pole3_rows(r.y, r.t1, tab[TAB_SHARP_Y], 16.f, r.n, r.nb, r.red);
    for (int k = 0; k < r.n; ++k) {
      float* y = r.y + k * wp;
      const float* s1 = r.t1 + k * wp;
      for (int x = threadIdx.x; x < wp; x += BLOCK) {
        const float yv = y[x];
        y[x] = x < w ? u8f(yv + (yv - s1[x]) * P.sharpen_gain) : 0.f;
      }
    }
    __syncthreads();
    float* planes[2] = {r.u, r.v};
    for (float* p : planes) {
      pole3_rows(p, r.tc, tab[TAB_SHARP_C], 128.f, r.n, r.nb2, r.red);
      for (int k = 0; k < r.n; ++k) {
        float* pk = p + k * wp2;
        const float* tk = r.tc + k * wp2;
        for (int x = threadIdx.x; x < wp2; x += BLOCK) {
          const float pv2 = pk[x];
          pk[x] = x < w2 ? u8f(pv2 + (pv2 - tk[x]) * P.sharpen_chroma_gain)
                         : 0.f;
        }
      }
      __syncthreads();
    }
    if (!P.svideo) {
      qam_encode_rows(r, xi_of, P.amp);
      qam_decode_rows(r, xi_of, P.amp);
    }
  }
  if (P.chroma_loss) {
    for (int k = 0; k < r.n; ++k) {
      const float keep = args_of(k).keep;
      float* u = r.u + k * wp2;
      float* v = r.v + k * wp2;
      for (int x = threadIdx.x; x < wp2; x += BLOCK) {
        u[x] = x < w2 ? u[x] * keep + 128.f * (1.f - keep) : 0.f;
        v[x] = x < w2 ? v[x] * keep + 128.f * (1.f - keep) : 0.f;
      }
    }
    __syncthreads();
  }
  for (int n = 0; n < P.yc_recombine; ++n) {
    qam_encode_rows(r, xi_of, P.amp);
    qam_decode_rows(r, xi_of, P.amp);
  }
  if (P.out_lowpass == 2) {
    chroma_lowpass_full_rows(r, r.u, tab[TAB_U_HP], tab[TAB_U], 2);
    chroma_lowpass_full_rows(r, r.v, tab[TAB_V_HP], tab[TAB_V], P.v_delay);
  } else if (P.out_lowpass == 1) {
    chroma_lowpass3_rows(r, r.u, tab[TAB_LITE], 1);
    chroma_lowpass3_rows(r, r.v, tab[TAB_LITE], 1);
  }
}

}  // namespace gen1

using gen1::Params;
using gen1::Row;

// ---- kernel #5: the whole chain in two launches (split at the blend)

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_front(const uint8_t* __restrict__ y_in, const uint8_t* __restrict__ u_in,
          const uint8_t* __restrict__ v_in, const int* __restrict__ xi_tab,
          const uint32_t* __restrict__ keys, const float* __restrict__ sincos,
          const int* __restrict__ shifts, Tables tab, Params P,
          uint8_t* __restrict__ y_out, uint8_t* __restrict__ u_out,
          uint8_t* __restrict__ v_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  const int row = blockIdx.x;           // field * L + line
  const int fld = row / P.l, line = row % P.l;
  Row r = row_planes(sm, P);
  const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
  const int xi = xi_tab[row];
  load_planes(r, y_in + o1, u_in + o2, v_in + o2, false, line);
  a_row(r, tab, P, xi, keys[2 * fld], line);
  head_switch_row(r, shifts[row]);
  b1_row(r, tab, P, xi, keys[2 * fld + 1], line, sincos[2 * row],
         sincos[2 * row + 1]);
  store_planes(r, y_out + o1, u_out + o2, v_out + o2);
}

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_back(const uint8_t* __restrict__ y_in, const uint8_t* __restrict__ u_in,
         const uint8_t* __restrict__ v_in, const int* __restrict__ xi_tab,
         const float* __restrict__ keep, Tables tab, Params P,
         uint8_t* __restrict__ y_out, uint8_t* __restrict__ u_out,
         uint8_t* __restrict__ v_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  const int row = blockIdx.x;
  const int line = row % P.l;
  Row r = row_planes(sm, P);
  const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
  // the blend reads the front output of the line above (line 0 kept)
  load_planes(r, y_in + o1, u_in + o2, v_in + o2, P.vblend && line > 0, line);
  b2_row(r, tab, P, xi_tab[row], keep[row]);
  store_planes(r, y_out + o1, u_out + o2, v_out + o2);
}

// ---- kernels #6-#8: the TPU's split program (A, B1, B2) with the head
// switch and the blend run between them by the caller. The planes between
// launches are uint8 at the active widths: every value at those seams is
// clamped to [0, 255] or is the floor of a mean of such values.

// #6, #7 and #8 take R = rows_per_cta consecutive rows a CTA (the last
// CTA may hold fewer). ROWS false: one (field, line) row a CTA (R == 1),
// through the one-row functions #5 runs; true: the R rows together,
// through the multi-row functions.
template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_a(const uint8_t* __restrict__ y_in, const uint8_t* __restrict__ u_in,
      const uint8_t* __restrict__ v_in, const int* __restrict__ xi_tab,
      const uint32_t* __restrict__ keys, Tables tab, Params P,
      int rows_per_cta, uint8_t* __restrict__ y_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  if constexpr (!ROWS) {
    const int row = blockIdx.x;
    const int fld = row / P.l, line = row % P.l;
    Row r = row_planes(sm, P);
    const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
    load_planes(r, y_in + o1, u_in + o2, v_in + o2, false, line);
    a_row(r, tab, P, xi_tab[row], keys[2 * fld], line);
    store_planes(r, y_out + o1, nullptr, nullptr);
  } else {
    const int row0 = blockIdx.x * rows_per_cta;  // field * L + line
    Row r = row_planes(sm, P, rows_per_cta,
                       min(rows_per_cta, P.b * P.l - row0));
    const size_t o1 = (size_t)row0 * r.w, o2 = (size_t)row0 * r.w2;
    load_rows(r, y_in + o1, u_in + o2, v_in + o2);
    a_rows(r, tab, P, [=, l = P.l](int k) {
      const int row = row0 + k;
      return ARow{xi_tab[row], keys[2 * (row / l)], row % l};
    });
    store_rows(r, y_out + o1, nullptr, nullptr);
  }
}

template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_b1(const uint8_t* __restrict__ y_in, const int* __restrict__ xi_tab,
       const uint32_t* __restrict__ keys, const float* __restrict__ sincos,
       Tables tab, Params P, int rows_per_cta, uint8_t* __restrict__ y_out,
       uint8_t* __restrict__ u_out, uint8_t* __restrict__ v_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  if constexpr (!ROWS) {
    const int row = blockIdx.x;
    const int fld = row / P.l, line = row % P.l;
    Row r = row_planes(sm, P);
    const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
    load_planes(r, y_in + o1, nullptr, nullptr, false, line);
    b1_row(r, tab, P, xi_tab[row], keys[2 * fld + 1], line, sincos[2 * row],
           sincos[2 * row + 1]);
    store_planes(r, y_out + o1, u_out + o2, v_out + o2);
  } else {
    const int row0 = blockIdx.x * rows_per_cta;  // field * L + line
    Row r = row_planes(sm, P, rows_per_cta,
                       min(rows_per_cta, P.b * P.l - row0));
    const size_t o1 = (size_t)row0 * r.w, o2 = (size_t)row0 * r.w2;
    load_rows(r, y_in + o1, nullptr, nullptr);
    b1_rows(r, tab, P, [=, l = P.l](int k) {
      const int row = row0 + k, fld = row / l;
      return B1Row{xi_tab[row], keys[2 * fld + 1], row % l, sincos[2 * row],
                   sincos[2 * row + 1]};
    });
    store_rows(r, y_out + o1, u_out + o2, v_out + o2);
  }
}

template <bool ROWS>
__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_b2(const uint8_t* __restrict__ y_in, const uint8_t* __restrict__ u_in,
       const uint8_t* __restrict__ v_in, const int* __restrict__ xi_tab,
       const float* __restrict__ keep, Tables tab, Params P, int rows_per_cta,
       uint8_t* __restrict__ y_out, uint8_t* __restrict__ u_out,
       uint8_t* __restrict__ v_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  if constexpr (!ROWS) {
    const int row = blockIdx.x;
    const int line = row % P.l;
    Row r = row_planes(sm, P);
    const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
    load_planes(r, y_in + o1, u_in + o2, v_in + o2, false, line);
    b2_row(r, tab, P, xi_tab[row], keep[row]);
    store_planes(r, y_out + o1, u_out + o2, v_out + o2);
  } else {
    const int row0 = blockIdx.x * rows_per_cta;
    Row r = row_planes(sm, P, rows_per_cta,
                       min(rows_per_cta, P.b * P.l - row0));
    const size_t o1 = (size_t)row0 * r.w, o2 = (size_t)row0 * r.w2;
    load_rows(r, y_in + o1, u_in + o2, v_in + o2);
    b2_rows(r, tab, P, [=](int k) {
      return B2Row{xi_tab[row0 + k], keep[row0 + k]};
    });
    store_rows(r, y_out + o1, u_out + o2, v_out + o2);
  }
}

namespace gen1 {

// The launch shape shared by every gen-1 kernel: one CTA of BLOCK threads
// per `rows` (field, row) rows, their planes in dynamic shared memory.
// Returns 0, or the error the C entry points return for arguments the
// kernels do not take.
template <typename K>
int prepare_launch(const Params& P, K kernel, size_t* smem, int rows = 1) {
  if (P.wp % BLOCK != 0 || P.wp2 % BLOCK != 0 || P.w > P.wp || P.w < 3 ||
      P.w2 > P.wp2 || P.w2 < 1 || 2 * P.w2 > P.w || P.b < 0 || P.l < 1 ||
      rows < 1 || rows > ROUND)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)(rows * row_floats(P) + RED_FLOATS) * sizeof(float);
  if (*smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
}

// Rows a CTA of #6, #7 and #8 at padded widths wp (luma) and wp2 (chroma)
// on the current device: pole.cuh's rows_per_cta_of for a row of
// row_floats(P) floats whose pole calls run at both widths, a round of
// each counted alike (under the bench configuration #6 runs one luma and
// four chroma pole calls a row, #7 two and four, #8 one and six; weighing
// by those counts picks the same R on an H100). There (228 KB an SM, 1 KB a CTA): 4 rows
// at 576i and 480i (wp 768, wp2 384: 54 KB of rows; luma 24 blocks in 2
// rounds, chroma 12 in 1), 1 at 1080i (wp 1920, wp2 1024: 34.5 KB a row).
int rows_per_cta(int wp, int wp2) {
  return cvsim::rows_per_cta_of(LUMA_PLANES * wp + CHROMA_PLANES * wp2,
                                wp / BLOCK, wp2 / BLOCK);
}

Tables tables(const void* tt, const void* d, const void* tt3, const void* d3,
              const void* vt) {
  return Tables{static_cast<const float*>(tt), static_cast<const float*>(d),
                static_cast<const float*>(tt3), static_cast<const float*>(d3),
                static_cast<const float*>(vt)};
}

}  // namespace gen1
}  // namespace cvsim

// C entry points (bound with ctypes by cvsim_tpu_torch/kernels.py). Each
// launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() (0 on success). Planes are uint8 [B, L, W]
// (luma) and [B, L, W/2] (chroma), contiguous.

// Kernel #5. scratch: 3 uint8 planes, b*l*(w + 2*w2) bytes.
extern "C" int cvsim_yuv_chain(const void* y, const void* u, const void* v,
                               const void* xi, const void* keys,
                               const void* sincos, const void* keep,
                               const void* shifts, const void* tt,
                               const void* d, const void* tt3, const void* d3,
                               const void* vt, void* scratch, void* y_out,
                               void* u_out, void* v_out, const void* params,
                               void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  size_t smem = 0;
  int err = gen1::prepare_launch(P, yuv_front, &smem);
  if (err == 0) err = gen1::prepare_launch(P, yuv_back, &smem);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const Tables tab = gen1::tables(tt, d, tt3, d3, vt);
  uint8_t* sy = static_cast<uint8_t*>(scratch);
  uint8_t* su = sy + (size_t)rows * P.w;
  uint8_t* sv = su + (size_t)rows * P.w2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  yuv_front<<<rows, BLOCK, smem, s>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), static_cast<const float*>(sincos),
      static_cast<const int*>(shifts), tab, P, sy, su, sv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  yuv_back<<<rows, BLOCK, smem, s>>>(
      sy, su, sv, static_cast<const int*>(xi), static_cast<const float*>(keep),
      tab, P, static_cast<uint8_t*>(y_out), static_cast<uint8_t*>(u_out),
      static_cast<uint8_t*>(v_out));
  return (int)cudaGetLastError();
}

// The rows a CTA of cvsim_yuv_a, cvsim_yuv_b1 and cvsim_yuv_b2 at padded
// widths wp (luma) and wp2 (chroma) on the current device.
extern "C" int cvsim_yuv_a_rows_per_cta(int wp, int wp2) {
  return cvsim::gen1::rows_per_cta(wp, wp2);
}

extern "C" int cvsim_yuv_b1_rows_per_cta(int wp, int wp2) {
  return cvsim::gen1::rows_per_cta(wp, wp2);
}

extern "C" int cvsim_yuv_b2_rows_per_cta(int wp, int wp2) {
  return cvsim::gen1::rows_per_cta(wp, wp2);
}

// Kernel #6 (A): y, u, v -> the encoded luma y_out, before the head switch,
// cvsim_yuv_a_rows_per_cta(wp, wp2) rows a CTA.
extern "C" int cvsim_yuv_a(const void* y, const void* u, const void* v,
                           const void* xi, const void* keys, const void* tt,
                           const void* d, const void* tt3, const void* d3,
                           const void* vt, void* y_out, const void* params,
                           void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  const int R = gen1::rows_per_cta(P.wp, P.wp2);
  const auto kernel = R == 1 ? yuv_a<false> : yuv_a<true>;
  size_t smem = 0;
  const int err = gen1::prepare_launch(P, kernel, &smem, R);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const int ctas = (rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), gen1::tables(tt, d, tt3, d3, vt), P,
      R, static_cast<uint8_t*>(y_out));
  return (int)cudaGetLastError();
}

// Kernel #7 (B1): the head-switched luma -> y, u, v before the blend,
// cvsim_yuv_b1_rows_per_cta(wp, wp2) rows a CTA.
extern "C" int cvsim_yuv_b1(const void* y, const void* xi, const void* keys,
                            const void* sincos, const void* tt, const void* d,
                            const void* tt3, const void* d3, const void* vt,
                            void* y_out, void* u_out, void* v_out,
                            const void* params, void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  const int R = gen1::rows_per_cta(P.wp, P.wp2);
  const auto kernel = R == 1 ? yuv_b1<false> : yuv_b1<true>;
  size_t smem = 0;
  const int err = gen1::prepare_launch(P, kernel, &smem, R);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const int ctas = (rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), static_cast<const float*>(sincos),
      gen1::tables(tt, d, tt3, d3, vt), P, R, static_cast<uint8_t*>(y_out),
      static_cast<uint8_t*>(u_out), static_cast<uint8_t*>(v_out));
  return (int)cudaGetLastError();
}

// Kernel #8 (B2): the blended y, u, v -> the chain's output,
// cvsim_yuv_b2_rows_per_cta(wp, wp2) rows a CTA.
extern "C" int cvsim_yuv_b2(const void* y, const void* u, const void* v,
                            const void* xi, const void* keep, const void* tt,
                            const void* d, const void* tt3, const void* d3,
                            const void* vt, void* y_out, void* u_out,
                            void* v_out, const void* params, void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  const int R = gen1::rows_per_cta(P.wp, P.wp2);
  const auto kernel = R == 1 ? yuv_b2<false> : yuv_b2<true>;
  size_t smem = 0;
  const int err = gen1::prepare_launch(P, kernel, &smem, R);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  const int ctas = (rows + R - 1) / R;
  kernel<<<ctas, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<const int*>(xi),
      static_cast<const float*>(keep), gen1::tables(tt, d, tt3, d3, vt), P, R,
      static_cast<uint8_t*>(y_out), static_cast<uint8_t*>(u_out),
      static_cast<uint8_t*>(v_out));
  return (int)cudaGetLastError();
}
