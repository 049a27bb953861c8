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
// the row on chip, four rows an SM.

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

// Shared-memory working set of one row.
struct Row {
  float *y, *t1, *t2;  // luma and two luma temporaries: wp each
  float *u, *v, *tc;   // chroma and one chroma temporary: wp2 each
  float* red;          // RED_FLOATS floats: the poles' block carries
  int w, wp, nb, w2, wp2, nb2;
};

__device__ Row row_planes(float* sm, const Params& P) {
  Row r;
  r.y = sm;
  r.t1 = sm + P.wp;
  r.t2 = sm + 2 * P.wp;
  r.u = sm + 3 * P.wp;
  r.v = r.u + P.wp2;
  r.tc = r.v + P.wp2;
  r.red = r.tc + P.wp2;
  r.w = P.w;
  r.wp = P.wp;
  r.nb = P.wp / BLOCK;
  r.w2 = P.w2;
  r.wp2 = P.wp2;
  r.nb2 = P.wp2 / BLOCK;
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

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_a(const uint8_t* __restrict__ y_in, const uint8_t* __restrict__ u_in,
      const uint8_t* __restrict__ v_in, const int* __restrict__ xi_tab,
      const uint32_t* __restrict__ keys, Tables tab, Params P,
      uint8_t* __restrict__ y_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  const int row = blockIdx.x;
  const int fld = row / P.l, line = row % P.l;
  Row r = row_planes(sm, P);
  const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
  load_planes(r, y_in + o1, u_in + o2, v_in + o2, false, line);
  a_row(r, tab, P, xi_tab[row], keys[2 * fld], line);
  store_planes(r, y_out + o1, nullptr, nullptr);
}

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_b1(const uint8_t* __restrict__ y_in, const int* __restrict__ xi_tab,
       const uint32_t* __restrict__ keys, const float* __restrict__ sincos,
       Tables tab, Params P, uint8_t* __restrict__ y_out,
       uint8_t* __restrict__ u_out, uint8_t* __restrict__ v_out) {
  using namespace gen1;
  extern __shared__ float sm[];
  const int row = blockIdx.x;
  const int fld = row / P.l, line = row % P.l;
  Row r = row_planes(sm, P);
  const size_t o1 = (size_t)row * r.w, o2 = (size_t)row * r.w2;
  load_planes(r, y_in + o1, nullptr, nullptr, false, line);
  b1_row(r, tab, P, xi_tab[row], keys[2 * fld + 1], line, sincos[2 * row],
         sincos[2 * row + 1]);
  store_planes(r, y_out + o1, u_out + o2, v_out + o2);
}

__global__ void __launch_bounds__(BLOCK, MIN_CTAS)
yuv_b2(const uint8_t* __restrict__ y_in, const uint8_t* __restrict__ u_in,
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
  load_planes(r, y_in + o1, u_in + o2, v_in + o2, false, line);
  b2_row(r, tab, P, xi_tab[row], keep[row]);
  store_planes(r, y_out + o1, u_out + o2, v_out + o2);
}

namespace gen1 {

// The launch shape shared by every gen-1 kernel: one CTA of BLOCK threads
// per (field, row), the row's planes in dynamic shared memory. Returns 0,
// or the error the C entry points return for arguments the kernels do not
// take.
template <typename K>
int prepare_launch(const Params& P, K kernel, size_t* smem) {
  if (P.wp % BLOCK != 0 || P.wp2 % BLOCK != 0 || P.w > P.wp || P.w < 3 ||
      P.w2 > P.wp2 || P.w2 < 1 || 2 * P.w2 > P.w || P.b < 0 || P.l < 1)
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)(3 * P.wp + 3 * P.wp2 + RED_FLOATS) * sizeof(float);
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

// Kernel #6 (A): y, u, v -> the encoded luma y_out, before the head switch.
extern "C" int cvsim_yuv_a(const void* y, const void* u, const void* v,
                           const void* xi, const void* keys, const void* tt,
                           const void* d, const void* tt3, const void* d3,
                           const void* vt, void* y_out, const void* params,
                           void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  size_t smem = 0;
  const int err = gen1::prepare_launch(P, yuv_a, &smem);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  yuv_a<<<rows, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), gen1::tables(tt, d, tt3, d3, vt), P,
      static_cast<uint8_t*>(y_out));
  return (int)cudaGetLastError();
}

// Kernel #7 (B1): the head-switched luma -> y, u, v before the blend.
extern "C" int cvsim_yuv_b1(const void* y, const void* xi, const void* keys,
                            const void* sincos, const void* tt, const void* d,
                            const void* tt3, const void* d3, const void* vt,
                            void* y_out, void* u_out, void* v_out,
                            const void* params, void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  size_t smem = 0;
  const int err = gen1::prepare_launch(P, yuv_b1, &smem);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  yuv_b1<<<rows, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const int*>(xi),
      static_cast<const uint32_t*>(keys), static_cast<const float*>(sincos),
      gen1::tables(tt, d, tt3, d3, vt), P, static_cast<uint8_t*>(y_out),
      static_cast<uint8_t*>(u_out), static_cast<uint8_t*>(v_out));
  return (int)cudaGetLastError();
}

// Kernel #8 (B2): the blended y, u, v -> the chain's output.
extern "C" int cvsim_yuv_b2(const void* y, const void* u, const void* v,
                            const void* xi, const void* keep, const void* tt,
                            const void* d, const void* tt3, const void* d3,
                            const void* vt, void* y_out, void* u_out,
                            void* v_out, const void* params, void* stream) {
  using namespace cvsim;
  const Params P = *static_cast<const Params*>(params);
  size_t smem = 0;
  const int err = gen1::prepare_launch(P, yuv_b2, &smem);
  if (err != 0) return err;
  const int rows = P.b * P.l;
  if (rows == 0) return 0;
  yuv_b2<<<rows, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<const int*>(xi),
      static_cast<const float*>(keep), gen1::tables(tt, d, tt3, d3, vt), P,
      static_cast<uint8_t*>(y_out), static_cast<uint8_t*>(u_out),
      static_cast<uint8_t*>(v_out));
  return (int)cudaGetLastError();
}
