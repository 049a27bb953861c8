// Native host-pixel kernels for the restore / sibling tools' per-frame CLI
// loops (ffmpeg_vhsled.cpp:866-928, frameblend.cpp:1032-1081,
// filmac.cpp:886-1009, and the frame_copy_scale role of
// ffmpeg_ntsc.cpp:544-607).
//
// Each function is the BIT-EXACT twin of a numpy implementation
// (host/colorconv.py scale_frame_to_np / rgb_to_yuv601_np,
// models/tools_np.py) — same float32 operation order, round-half-to-even
// via rintf (numpy round), numpy floor-division semantics where the numpy
// twin uses `//` on possibly-negative int64.  tests/test_hostpix.py asserts
// element-for-element equality on random frames.  Compile WITHOUT
// -ffast-math and WITH -ffp-contract=off: FMA contraction would change the
// f32 results.
//
// Every kernel exists in two extern-C flavours sharing ONE templated
// implementation: the int32 interleaved-RGB forms (the ctypes API the
// Python fallback loops dlopen — numpy's int32 default) and uint8 forms
// used by the in-process cvsim-av tool loops.  All pixel values live in
// 0..255 at every kernel boundary (scale_frame clips, frameblend/filmac
// clip before store), so the two element types carry identical values —
// the u8 forms just move 4x fewer bytes per plane, which on the 1-CPU
// bench host is the difference between losing and beating the reference
// binaries' in-process loops (VERDICT r4 #2).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "../csrc/yuv601.cuh"

namespace {

inline int32_t clip_round_255(float x) {
  float r = rintf(x);                    // numpy round: half-to-even
  if (r < 0.0f) return 0;
  if (r > 255.0f) return 255;
  return (int32_t)r;
}

// The bilinear lerp a + (b - a) * f, rounded half to even and clamped to
// 0..255. The weights of an upscale's first samples are negative (the
// sample centres lie left of the source's first one, hscale_consts clips
// the index to 0 and keeps the weight), so the lerp extrapolates and can
// leave 0..255: the clamp keeps every value a pixel value, for the uint8
// forms (no wraparound) and for every consumer that indexes a 256-entry
// table with it. The numpy twin (colorconv.hscale_bilinear_np) clamps
// the same way.
inline int32_t lerp_255(float a, float b, float f) {
  int32_t r = (int32_t)rintf(a + (b - a) * f);
  return r < 0 ? 0 : (r > 255 ? 255 : r);
}

inline int64_t floordiv64(int64_t a, int64_t b) {
  // numpy // on int64 (b > 0 in every caller)
  int64_t q = a / b;
  if ((a % b) != 0 && ((a < 0) != (b < 0))) q--;
  return q;
}

// Grow-only per-thread scratch: a fresh malloc/free of the multi-MB frame
// temporaries per call returns the pages to the OS each time (mmap-backed)
// and re-faults them on the next frame — ~8 ms/frame of soft page faults
// in the CLI loops.
void *scratch(int slot, size_t bytes) {
  static thread_local void *bufs[4] = {nullptr, nullptr, nullptr, nullptr};
  static thread_local size_t caps[4] = {0, 0, 0, 0};
  if (caps[slot] < bytes) {
    free(bufs[slot]);
    bufs[slot] = malloc(bytes);
    caps[slot] = bytes;
  }
  return bufs[slot];
}

// ------------------------------------------------- yuv -> rgb + scale fused
// scale_frame_to_np: chroma upsample (repeat, or bilinear when the cu*/cv*
// constants are given — width lerp then height lerp with int32 rounding
// after each, chroma_up_bilinear_np), yuv_to_rgb601_np at source
// resolution, horizontal f32 lerp, vertical f32 lerp.  hx*/vx*/hf/vf are
// host/batching.hscale_consts arrays (passed in so the constants are the
// same float64->float32 values the numpy/jax paths use); has_h/has_v are 0
// for identity (src == dst) axes, matching hscale_consts returning None.
template <typename TO>
void scale_frame_impl(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                      long sh, long sw, long ch, long cw,
                      long dh, long dw,
                      const int64_t *hx0, const int64_t *hx1,
                      const float *hf, int has_h,
                      const int64_t *vx0, const int64_t *vx1,
                      const float *vf, int has_v,
                      TO *out,
                      // bilinear chroma upsample (cw->sw, ch->sh) consts;
                      // chroma_bilinear=0 -> repeat upsample
                      int chroma_bilinear = 0,
                      const int64_t *cux0 = nullptr,
                      const int64_t *cux1 = nullptr,
                      const float *cuf = nullptr, int has_cu = 0,
                      const int64_t *cvx0 = nullptr,
                      const int64_t *cvx1 = nullptr,
                      const float *cvf = nullptr, int has_cv = 0) {
  const float cy = (float)(255.0 / 219.0);
  const float crv = (float)(1.402 * (255.0 / 224.0));
  const float cgu = (float)(0.344136 * (255.0 / 224.0));
  const float cgv = (float)(0.714136 * (255.0 / 224.0));
  const float cbu = (float)(1.772 * (255.0 / 224.0));
  const long ky = sh / ch, kx = sw / cw;

  // bilinear chroma: width-upsample both planes once per frame (rounded
  // int32, bit-identical to hscale_bilinear_np), heights lerp per luma row
  int32_t *wup_u = nullptr, *wup_v = nullptr;
  if (chroma_bilinear) {
    wup_u = (int32_t *)scratch(3, (size_t)2 * ch * sw * sizeof(int32_t));
    wup_v = wup_u + (size_t)ch * sw;
    for (long r = 0; r < ch; r++) {
      const uint8_t *ur = u + r * cw, *vr = v + r * cw;
      int32_t *ou = wup_u + r * sw, *ov = wup_v + r * sw;
      if (has_cu) {
        for (long x = 0; x < sw; x++) {
          ou[x] = lerp_255((float)ur[cux0[x]], (float)ur[cux1[x]], cuf[x]);
          ov[x] = lerp_255((float)vr[cux0[x]], (float)vr[cux1[x]], cuf[x]);
        }
      } else {
        for (long x = 0; x < sw; x++) {
          ou[x] = ur[x];
          ov[x] = vr[x];
        }
      }
    }
  }

  // identity geometry writes straight into out; any resampled axis goes
  // through scratch
  TO *rgb = (!has_h && !has_v)
                ? out
                : (TO *)scratch(0, (size_t)sh * sw * 3 * sizeof(TO));
  float *urow = (float *)scratch(2, 2 * sw * sizeof(float));
  float *vrow = urow + sw;
  long prev_crow = -1;
  for (long r = 0; r < sh; r++) {
    const uint8_t *yr = y + r * sw;
    if (chroma_bilinear) {
      if (has_cv) {
        const int32_t *u0 = wup_u + cvx0[r] * sw, *u1 = wup_u + cvx1[r] * sw;
        const int32_t *v0 = wup_v + cvx0[r] * sw, *v1 = wup_v + cvx1[r] * sw;
        float f = cvf[r];
        for (long x = 0; x < sw; x++) {
          urow[x] = (float)lerp_255((float)u0[x], (float)u1[x], f) - 128.0f;
          vrow[x] = (float)lerp_255((float)v0[x], (float)v1[x], f) - 128.0f;
        }
      } else {
        const int32_t *u0 = wup_u + r * sw, *v0 = wup_v + r * sw;
        for (long x = 0; x < sw; x++) {
          urow[x] = (float)u0[x] - 128.0f;
          vrow[x] = (float)v0[x] - 128.0f;
        }
      }
    } else {
      long crow = r / ky;
      if (crow != prev_crow) {   // expand the chroma row once per ky rows
        const uint8_t *ur = u + crow * cw, *vr = v + crow * cw;
        for (long cx = 0; cx < cw; cx++) {
          float uf = (float)ur[cx] - 128.0f, vf_ = (float)vr[cx] - 128.0f;
          for (long j = 0; j < kx; j++) {
            urow[cx * kx + j] = uf;
            vrow[cx * kx + j] = vf_;
          }
        }
        prev_crow = crow;
      }
    }
    TO *o = rgb + r * sw * 3;
    for (long x = 0; x < sw; x++) {
      float yf = ((float)yr[x] - 16.0f) * cy;
      float uf = urow[x], vf_ = vrow[x];
      o[x * 3 + 0] = (TO)clip_round_255(yf + crv * vf_);
      o[x * 3 + 1] = (TO)clip_round_255((yf - cgu * uf) - cgv * vf_);
      o[x * 3 + 2] = (TO)clip_round_255(yf + cbu * uf);
    }
  }
  if (!has_h && !has_v) return;

  // horizontal pass: f32 lerp -> rint -> clamp to 0..255 (lerp_255), so
  // the value fits any element type
  TO *mid;
  if (has_h) {
    mid = has_v ? (TO *)scratch(1, (size_t)sh * dw * 3 * sizeof(TO))
                : out;
    for (long r = 0; r < sh; r++) {
      const TO *p = rgb + r * sw * 3;
      TO *o = mid + r * dw * 3;
      for (long x = 0; x < dw; x++) {
        const TO *s0 = p + hx0[x] * 3, *s1 = p + hx1[x] * 3;
        float f = hf[x];
        for (int c = 0; c < 3; c++)
          o[x * 3 + c] = (TO)lerp_255((float)s0[c], (float)s1[c], f);
      }
    }
  } else {
    mid = rgb;   // dw == sw
  }

  // vertical pass
  if (has_v) {
    for (long r = 0; r < dh; r++) {
      const TO *s0 = mid + vx0[r] * dw * 3;
      const TO *s1 = mid + vx1[r] * dw * 3;
      float f = vf[r];
      TO *o = out + r * dw * 3;
      for (long k = 0; k < dw * 3; k++)
        o[k] = (TO)lerp_255((float)s0[k], (float)s1[k], f);
    }
  }
}

// ------------------------------------------------------------- rgb -> yuv
// rgb_to_yuv601_np on an interleaved RGB frame; full-resolution uint8
// planes out (the caller subsamples chroma by slicing). Each pixel is
// csrc/yuv601.cuh's yuv_of, the conversion the card's y4m_payload runs.
template <typename TI>
void rgb_to_yuv_impl(const TI *rgb, long h, long w,
                     uint8_t *yo, uint8_t *uo, uint8_t *vo) {
  for (long i = 0; i < h * w; i++) {
    const cvsim::yuv601::Yuv e = cvsim::yuv601::yuv_of(
        (float)rgb[i * 3 + 0], (float)rgb[i * 3 + 1], (float)rgb[i * 3 + 2]);
    yo[i] = e.y;
    uo[i] = e.u;
    vo[i] = e.v;
  }
}

// Same math, but the chroma planes are computed ONLY at the retained
// subsample grid (420: u[0::2, 0::2]; 422: u[:, 0::2]) and all three
// planes write through caller strides — one pass straight into an AVFrame
// or Y4M buffer, identical bytes to rgb_to_yuv + slicing (the sliced
// positions' values are computed with the same per-pixel arithmetic).
template <typename TI>
void rgb_to_yuv_sub_impl(const TI *rgb, long h, long w, int is422,
                         uint8_t *yo, long ys,
                         uint8_t *uo, long us, uint8_t *vo, long vs) {
  using cvsim::yuv601::yuv_of;
  long ch = is422 ? h : h / 2, cw = w / 2;
  for (long r = 0; r < h; r++) {
    const TI *p = rgb + r * w * 3;
    uint8_t *yrow = yo + r * ys;
    for (long x = 0; x < w; x++)
      yrow[x] = yuv_of((float)p[x * 3 + 0], (float)p[x * 3 + 1],
                       (float)p[x * 3 + 2]).y;
  }
  for (long r = 0; r < ch; r++) {
    const TI *p = rgb + (size_t)(is422 ? r : 2 * r) * w * 3;
    uint8_t *urow = uo + r * us, *vrow = vo + r * vs;
    for (long c = 0; c < cw; c++) {
      const TI *px = p + 2 * c * 3;
      const cvsim::yuv601::Yuv e =
          yuv_of((float)px[0], (float)px[1], (float)px[2]);
      urow[c] = e.u;
      vrow[c] = e.v;
    }
  }
}

// ---------------------------------------------------------------- vhsled
// tools_np.vhsled_dejitter: per-row left-edge jitter estimate (first run
// of 9 consecutive "non-blackish vs the row's first-pixel blue" pixels,
// ffmpeg_vhsled.cpp:866-928 incl. the blue-channel quirk), 9-row 16.16
// smoothing for interior rows, then a per-row left roll that keeps the
// original tail.  rgb interleaved, in place on `out` (copy of in).
template <typename T>
void vhsled_dejitter_impl(const T *f, long h, long w, T *out) {
  int64_t *adj = (int64_t *)malloc(h * sizeof(int64_t));
  for (long r = 0; r < h; r++) {
    const T *row = f + r * w * 3;
    int32_t ref_blue = (int32_t)row[2];
    long start = -1;
    int run = 0;
    for (long x = 0; x < w; x++) {
      int nb = ((int32_t)row[x * 3 + 0] - ref_blue >= 16)
            || ((int32_t)row[x * 3 + 1] - ref_blue >= 16)
            || ((int32_t)row[x * 3 + 2] - ref_blue >= 16);
      if (nb) {
        if (++run == 9) { start = x - 8; break; }
      } else {
        run = 0;
      }
    }
    adj[r] = (start >= 0 ? start : w) << 16;
  }

  memcpy(out, f, (size_t)h * w * 3 * sizeof(T));
  for (long r = 0; r < h; r++) {
    int64_t a = adj[r];
    if (r >= 4 && r < h - 4) {
      int64_t s = 0;
      for (long k = -4; k <= 4; k++) s += adj[r + k];
      a = (s + 5) / 9;              // operands >= 0: trunc == floor
    }
    int64_t x = (a + 0x8000) >> 16;
    if (x < 0) x = 0;
    long shift = (x >= w / 2) ? 0 : (long)x;
    if (shift > 0)
      memmove(out + r * w * 3, f + (r * w + shift) * 3,
              (size_t)(w - shift) * 3 * sizeof(T));
  }
  free(adj);
}

// -------------------------------------------------------------- frameblend
// tools_np.frameblend_mix: int64 16.16 weighted sum of k frames, optional
// gamma LUTs (decode int64[256] -> 16.16-ish domain, encode int64[8193]
// -> 0..255).  Takes an array of per-frame pointers (no stacked copy) and
// accumulates frame-major so each pass streams one contiguous frame.
// Integer addition is exact, so the accumulator narrows to int32 whenever
// the worst-case sum fits (the common no-gamma, weights-sum-to-one case)
// — half the accumulator traffic, identical values.
template <typename TI, typename TA, typename TO>
void frameblend_accum(const TI **frames, long k, long n,
                      const int64_t *w16,
                      const int64_t *gdec, const int64_t *genc, TO *out) {
  TA *acc = (TA *)scratch(0, (size_t)n * sizeof(TA));
  for (long j = 0; j < k; j++) {
    const TI *f = frames[j];
    int64_t wj = w16[j];
    // fold the gamma decode into a per-frame weighted LUT: w*gdec[pv] is a
    // pure function of the 0..255 input value
    TA lut[256];
    if (gdec) {
      for (int pv = 0; pv < 256; pv++) lut[pv] = (TA)(wj * gdec[pv]);
    }
    if (j == 0) {
      if (gdec) for (long i = 0; i < n; i++) acc[i] = lut[f[i]];
      else      for (long i = 0; i < n; i++) acc[i] = (TA)(wj * f[i]);
    } else {
      if (gdec) for (long i = 0; i < n; i++) acc[i] += lut[f[i]];
      else      for (long i = 0; i < n; i++) acc[i] += (TA)(wj * f[i]);
    }
  }
  for (long i = 0; i < n; i++) {
    int64_t a = (int64_t)acc[i] >> 16;
    if (genc) {
      int64_t idx = a < 0 ? 0 : (a > 8192 ? 8192 : a);
      a = genc[idx];
    }
    out[i] = (TO)(a < 0 ? 0 : (a > 255 ? 255 : a));
  }
}

template <typename TI, typename TO>
void frameblend_mix_impl(const TI **frames, long k, long h, long w,
                         const int64_t *w16,
                         const int64_t *gdec, const int64_t *genc,
                         TO *out) {
  long n = h * w * 3;
  int64_t wsum = 0;
  for (long j = 0; j < k; j++) wsum += w16[j];
  // gdec[pv] = pow(pv/255,g)*8192 <= 8192, so the worst-case accumulator
  // magnitude is wsum * (gdec ? 8192 : 255)
  int64_t maxbase = gdec ? 8192 : 255;
  if (wsum * maxbase < 0x7FFF0000LL)
    frameblend_accum<TI, int32_t, TO>(frames, k, n, w16, gdec, genc, out);
  else
    frameblend_accum<TI, int64_t, TO>(frames, k, n, w16, gdec, genc, out);
}

// ------------------------------------------------------------------ filmac
// tools_np.filmac_measure: per-pixel channel min/max << 16 (after optional
// gamma decode), block-mean minima over 128x128 blocks of the [minx,maxx)
// band, max over the x-clipped band.  Returns minv/maxv via pointers.
// One pass: block sums accumulate inline (integer addition — the same
// values the numpy twin's pmin-array-then-block-sum produces).
template <typename TI>
void filmac_measure_impl(const TI *rgb, long h, long w,
                         const int64_t *gdec,
                         int64_t *minv_out, int64_t *maxv_out) {
  int64_t scaleto = gdec ? (int64_t)0x10000 * 8192 : (int64_t)0x10000 * 256;
  long minx = (w * 15) / 100, maxx = (w * 90) / 100;
  int64_t minv = scaleto * 6 / 10;
  int64_t maxv = scaleto * 4 / 10;
  const long bl = 128;
  long xe = minx + ((maxx - minx + bl - 1) / bl) * bl;
  if (xe > w) xe = w;
  // block grid: x0 = minx, minx+bl, ... < maxx; block x extent capped at w
  long nbx = 0;
  for (long x0 = minx; x0 < maxx; x0 += bl) nbx++;
  long bxe = minx + (nbx - 1) * bl + bl;   // end of the last block's span
  if (bxe > w) bxe = w;
  std::int64_t *bsum =
      (int64_t *)scratch(3, (size_t)(nbx > 0 ? nbx : 1) * sizeof(int64_t));

  for (long y0 = 0; y0 < h; y0 += bl) {
    long y1 = y0 + bl < h ? y0 + bl : h;
    for (long b = 0; b < nbx; b++) bsum[b] = 0;
    for (long yy = y0; yy < y1; yy++) {
      const TI *row = rgb + yy * w * 3;
      for (long x = minx; x < bxe; x++) {
        int64_t a = (int64_t)row[x * 3], b = (int64_t)row[x * 3 + 1],
                c = (int64_t)row[x * 3 + 2];
        if (gdec) { a = gdec[a]; b = gdec[b]; c = gdec[c]; }
        int64_t mn = a < b ? a : b; mn = mn < c ? mn : c;
        bsum[(x - minx) / bl] += mn << 16;
        if (x < xe) {
          int64_t mx = a > b ? a : b; mx = mx > c ? mx : c;
          int64_t pmax = mx << 16;
          if (pmax > maxv) maxv = pmax;
        }
      }
      // the max band [minx, xe) can extend past the block grid's end when
      // maxx rounds down: cover the tail columns
      for (long x = bxe; x < xe; x++) {
        int64_t a = (int64_t)row[x * 3], b = (int64_t)row[x * 3 + 1],
                c = (int64_t)row[x * 3 + 2];
        if (gdec) { a = gdec[a]; b = gdec[b]; c = gdec[c]; }
        int64_t mx = a > b ? a : b; mx = mx > c ? mx : c;
        int64_t pmax = mx << 16;
        if (pmax > maxv) maxv = pmax;
      }
    }
    for (long b = 0; b < nbx; b++) {
      long x0 = minx + b * bl;
      long x1 = x0 + bl < w ? x0 + bl : w;
      int64_t grd = (int64_t)(y1 - y0) * (x1 - x0);
      if (grd <= 0) continue;
      int64_t m = (bsum[b] + grd / 2) / grd;   // operands >= 0
      if (m < minv) minv = m;
    }
  }
  if (minv == maxv) maxv += 1;
  *minv_out = minv;
  *maxv_out = maxv;
}

// tools_np.filmac_rescale: (v<<16 - minv) * scaleto // span with numpy
// floor division (operand can be negative), clamp to int32, >>16, >=0,
// optional gamma encode, clip 0..255.
template <typename TI, typename TO>
void filmac_rescale_impl(const TI *rgb, long h, long w,
                         int64_t minv, int64_t maxv, int64_t scaleto,
                         const int64_t *gdec, const int64_t *genc,
                         TO *out) {
  int64_t span = maxv - minv;
  if (span < 1) span = 1;
  // LUT over the 256 (or 8193 post-gamma-decode) input values: the rescale
  // is per-value, so precompute instead of per-pixel 64-bit divides
  long nvals = 256;
  TO lut[256];
  for (long pv = 0; pv < nvals; pv++) {
    int64_t base = gdec ? gdec[pv] : pv;
    int64_t v = floordiv64(((base << 16) - minv) * scaleto, span);
    if (v < -0x7FFFFFFFLL) v = -0x7FFFFFFFLL;
    if (v > 0x7FFFFFFFLL) v = 0x7FFFFFFFLL;
    v >>= 16;
    if (v < 0) v = 0;
    if (genc) {
      int64_t idx = v > 8192 ? 8192 : v;
      v = genc[idx];
    }
    lut[pv] = (TO)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
  long n = h * w * 3;
  for (long i = 0; i < n; i++) out[i] = lut[rgb[i]];
}

}  // namespace

extern "C" {

// ------------------------- int32 forms: the ctypes API (numpy fallback)

void cvsim_scale_frame(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                       long sh, long sw, long ch, long cw,
                       long dh, long dw,
                       const int64_t *hx0, const int64_t *hx1,
                       const float *hf, int has_h,
                       const int64_t *vx0, const int64_t *vx1,
                       const float *vf, int has_v,
                       int32_t *out) {
  scale_frame_impl<int32_t>(y, u, v, sh, sw, ch, cw, dh, dw, hx0, hx1, hf,
                            has_h, vx0, vx1, vf, has_v, out);
}

// scale_frame with bilinear chroma upsample (the restore tools' ingest —
// colorconv.chroma_up_bilinear_np); cu*/cv* are hscale_consts(cw->sw),
// hscale_consts(ch->sh)
void cvsim_scale_frame_bc(const uint8_t *y, const uint8_t *u,
                          const uint8_t *v, long sh, long sw, long ch,
                          long cw, long dh, long dw,
                          const int64_t *hx0, const int64_t *hx1,
                          const float *hf, int has_h,
                          const int64_t *vx0, const int64_t *vx1,
                          const float *vf, int has_v,
                          const int64_t *cux0, const int64_t *cux1,
                          const float *cuf, int has_cu,
                          const int64_t *cvx0, const int64_t *cvx1,
                          const float *cvf, int has_cv,
                          int32_t *out) {
  scale_frame_impl<int32_t>(y, u, v, sh, sw, ch, cw, dh, dw, hx0, hx1, hf,
                            has_h, vx0, vx1, vf, has_v, out, 1, cux0, cux1,
                            cuf, has_cu, cvx0, cvx1, cvf, has_cv);
}

void cvsim_rgb_to_yuv(const int32_t *rgb, long h, long w,
                      uint8_t *yo, uint8_t *uo, uint8_t *vo) {
  rgb_to_yuv_impl<int32_t>(rgb, h, w, yo, uo, vo);
}

void cvsim_vhsled_dejitter(const int32_t *f, long h, long w, int32_t *out) {
  vhsled_dejitter_impl<int32_t>(f, h, w, out);
}

void cvsim_frameblend_mix(const int32_t **frames, long k, long h, long w,
                          const int64_t *w16,
                          const int64_t *gdec, const int64_t *genc,
                          int32_t *out) {
  frameblend_mix_impl<int32_t, int32_t>(frames, k, h, w, w16, gdec, genc,
                                        out);
}

void cvsim_filmac_measure(const int32_t *rgb, long h, long w,
                          const int64_t *gdec,
                          int64_t *minv_out, int64_t *maxv_out) {
  filmac_measure_impl<int32_t>(rgb, h, w, gdec, minv_out, maxv_out);
}

void cvsim_filmac_rescale(const int32_t *rgb, long h, long w,
                          int64_t minv, int64_t maxv, int64_t scaleto,
                          const int64_t *gdec, const int64_t *genc,
                          int32_t *out) {
  filmac_rescale_impl<int32_t, int32_t>(rgb, h, w, minv, maxv, scaleto,
                                        gdec, genc, out);
}

// ------------------------- uint8 forms: the in-process cvsim-av tool loops

void cvsim_scale_frame_u8(const uint8_t *y, const uint8_t *u,
                          const uint8_t *v, long sh, long sw, long ch,
                          long cw, long dh, long dw,
                          const int64_t *hx0, const int64_t *hx1,
                          const float *hf, int has_h,
                          const int64_t *vx0, const int64_t *vx1,
                          const float *vf, int has_v,
                          uint8_t *out) {
  scale_frame_impl<uint8_t>(y, u, v, sh, sw, ch, cw, dh, dw, hx0, hx1, hf,
                            has_h, vx0, vx1, vf, has_v, out);
}

void cvsim_scale_frame_bc_u8(const uint8_t *y, const uint8_t *u,
                             const uint8_t *v, long sh, long sw, long ch,
                             long cw, long dh, long dw,
                             const int64_t *hx0, const int64_t *hx1,
                             const float *hf, int has_h,
                             const int64_t *vx0, const int64_t *vx1,
                             const float *vf, int has_v,
                             const int64_t *cux0, const int64_t *cux1,
                             const float *cuf, int has_cu,
                             const int64_t *cvx0, const int64_t *cvx1,
                             const float *cvf, int has_cv,
                             uint8_t *out) {
  scale_frame_impl<uint8_t>(y, u, v, sh, sw, ch, cw, dh, dw, hx0, hx1, hf,
                            has_h, vx0, vx1, vf, has_v, out, 1, cux0, cux1,
                            cuf, has_cu, cvx0, cvx1, cvf, has_cv);
}

void cvsim_rgb_to_yuv_sub_u8(const uint8_t *rgb, long h, long w, int is422,
                             uint8_t *yo, long ys,
                             uint8_t *uo, long us,
                             uint8_t *vo, long vs) {
  rgb_to_yuv_sub_impl<uint8_t>(rgb, h, w, is422, yo, ys, uo, us, vo, vs);
}

void cvsim_vhsled_dejitter_u8(const uint8_t *f, long h, long w,
                              uint8_t *out) {
  vhsled_dejitter_impl<uint8_t>(f, h, w, out);
}

void cvsim_frameblend_mix_u8(const uint8_t **frames, long k, long h, long w,
                             const int64_t *w16,
                             const int64_t *gdec, const int64_t *genc,
                             uint8_t *out) {
  frameblend_mix_impl<uint8_t, uint8_t>(frames, k, h, w, w16, gdec, genc,
                                        out);
}

void cvsim_filmac_measure_u8(const uint8_t *rgb, long h, long w,
                             const int64_t *gdec,
                             int64_t *minv_out, int64_t *maxv_out) {
  filmac_measure_impl<uint8_t>(rgb, h, w, gdec, minv_out, maxv_out);
}

void cvsim_filmac_rescale_u8(const uint8_t *rgb, long h, long w,
                             int64_t minv, int64_t maxv, int64_t scaleto,
                             const int64_t *gdec, const int64_t *genc,
                             uint8_t *out) {
  filmac_rescale_impl<uint8_t, uint8_t>(rgb, h, w, minv, maxv, scaleto,
                                        gdec, genc, out);
}

}  // extern "C"
