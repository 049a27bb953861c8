// A CPU model of csrc/pole.cuh and csrc/noise.cuh: the CUDA primitives
// compiled with g++ under a shim (one std::thread per CUDA thread of a
// 128-thread CTA, __syncthreads/__syncwarp as std::barrier, __ldg a load,
// float4 a struct), so that the multi-row forms can be held against the
// one-row forms bit for bit without a GPU.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -fno-strict-aliasing -pthread \
//       -I cvsim_tpu_torch/csrc tests/pole_model.cpp -o pole_model
//   ./pole_model FORM W R ROWS SEED   FORM: pole, pole3, walk or walk8
//   ./pole_model rows PLANES WP...
//   ./pole_model gen1 WP WP2 [WP WP2 ...]
//   ./pole_model yuv DIR a|b1|b2 R OUT   (built with -DGEN1_KERNELS)
//   ./pole_model yiq DIR a|b1|b2 R OUT   (built with -DGEN2_KERNELS)
//   ./pole_model streams DIR OUT         (built with -DSTREAMS_KERNEL)
//   ./pole_model payload DIR B L W H IS422 OUT  (built with -DPAYLOAD_KERNEL)
//   ./pole_model yuv601 OUT              (built with -DPAYLOAD_KERNEL)
//
// ROWS rows of W samples (random values, a random reset value each) go
// through the one-row form row by row, and through the multi-row form R
// rows a CTA (the last CTA may hold fewer). For pole and pole3 each row is
// also computed by a plain sequential loop with the primitives' operation
// order. walk is the noise walk of gen-2 (add_walk, add_walk_rows), walk8
// the u8-masked walk of gen-1 (sums clamped to 0..255, zero past W). Prints
// "ok" and exits 0 when all are bit-identical; else prints the first
// mismatch and exits 1. `rows` prints, for each padded width WP, the rows a
// CTA that pole.cuh's rows_per_cta_of gives rows of PLANES planes on an H100
// SM (228 KB of shared memory, 1 KB kept a CTA); `gen1` prints, for each
// pair of padded luma and chroma widths, the rows a CTA of the gen-1
// kernels #7 and #8 (yuv_chain.cu's gen1::rows_per_cta: a row of 3 luma
// and 3 chroma planes, its pole calls at both widths). Built with
// -DGEN1_KERNELS beside a copy of csrc/yuv_chain.cu (see run_yuv), `yuv`
// runs kernel #6, #7 or #8 whole through its C entry point; built with
// -DGEN2_KERNELS beside a copy of csrc/yiq_chain.cu (see run_yiq), `yiq`
// runs kernel #2, #3 or #4. Built with -DSTREAMS_KERNEL beside a copy of
// csrc/streams.cu, `streams` runs the per-line inputs' kernel
// (cvsim_field_streams) whole. Built with -DPAYLOAD_KERNEL beside a copy of
// csrc/y4m_payload.cu, `payload` runs the Y4M payloads' kernel
// (cvsim_y4m_payload) whole, and `yuv601` writes csrc/yuv601.cuh's Y, U
// and V of every RGB triple. tests/test_torch_pole_model.py,
// tests/test_torch_streams.py and tests/test_torch_y4m_payload.py run it.

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <initializer_list>
#include <random>
#include <string>
#include <thread>
#include <vector>

// ---- the shim
struct ThreadIndex {
  unsigned x;
};
thread_local ThreadIndex threadIdx;
struct float4 {
  float x, y, z, w;
};
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
template <class T>
T __ldg(const T* p) {
  return *p;
}
using std::max;
using std::min;
static std::barrier<>* g_cta;
static std::barrier<>* g_warps[4];
inline void __syncthreads() { g_cta->arrive_and_wait(); }
inline void __syncwarp() { g_warps[threadIdx.x / 32]->arrive_and_wait(); }

#if defined(GEN1_KERNELS) || defined(GEN2_KERNELS) || \
    defined(STREAMS_KERNEL) || defined(PAYLOAD_KERNEL)
#define WHOLE_KERNELS
#endif

#ifdef WHOLE_KERNELS
// what csrc/yuv_chain.cu, csrc/yiq_chain.cu and pole.cuh's device-side
// choice of rows a CTA take from the CUDA compiler and runtime: an SM of
// an H100 (228 KB of shared memory, 1 KB kept a CTA), launches that never
// fail
#define __CUDACC__ 1
#define __global__
#define __launch_bounds__(...)
#define __host__
#define __shared__
thread_local ThreadIndex blockIdx;
// float32 operations rounded once each (built with -ffp-contract=off)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr {
  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
  cudaDevAttrReservedSharedMemoryPerBlock
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? 228 * 1024 : 1024;
  return cudaSuccess;
}
#endif

#include "noise.cuh"

using namespace cvsim;

// Runs body on the 128 threads of one CTA.
static void run_cta(const std::function<void()>& body) {
  std::barrier<> cta(BLOCK);
  std::barrier<> w0(32), w1(32), w2(32), w3(32);
  g_cta = &cta;
  g_warps[0] = &w0;
  g_warps[1] = &w1;
  g_warps[2] = &w2;
  g_warps[3] = &w3;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < BLOCK; ++t)
    threads.emplace_back([t, &body] {
      threadIdx.x = t;
      body();
    });
  for (auto& th : threads) th.join();
}

#ifdef WHOLE_KERNELS
// ---- whole kernels: yuv_chain_cpu.cu (yiq_chain_cpu.cu) is
// csrc/yuv_chain.cu (csrc/yiq_chain.cu) with each
// `kernel<<<ctas, ...>>>(args)` rewritten as cvsim_launch(ctas, [&] {
// kernel(args); }) (tests/test_torch_pole_model.py), so that its C entry
// points run here, CTA after CTA.
int cvsim_rows_per_cta_override = 0;
namespace cvsim {
alignas(16) float sm[1 << 18];   // the dynamic shared memory of a CTA
}
template <class F>
static void cvsim_launch(int ctas, F body) {
  for (int c = 0; c < ctas; ++c)
    run_cta([&] {
      blockIdx.x = (unsigned)c;
      body();
    });
}
#ifdef GEN1_KERNELS
#include "yuv_chain_cpu.cu"
#elif defined(GEN2_KERNELS)
#include "yiq_chain_cpu.cu"
#elif defined(STREAMS_KERNEL)
#include "streams_cpu.cu"
#else
#include "y4m_payload_cpu.cu"
static_assert(cvsim::payload::THREADS == BLOCK, "a CTA runs BLOCK threads");
#endif

static std::vector<char> read_file(const std::string& dir, const char* name) {
  FILE* f = std::fopen((dir + "/" + name).c_str(), "rb");
  std::vector<char> v;
  if (!f) return v;
  char buf[1 << 16];
  for (size_t n; (n = std::fread(buf, 1, sizeof buf, f)) > 0;)
    v.insert(v.end(), buf, buf + n);
  std::fclose(f);
  return v;
}

static int write_out(const char* path,
                     std::initializer_list<const std::vector<char>*> bufs) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  for (const auto* b : bufs) std::fwrite(b->data(), 1, b->size(), f);
  std::fclose(f);
  return 0;
}

#ifdef GEN1_KERNELS
// `yuv DIR a|b1|b2 R OUT`: kernel #6 (a), #7 (b1) or #8 (b2) through its C
// entry point at R rows a CTA (0: its own choice) on the inputs in DIR
// (raw files params, y, u, v, xi, keys, sincos, keep, tt, d, tt3, d3,
// vt); writes the y bytes (a) or the y, u and v bytes (b1, b2) to OUT.
static int run_yuv(int argc, char** argv) {
  if (argc != 6) return 2;
  const std::string dir = argv[2], kernel = argv[3];
  cvsim_rows_per_cta_override = std::atoi(argv[4]);
  const auto in = [&](const char* n) { return read_file(dir, n); };
  const auto P = in("params"), y = in("y"), u = in("u"), v = in("v");
  const auto xi = in("xi"), keys = in("keys"), sc = in("sincos");
  const auto keep = in("keep"), tt = in("tt"), d = in("d"), tt3 = in("tt3");
  const auto d3 = in("d3"), vt = in("vt");
  std::vector<char> yo(y.size()), uo(u.size()), vo(v.size());
  int rc = 0;
  if (kernel == "a")
    rc = cvsim_yuv_a(y.data(), u.data(), v.data(), xi.data(), keys.data(),
                     tt.data(), d.data(), tt3.data(), d3.data(), vt.data(),
                     yo.data(), P.data(), nullptr);
  else if (kernel == "b1")
    rc = cvsim_yuv_b1(y.data(), xi.data(), keys.data(), sc.data(), tt.data(),
                      d.data(), tt3.data(), d3.data(), vt.data(), yo.data(),
                      uo.data(), vo.data(), P.data(), nullptr);
  else
    rc = cvsim_yuv_b2(y.data(), u.data(), v.data(), xi.data(), keep.data(),
                      tt.data(), d.data(), tt3.data(), d3.data(), vt.data(),
                      yo.data(), uo.data(), vo.data(), P.data(), nullptr);
  if (rc != 0) {
    std::printf("launch error %d\n", rc);
    return 1;
  }
  if (kernel == "a") return write_out(argv[5], {&yo});
  return write_out(argv[5], {&yo, &uo, &vo});
}
#elif defined(GEN2_KERNELS)
// `yiq DIR a|b1|b2 R OUT`: kernel #2 (a), #3 (b1) or #4 (b2) through its C
// entry point at R rows a CTA (0: its own choice) on the inputs in DIR
// (raw files params, rgb, y, i, q, xi, keys, sincos, keep, tt, d, tt3, d3,
// vt; a kernel reads only its own); writes the float32 luma plane
// [b, l, wp] (a), the float32 y, i and q planes (b1) or the uint8 RGB
// [b, l, w, 3] (b2) to OUT.
static int run_yiq(int argc, char** argv) {
  if (argc != 6) return 2;
  const std::string dir = argv[2], kernel = argv[3];
  cvsim_rows_per_cta_override = std::atoi(argv[4]);
  const auto in = [&](const char* n) { return read_file(dir, n); };
  const auto P = in("params"), rgb = in("rgb"), y = in("y"), i = in("i");
  const auto q = in("q"), xi = in("xi"), keys = in("keys");
  const auto sc = in("sincos"), keep = in("keep"), tt = in("tt");
  const auto d = in("d"), tt3 = in("tt3"), d3 = in("d3"), vt = in("vt");
  if (P.size() != sizeof(ChainParams)) return 2;
  ChainParams cp;
  std::memcpy(&cp, P.data(), sizeof cp);
  const size_t plane = (size_t)cp.b * cp.l * cp.wp * sizeof(float);
  std::vector<char> yo(plane), io(plane), qo(plane);
  std::vector<char> rgbo((size_t)cp.b * cp.l * cp.w * 3);
  int rc = 0;
  if (kernel == "a")
    rc = cvsim_yiq_a(rgb.data(), xi.data(), keys.data(), tt.data(), d.data(),
                     tt3.data(), d3.data(), vt.data(), yo.data(), P.data(),
                     nullptr);
  else if (kernel == "b1")
    rc = cvsim_yiq_b1(y.data(), xi.data(), keys.data(), sc.data(), tt.data(),
                      d.data(), tt3.data(), d3.data(), vt.data(), yo.data(),
                      io.data(), qo.data(), P.data(), nullptr);
  else
    rc = cvsim_yiq_b2(y.data(), i.data(), q.data(), xi.data(), keep.data(),
                      tt.data(), d.data(), tt3.data(), d3.data(), vt.data(),
                      rgbo.data(), P.data(), nullptr);
  if (rc != 0) {
    std::printf("launch error %d\n", rc);
    return 1;
  }
  if (kernel == "a") return write_out(argv[5], {&yo});
  if (kernel == "b1") return write_out(argv[5], {&yo, &io, &qo});
  return write_out(argv[5], {&rgbo});
}
#endif
#ifdef STREAMS_KERNEL
// `streams DIR OUT`: cvsim_field_streams on the inputs in DIR (raw files
// params, fieldno, parity, table); writes xi, keys_ab, sincos, keep and
// shifts one after another to OUT.
static int run_streams(int argc, char** argv) {
  if (argc != 4) return 2;
  const std::string dir = argv[2];
  const auto in = [&](const char* n) { return read_file(dir, n); };
  const auto P = in("params"), fn = in("fieldno"), par = in("parity");
  const auto table = in("table");
  using cvsim::streams::StreamsParams;
  if (P.size() != sizeof(StreamsParams)) return 2;
  StreamsParams sp;
  std::memcpy(&sp, P.data(), sizeof sp);
  const size_t lines = (size_t)sp.b * sp.l;
  std::vector<char> xi(lines * 4), keys((size_t)sp.b * 16), sc(lines * 8);
  std::vector<char> keep(lines * 4), shifts(lines * 4);
  const int rc = cvsim_field_streams(
      fn.data(), par.data(), table.data(), xi.data(), keys.data(), sc.data(),
      keep.data(), shifts.data(), P.data(), nullptr);
  if (rc != 0) {
    std::printf("launch error %d\n", rc);
    return 1;
  }
  return write_out(argv[3], {&xi, &keys, &sc, &keep, &shifts});
}
#endif
#ifdef PAYLOAD_KERNEL
// `payload DIR B L W H IS422 OUT`: cvsim_y4m_payload on the uint8 RGB
// fields [B, L, W, 3] in DIR/rgb at a frame height H; writes the payloads
// [B, frame bytes] to OUT.
static int run_payload(int argc, char** argv) {
  if (argc != 9) return 2;
  const auto rgb = read_file(argv[2], "rgb");
  const int b = std::atoi(argv[3]), l = std::atoi(argv[4]);
  const int w = std::atoi(argv[5]), h = std::atoi(argv[6]);
  const int is422 = std::atoi(argv[7]);
  if (rgb.size() != (size_t)b * l * w * 3) return 2;
  const size_t ch = is422 ? h : (h + 1) / 2, cw = (w + 1) / 2;
  std::vector<char> out((size_t)b * ((size_t)h * w + 2 * ch * cw));
  const int rc = cvsim_y4m_payload(rgb.data(), out.data(), b, l, w, h, is422,
                                   nullptr);
  if (rc != 0) {
    std::printf("launch error %d\n", rc);
    return 1;
  }
  return write_out(argv[8], {&out});
}

// `yuv601 OUT`: Y, U and V of every RGB triple, each plane 2^24 bytes,
// triple (r << 16) | (g << 8) | b at its index.
static int run_yuv601(int argc, char** argv) {
  if (argc != 3) return 2;
  const size_t n = 1u << 24;
  std::vector<char> y(n), u(n), v(n);
  for (size_t i = 0; i < n; ++i) {
    const auto e = cvsim::yuv601::yuv_of((float)(i >> 16),
                                         (float)((i >> 8) & 255),
                                         (float)(i & 255));
    y[i] = (char)e.y;
    u[i] = (char)e.u;
    v[i] = (char)e.v;
  }
  return write_out(argv[2], {&y, &u, &v});
}
#endif
#endif

// ---- the tables of one pole (the layouts of pole.cuh's PoleTables),
// computed in double and cast once
struct Tabs {
  std::vector<float> tt, d, tt3, d3, vt;
  PoleTables p() const {
    return {tt.data(), d.data(), tt3.data(), d3.data(), vt.data()};
  }
};

static Tabs make_tables(double a) {
  const int n = BLOCK;
  std::vector<double> T(n * n, 0.0), T2(n * n, 0.0), T3(n * n, 0.0), d(n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) T[i * n + j] = a * std::pow(1 - a, i - j);
    d[i] = std::pow(1 - a, i + 1);
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      for (int k = 0; k < n; ++k) T2[i * n + j] += T[i * n + k] * T[k * n + j];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      for (int k = 0; k < n; ++k) T3[i * n + j] += T2[i * n + k] * T[k * n + j];
  Tabs t;
  t.tt.resize(n * n);
  t.tt3.resize(n * n);
  t.d.resize(n);
  t.d3.assign(8 * n, 0.f);
  t.vt.assign(n * 8, 0.f);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      t.tt[j * n + i] = (float)T[i * n + j];
      t.tt3[j * n + i] = (float)T3[i * n + j];
    }
    t.d[i] = (float)d[i];
    double t2d = 0.0, td = 0.0;
    for (int k = 0; k < n; ++k) {
      t2d += T2[i * n + k] * d[k];
      td += T[i * n + k] * d[k];
    }
    t.d3[i] = (float)t2d;
    t.d3[n + i] = (float)td;
    t.vt[i * 8] = (float)T[(n - 1) * n + i];
    t.vt[i * 8 + 1] = (float)T2[(n - 1) * n + i];
  }
  return t;
}

// ---- the plain sequential form: each block's product with j ascending,
// then the carry terms left to right, then the carry chain
static void plain_pole(const float* x, float* y, const Tabs& t, float y0,
                       int nb, bool three) {
  const int n = BLOCK;
  float c1 = y0, c2 = y0, c3 = y0;
  const float dl = t.d[n - 1], s1 = t.d3[n - 1], s2 = t.d3[2 * n - 1];
  const float* tab = three ? t.tt3.data() : t.tt.data();
  for (int q = 0; q < nb; ++q) {
    const float* xb = x + q * n;
    float acc[BLOCK];
    for (int i = 0; i < n; ++i) {
      float a = 0.f;
      for (int j = 0; j <= i; ++j) a = fmaf(xb[j], tab[j * n + i], a);
      acc[i] = a;
    }
    if (!three) {
      for (int i = 0; i < n; ++i) y[q * n + i] = acc[i] + t.d[i] * c1;
      c1 = acc[n - 1] + dl * c1;
      continue;
    }
    float u1 = 0.f, u2 = 0.f;
    for (int j = 0; j < n; ++j) {
      u1 = fmaf(xb[j], t.vt[j * 8], u1);
      u2 = fmaf(xb[j], t.vt[j * 8 + 1], u2);
    }
    for (int i = 0; i < n; ++i)
      y[q * n + i] = acc[i] + t.d3[i] * c1 + t.d3[n + i] * c2 + t.d[i] * c3;
    const float n1 = u1 + dl * c1, n2 = u2 + s2 * c1 + dl * c2;
    const float n3 = acc[n - 1] + s1 * c1 + s2 * c2 + dl * c3;
    c1 = n1;
    c2 = n2;
    c3 = n3;
  }
}

static int first_diff(const std::vector<float>& a, const std::vector<float>& b) {
  for (size_t i = 0; i < a.size(); ++i)
    if (std::memcmp(&a[i], &b[i], sizeof(float)) != 0) return (int)i;
  return -1;
}

int main(int argc, char** argv) {
#ifdef GEN1_KERNELS
  if (argc >= 2 && std::string(argv[1]) == "yuv") return run_yuv(argc, argv);
#endif
#ifdef GEN2_KERNELS
  if (argc >= 2 && std::string(argv[1]) == "yiq") return run_yiq(argc, argv);
#endif
#ifdef STREAMS_KERNEL
  if (argc >= 2 && std::string(argv[1]) == "streams")
    return run_streams(argc, argv);
#endif
#ifdef PAYLOAD_KERNEL
  if (argc >= 2 && std::string(argv[1]) == "payload")
    return run_payload(argc, argv);
  if (argc >= 2 && std::string(argv[1]) == "yuv601")
    return run_yuv601(argc, argv);
#endif
  if (argc >= 4 && std::string(argv[1]) == "gen1") {
    for (int k = 2; k + 1 < argc; k += 2) {
      const int wp = std::atoi(argv[k]), wp2 = std::atoi(argv[k + 1]);
      std::printf("%d\n", rows_per_cta_of(3 * wp + 3 * wp2, wp / BLOCK,
                                          wp2 / BLOCK, 228 * 1024, 1024));
    }
    return 0;
  }
  if (argc >= 3 && std::string(argv[1]) == "rows") {
    for (int k = 3; k < argc; ++k) {
      const int wp = std::atoi(argv[k]), planes = std::atoi(argv[2]);
      std::printf("%d\n", rows_per_cta_of(planes * wp, wp / BLOCK, 0,
                                          228 * 1024, 1024));
    }
    return 0;
  }
  if (argc != 6) {
    std::fprintf(stderr, "usage: pole_model FORM W R ROWS SEED\n");
    return 2;
  }
  const std::string form = argv[1];
  const int w = std::atoi(argv[2]), R = std::atoi(argv[3]);
  const int rows = std::atoi(argv[4]);
  std::mt19937 rng(std::atoi(argv[5]));
  const int wp = (w + BLOCK - 1) / BLOCK * BLOCK, nb = wp / BLOCK;
  const bool masked = form == "walk8";
  const bool walk = form == "walk" || masked, three = form == "pole3";
  if (!walk && !three && form != "pole") return 2;

  std::uniform_real_distribution<float> val(0.f, 256.f);
  std::uniform_real_distribution<double> alpha(0.05, 0.6);
  const Tabs tabs = make_tables(walk ? 0.5 : alpha(rng));
  const PoleTables p = tabs.p();
  // rows of w values, zero past w (as the kernels pad them), a reset
  // value, stream and row index each
  std::vector<float> x((size_t)rows * wp, 0.f), y0(rows);
  std::vector<WalkRow> streams(rows);
  for (int r = 0; r < rows; ++r) {
    for (int i = 0; i < w; ++i)
      x[(size_t)r * wp + i] = walk ? std::floor(val(rng)) : val(rng);
    y0[r] = std::floor(val(rng));
    streams[r] = {(uint32_t)rng(), (int)(rng() % 1000)};
  }
  const int mag = 22;
  const uint32_t plane_off = 240u * (uint32_t)w;

  std::vector<float> one(x.size()), multi(x.size()), plain(x.size());
  std::vector<float> buf((size_t)R * wp), tmp((size_t)R * wp), red(RED_FLOATS);
  run_cta([&] {
    const unsigned t = threadIdx.x;
    // the one-row form, row by row
    for (int r = 0; r < rows; ++r) {
      for (int i = t; i < wp; i += BLOCK) buf[i] = x[(size_t)r * wp + i];
      __syncthreads();
      if (walk)
        add_walk(buf.data(), tmp.data(), red.data(), p, streams[r].key,
                 streams[r].row, mag, plane_off, w, wp, masked);
      else if (three)
        pole3(buf.data(), buf.data(), p, y0[r], nb, red.data());
      else
        pole(buf.data(), buf.data(), p, y0[r], nb, red.data());
      for (int i = t; i < wp; i += BLOCK) one[(size_t)r * wp + i] = buf[i];
      __syncthreads();
    }
    // the multi-row form, R rows a CTA
    for (int r0 = 0; r0 < rows; r0 += R) {
      const int n = min(R, rows - r0);
      for (int i = t; i < n * wp; i += BLOCK) buf[i] = x[(size_t)r0 * wp + i];
      __syncthreads();
      if (walk)
        add_walk_rows(buf.data(), tmp.data(), red.data(), p,
                      [&](int k) { return streams[r0 + k]; }, n, mag,
                      plane_off, w, wp, masked);
      else if (three)
        pole3_rows(buf.data(), buf.data(), p, 0.f, n, nb, red.data(),
                   y0.data() + r0);
      else
        pole_rows(buf.data(), buf.data(), p, 0.f, n, nb, red.data(),
                  y0.data() + r0);
      for (int i = t; i < n * wp; i += BLOCK) multi[(size_t)r0 * wp + i] = buf[i];
      __syncthreads();
    }
  });

  int bad = first_diff(one, multi);
  if (bad >= 0) {
    std::printf("multi-row != one-row at row %d sample %d: %.9g vs %.9g\n",
                bad / wp, bad % wp, multi[bad], one[bad]);
    return 1;
  }
  if (!walk) {
    for (int r = 0; r < rows; ++r)
      plain_pole(x.data() + (size_t)r * wp, plain.data() + (size_t)r * wp,
                 tabs, y0[r], nb, three);
    bad = first_diff(one, plain);
    if (bad >= 0) {
      std::printf("one-row != plain at row %d sample %d: %.9g vs %.9g\n",
                  bad / wp, bad % wp, one[bad], plain[bad]);
      return 1;
    }
  }
  std::printf("ok %s w=%d R=%d rows=%d\n", form.c_str(), w, R, rows);
  return 0;
}
