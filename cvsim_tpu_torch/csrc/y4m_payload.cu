// The gen-2 render's Y4M frame payloads on the card: y4m_payload, one
// launch a GOP, from the chain's uint8 RGB fields [b, l, w, 3] to uint8
// [b, frame_bytes], each row the bytes that follow a frame's "FRAME\n"
// (host/payload.py payloads_np is its plain version):
// - Y, h x w: the bobbed frame, frame row r reading field row r >> 1;
// - U, then V, ch x cw with cw = ceil(w / 2): the frame's even columns,
//   of its even rows at 4:2:0 (ch = ceil(h / 2): chroma row c is field
//   row c) or of every row at 4:2:2 (ch = h).
// Each pixel is csrc/yuv601.cuh's rgb_to_yuv601_np, bit for bit.
//
// Replaces no TPU kernel: the JAX package bobs and converts each field in
// numpy on the host (cvsim_tpu/host/pipeline_yiq.py's _emit), some 290 ms
// of host time a GOP at 720x480. What bounds it is bytes: at
// 720x480 4:2:0 a GOP of 64 fields reads 33.2 MB of RGB and writes 33.2 MB
// of payload, and the float32 arithmetic is some 30 operations a pixel.
// So it is a plain elementwise kernel: a thread takes two horizontally
// adjacent pixels of one field row (one chroma column), reads their 6
// bytes, converts both (of the pixel at the odd column only Y is kept)
// and writes each result to every place the layout puts it: two Y rows
// (the bob), one or two chroma rows. Neighbouring threads take
// neighbouring columns, so a warp's loads and each of its plane stores are
// contiguous. No shared memory, no barrier.

#include <cuda_runtime.h>

#include <cstdint>

#include "yuv601.cuh"

namespace cvsim {
namespace payload {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
y4m_payload(const uint8_t* __restrict__ rgb, uint8_t* __restrict__ out,
            int b, int l, int w, int h, int is422) {
  // a field's threads fill whole CTAs of their own, so that the indices
  // are 32-bit (the last CTA of a field may hold fewer)
  const int cw = (w + 1) / 2, rows = (h + 1) / 2;   // field rows read
  const int ch = is422 ? h : rows;
  const int per_field = rows * cw;
  const int ctas = (per_field + THREADS - 1) / THREADS;   // a field's
  const int f = blockIdx.x / ctas;
  const int j = (blockIdx.x - f * ctas) * THREADS + threadIdx.x;
  if (j >= per_field) return;
  const int s = j / cw, c = j - s * cw;
  const int x = 2 * c, r0 = 2 * s, r1 = 2 * s + 1;   // r0 < h always
  const long long y_bytes = (long long)h * w, c_bytes = (long long)ch * cw;
  uint8_t* const Y = out + f * (y_bytes + 2 * c_bytes);
  uint8_t* const U = Y + y_bytes;
  uint8_t* const V = U + c_bytes;
  const uint8_t* const p = rgb + (((long long)f * l + s) * w + x) * 3;

  const yuv601::Yuv e = yuv601::yuv_of(p[0], p[1], p[2]);
  Y[(long long)r0 * w + x] = e.y;
  if (r1 < h) Y[(long long)r1 * w + x] = e.y;
  if (x + 1 < w) {
    const uint8_t y1 = yuv601::yuv_of(p[3], p[4], p[5]).y;
    Y[(long long)r0 * w + x + 1] = y1;
    if (r1 < h) Y[(long long)r1 * w + x + 1] = y1;
  }
  if (is422) {
    U[(long long)r0 * cw + c] = e.u;
    V[(long long)r0 * cw + c] = e.v;
    if (r1 < h) {
      U[(long long)r1 * cw + c] = e.u;
      V[(long long)r1 * cw + c] = e.v;
    }
  } else {
    U[(long long)s * cw + c] = e.u;
    V[(long long)s * cw + c] = e.v;
  }
}

}  // namespace payload
}  // namespace cvsim

// C entry point (bound with ctypes by cvsim_tpu_torch/kernels.py).
// rgb: uint8 [b, l, w, 3]; out: uint8 [b, h * w + 2 * ch * ceil(w / 2)],
// ch = h at 4:2:2 (is422 != 0), ceil(h / 2) at 4:2:0; both contiguous; h
// at most 2 * l. A thread per chroma column of a read field row. Launches
// on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for sizes
// out of range.
extern "C" int cvsim_y4m_payload(const void* rgb, void* out, int b, int l,
                                 int w, int h, int is422, void* stream) {
  using namespace cvsim::payload;
  if (b < 0 || l < 1 || w < 1 || h < 1 || h > 2LL * l)
    return (int)cudaErrorInvalidValue;
  const long long per_field = (long long)((h + 1) / 2) * ((w + 1) / 2);
  const long long ctas = (long long)b * ((per_field + THREADS - 1) / THREADS);
  if (per_field > 0x7fffffffLL || ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (ctas == 0) return 0;
  y4m_payload<<<(unsigned)ctas, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<uint8_t*>(out), b, l, w,
      h, is422);
  return (int)cudaGetLastError();
}
