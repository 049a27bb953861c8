"""The port's container-ingest copy (cvsim_tpu_torch/native/avio.cpp):
`VDecoder::planeize`, which turns each decoded frame into the planes the
tool loops read, on frames made by libavutil.

A GRAY8 frame gets full-resolution neutral chroma (128). The JAX
package's copy refills it only when the buffer size changes, so a GRAY8
frame after a YUV444P frame of the same size kept that frame's chroma;
the port's copy refills it after any frame that was not GRAY8. Only the
kept-chroma path (.y4m inputs of the tool loops) reaches this, and a Y4M
stream fixes its colour space in its header, so no container here can
switch formats mid-stream: the test drives planeize directly, through a
small program compiled together with avio.cpp. Skips without g++ or the
libav* development files.
"""

import os
import shutil
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                      "cvsim_tpu_torch", "native")

PROGRAM = r"""
#define main cvsim_av_main
#include "avio.cpp"
#undef main

// planeize each (format, value) frame of 16x8 in turn (every plane filled
// with the value), printing the mean of its U and V planes
int main(int argc, char** argv) {
  VDecoder d;
  d.keep_chroma = true;
  d.conv = av_frame_alloc();
  AVFrame* f = av_frame_alloc();
  for (int i = 1; i + 1 < argc; i += 2) {
    av_frame_unref(f);
    f->format = std::string(argv[i]) == "gray" ? AV_PIX_FMT_GRAY8
              : std::string(argv[i]) == "444" ? AV_PIX_FMT_YUV444P
                                              : AV_PIX_FMT_YUV420P;
    f->width = 16;
    f->height = 8;
    if (av_frame_get_buffer(f, 0) < 0) return 1;
    const int v = atoi(argv[i + 1]);
    for (int p = 0; p < 3 && f->data[p]; ++p)
      memset(f->data[p], v, (size_t)f->linesize[p] * f->height);
    PlaneView pv;
    d.planeize(f, &pv);
    double su = 0, sv = 0;
    for (long k = 0; k < pv.ch * pv.cw; ++k) {
      su += pv.u[k];
      sv += pv.v[k];
    }
    printf("%ldx%ld %g %g\n", pv.ch, pv.cw, su / (pv.ch * pv.cw),
           sv / (pv.ch * pv.cw));
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def planeize(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("avio")
    src = d / "planeize.cpp"
    src.write_text(PROGRAM)
    exe = str(d / "planeize")
    res = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-I", NATIVE, str(src),
         os.path.join(NATIVE, "hostpix.cpp"), "-o", exe, "-lavformat",
         "-lavcodec", "-lavutil", "-lswscale", "-lswresample"],
        capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"cannot build against libav*: {res.stderr[-300:]}")

    def run(*frames):
        args = [str(a) for fr in frames for a in fr]
        out = subprocess.run([exe, *args], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        return [line.split() for line in out.splitlines()]

    return run


@pytest.mark.parametrize("before", ["444", "420"])
def test_gray_frame_gets_neutral_chroma_after_colour_frame(planeize, before):
    """A GRAY8 frame after a colour frame (of the same chroma size for
    4:4:4, another for 4:2:0) and after another GRAY8 frame: chroma 128."""
    lines = planeize(("gray", 30), (before, 200), ("gray", 40), ("gray", 50))
    assert lines[0] == ["8x16", "128", "128"]
    assert lines[1][1:] == ["200", "200"]
    assert lines[2] == ["8x16", "128", "128"]
    assert lines[3] == ["8x16", "128", "128"]
