"""The port's container-ingest copy (cvsim_tpu_torch/native/avio.cpp):
`VDecoder::planeize`, which turns each decoded frame into the planes the
tool loops read, on frames made by libavutil; and `frameblend_time`, the
frameblend loop's time of each source frame, against Python's exact
`float(Fraction(...))`.

A GRAY8 frame gets full-resolution neutral chroma (128). The JAX
package's copy refills it only when the buffer size changes, so a GRAY8
frame after a YUV444P frame of the same size kept that frame's chroma;
the port's copy refills it after any frame that was not GRAY8. Only the
kept-chroma path (.y4m inputs of the tool loops) reaches this, and a Y4M
stream fixes its colour space in its header, so no container here can
switch formats mid-stream: the test drives planeize directly, through a
small program compiled together with avio.cpp. Skips without g++ or the
libav* development files.

The JAX package's frameblend loop takes float(src_idx * out_rate / fps)
with exact Fractions (cvsim_tpu/cli/tools.py:688), and its native copy
divides int64 products in double, exact only while they stay below 2^53
(it gates the output rate, not the input's). The port's copy divides the
exact products and rounds once, ties to even.
"""

import random
from fractions import Fraction

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

// frame-time: frameblend_time of each line "src_idx or_num or_den fps_num
// fps_den" of stdin, printed as a hex float. Else planeize each (format,
// value) frame of 16x8 in turn (every plane filled with the value),
// printing the mean of its U and V planes.
int main(int argc, char** argv) {
  if (argc == 2 && std::string(argv[1]) == "frame-time") {
    long long v[5];
    while (scanf("%lld %lld %lld %lld %lld", &v[0], &v[1], &v[2], &v[3],
                 &v[4]) == 5)
      printf("%a\n", frameblend_time(v[0], v[1], v[2], v[3], v[4]));
    return 0;
  }
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
def program(tmp_path_factory):
    """PROGRAM built with avio.cpp."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("avio")
    src = d / "avio_program.cpp"
    src.write_text(PROGRAM)
    exe = str(d / "avio_program")
    res = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-I", NATIVE, str(src),
         os.path.join(NATIVE, "hostpix.cpp"), "-o", exe, "-lavformat",
         "-lavcodec", "-lavutil", "-lswscale", "-lswresample"],
        capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"cannot build against libav*: {res.stderr[-300:]}")
    return exe


@pytest.fixture(scope="module")
def planeize(program):
    exe = program

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


@pytest.fixture(scope="module")
def frame_time(program):
    def run(cases):
        text = "".join(" ".join(map(str, c)) + "\n" for c in cases)
        out = subprocess.run([program, "frame-time"], input=text,
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout
        return [float.fromhex(v) for v in out.split()]

    return run


def _exact(src_idx, or_num, or_den, fps_num, fps_den):
    """The JAX loop's frame time: float(src_idx * out_rate / fps)."""
    return float(src_idx * Fraction(or_num, or_den) / Fraction(fps_num,
                                                               fps_den))


I64 = 2**63 - 1
I32 = 2**31 - 1
FRAME_TIME_CASES = {
    # src_idx * or_num * fps_den above 2^53 (where the old double division
    # rounded the product before dividing), and above 2^63 (where the int64
    # product wrapped)
    "above 2^53": [(2**40 + 7, 60000, 1001, 30000, 1001),
                   (123456789, 60000, 1001, 24000, 1001),
                   (2**33 + 1, 2**20 + 3, 3, 7, 2**20 + 1),
                   (10**9 + 7, 999983, 999979, 1000003, 999961)],
    "above 2^63": [(2**62, 60000, 1001, 30000, 1001),
                   (I64, I64, 1, 1, I32),
                   (I64, I64, I64, I32, I32),
                   (-I64 - 1, -I64 - 1, 3, -(2**31), I32),
                   (2**50 + 3, 2**40 + 5, 2**45 + 9, 97, 2**31 - 3)],
    # the 60000/1001 output rate over input rates with large denominators
    "ntsc over large denominators": [
        (k, 60000, 1001, 2997000, 100000) for k in (1, 2, 3, 1001, 99999,
                                                    2**31 + 11, 2**40 + 3)
    ] + [(k, 60000, 1001, 2997002997, 100000000) for k in (7, 10**6, 2**37)]
      + [(k, 60000, 1001, 1000000007, 33366667) for k in (5, 2**45)],
    # quotients exactly halfway between two doubles: ties to even, both ways
    "halfway": [(2**53 + 1, 1, 1, 1, 1), (2**53 + 3, 1, 1, 1, 1),
                (2 * (2**52 + 5) + 1, 1, 2, 1, 1),
                (2 * (2**52 + 6) + 1, 1, 1, 2, 1),
                (3 * (2**54 + 1), 5, 3, 5, 1),
                (2**60 + 2**7, 1, 1, 1, 1), (2**60 + 3 * 2**7, 1, 1, 1, 1),
                (-(2**53 + 1), 1, 1, 1, 1), (2**53 + 1, 1, 1, 1, -2)],
    "small and exact": [(0, 60000, 1001, 30000, 1001),
                        (0, -5, 3, 7, -11), (1, 1, 1, 1, 1),
                        (10, 60000, 1001, 30000, 1001), (5, 50, 1, 25, 1)],
}


@pytest.mark.parametrize("kind", sorted(FRAME_TIME_CASES))
def test_frame_time_is_the_correctly_rounded_fraction(frame_time, kind):
    cases = FRAME_TIME_CASES[kind]
    got = frame_time(cases)
    want = [_exact(*c) for c in cases]
    assert got == want, [c for c, g, w in zip(cases, got, want) if g != w]


@pytest.mark.parametrize("bits", [31, 53, 63])
def test_frame_time_on_random_draws(frame_time, bits):
    """Random int64 draws of up to `bits` bits (signs too, int32 input
    rates), against float(Fraction(...))."""
    rng = random.Random(bits)

    def draw(b):
        v = rng.getrandbits(rng.randint(1, b))
        return -v if rng.random() < 0.1 else v

    cases = []
    while len(cases) < 2000:
        c = (draw(bits), draw(bits), draw(bits), draw(31), draw(31))
        if c[2] != 0 and c[3] != 0 and c[4] != 0:
            cases.append(c)
    got = frame_time(cases)
    want = [_exact(*c) for c in cases]
    assert got == want, [c for c, g, w in zip(cases, got, want) if g != w][:5]
