"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (or more).

    python3 chip_smoke.py

Phases, each printing its own lines (any failure raises, exit code != 0):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the CUDA kernels from cvsim_tpu_torch/csrc with nvcc, and of
     the host C++ libraries (the frame scaler, raw28ntsc's DC tracker);
  3. each kernel vs its plain PyTorch version on the card, same prepared
     inputs: the gen-2 kernel (yiq_chain) for every gen-2 chain
     configuration of the port's tests at (2,32,128) and (1,16,176) and the
     bench's stochastic VHS-EP configuration at (8,240,704) and
     (2,540,1888); the gen-1 kernel (yuv_chain) for every gen-1 chain
     configuration at the same two small shapes and the gen-1 bench
     VHS-EP configuration at (8,240,720) NTSC, (8,288,720) PAL and
     (2,540,1888); the split gen-2 kernels (yiq_a, yiq_b1, yiq_b2) on row
     shards at row0 = 0 and row0 > 0 for every gen-2 configuration and for
     the bench configuration at 240x704 B=64 and 540x1888 B=16 cut into 4
     shards; the split gen-1 kernels (yuv_a, yuv_b1, yuv_b2) on every
     gen-1 configuration at the two small shapes and the bench
     configuration at 288x720 PAL B=64 and 540x1888 B=16, and the split
     route against yuv_chain on the same inputs; the pole cascade
     (fused_iir) in each of the stage path's shapes at [64*240, 720] and
     [16*540, 1888], and in the half-width chroma shapes at [64*240, 360]
     (testing.iir_cases); prepare() on the card == on the CPU for all;
     the per-line inputs' kernel (field_streams) against yiq.field_streams
     on the card, every output bit for bit (sin and cos as int32 bits), in
     both benchmark configurations at 64 fields of 240x720 and at 4096
     fields up to 2^31 - 1; the Y4M payloads' kernel (y4m_payload)
     against host/payload.payloads_np, every byte, on 64 random fields of
     240x720 bobbed to 480 lines at 4:2:0 and 4:2:2; the
     outputs of yiq_chain and yuv_chain on their bench cases byte-identical
     to b8c5917's kernels (CRC32s in testing.PINNED_CHAIN_CRC32), and of
     the kernels that take several rows a CTA on every one of their timed
     cases byte-identical to the one-row kernels before them
     (testing.PINNED_CASE_CRC32): yiq_b1 and fused_iir to 6f83bf8's,
     yuv_b1 and yuv_b2 to 3552a33's, yuv_a and yiq_a to a7f4f68's, yiq_b2
     to f9f71a9's, with the rows a CTA each chose; the raw decoder's
     line-tail chain (raw28_tails) exactly against its plain loop on three
     random [262, 1844] fields with random carries and two carried fields
     of a synthesized ntsc28 capture;
  4. the main paths, each with its kernels' launch counts set to 0 just
     before and read just after: `python -m cvsim_tpu_torch ntsc` and
     `python -m cvsim_tpu_torch to-composite` in-process on a 720x480
     colour-bar clip of 64 frames (128 fields, two GOPs), one launch of
     the chain kernel and one of field_streams a GOP, and one of
     y4m_payload a GOP in `ntsc` (none in `to-composite`); colour bars
     kept; the first 8 frames again through `--device cpu`, compared
     within the chain tolerance; then a short `to-composite
     -bkey-feedback 20` run on a clip with dark, keyed rows, cuda vs cpu;
     `to-composite -tvstd pal -vhs` on 64 frames of 720x576 (the split
     route, yuv_a/_b1/_b2) and `to-composite -nocolor-subcarrier -vhs` on
     the 720x480 clip (the debug-tap route, fused_iir), each against
     its first 8 frames through `--device cpu`;
     then the audio paths: `to-composite -vhs -audio-in` on the 128-field
     clip with a 48 kHz stereo WAV as long (the sinc resampler runs; kernel
     #5's launches read) and `ntsc -audio-in` with a 44.1 kHz one, each
     video byte-identical to the run without audio and each WAV against
     the same command through `--device cpu`; `cassette -preset 2`, cuda vs
     cpu; composite_audio_process on 2^21 stereo samples (two 1M-sample
     chunks) in the hi-fi 44.1 kHz and PAL linear 48 kHz configurations,
     card vs CPU chain, all within the chain tolerance, and TF32 off;
     then the multi-device paths: both tools with `-devices 1`, byte-
     identical to the runs without it; `-devices <count+1>` fails and names
     the count; the line-sharded program (4 row shards on one card, and
     over every card) at 240x704 B=64 and 540x1888 B=16 against kernel #1;
     with more than one card, both tools with `-devices <count>`;
     then `raw28ntsc` on two synthesized ntsc28 captures of 64 fields
     (1820 samples a line): the clean one plain, -color, -nosig and
     -showsc, and the jittery one (line jitter, DC drift, noise) plain
     and -color, raw28_tails launched once a field, each against its
     first 8 MiB through `--device cpu` (byte-identical; -color chroma
     within the chain tolerance); `scanimate` on colour bars at 720x480,
     with and without -inntsc, and `-tvstd 1080p60 -inntsc`, each
     against its first fields through `--device cpu`, and
     scanimate_field at 1080p in each warp effect, card against CPU,
     all identical;
     then `serve -socket <tmp> -prime` in this process on the card (its
     prime launches kernel #5 on a dummy 480x704 GOP), `-via
     to-composite -vhs` (from a `python -S` thin client) and `-via ntsc`
     on the 128-field clip, each byte-identical to the direct run above
     with #5's and #1's launches read around it, and the same
     to-composite as a fresh process; each host-only command once on
     the 8-frame clip (posterize, colormap, colorkey, average-delay,
     frameblend, filmac and vhsled through the native cvsim-av loop,
     normalize-ts, vaporwave, the repo tools on a temporary git repo)
     with the card's allocated memory unchanged across it; the host
     tools' device twins on a [16, 480, 720, 3] batch, card against CPU,
     identical; one to-composite under CVSIM_PROFILE, its Chrome trace
     written and its device busy share read from it;
  5. times, each taken in turns in this run: each kernel vs its plain
     version on the cases of testing.timed_cases, which kernel_ab.py times
     too (#1-#4 at 240x704 B=64 and 540x1888 B=16; #5 at 240x720 B=64,
     288x720 PAL B=64 and 540x1888 B=16, #6-#8 at the last two; the pole
     cascade on testing.iir_cases; field_streams at 240x720 B=64 in both
     benchmark configurations, its device time by torch.profiler;
     y4m_payload at the render's GOP in both layouts, by torch.profiler,
     against payloads_np's host wall time; CUDA
     events, median of 5), the gen-2
     split program vs kernel #1's path, the gen-1 split route
     vs yuv_chain at 576i and 1080i, the gen-1 black-key scan's host cost
     per GOP, and each CLI's end-to-end fields/s; the audio chains (both
     configurations and cassette -preset 2) per 1M-sample stereo chunk,
     their multiple of real time and the ops each chunk dispatches (aten
     ops, and device activities by torch.profiler). The audio path has no
     TPU kernel: the JAX chains are plain XLA, so the port's are plain
     torch. Then decode_lines a field and raw28_tails against its plain
     loop, both CLIs' fields/s (raw28ntsc against the capture's 59.94, on
     both captures), scanimate_field per call at each raster, both CLIs'
     device busy share (torch.profiler), and raw28ntsc's host stages a
     field on both captures (the line walk with its re-locks, the vsync
     hunt, the DC tracker, decode_lines' launches, the rest); the first served
     to-composite's wall beside the fresh process's. raw28_tails' bound counts its bytes and its
     int32 operations at the H100's 64 INT32 lanes an SM; the chain's
     serial latency sets its time.
Each kernel's bound is the larger of two times at the H100 SXM data
sheet's rates: the float32 operations its one-pole recurrences need (3
per sample per pole, plus #9's combine) over 67 TFLOP/s, and its bytes
(each input read once, each output written once) over 3.35 TB/s. The
count leaves out the element-wise stages and the noise hashing, so it is
a lower count and the bound a lower bound on time. Beside it [5] prints
the blocked form's floor: the multiply-adds of the block products the
kernel runs (8,256 per 128-sample block and product) at 33.5e12 a
second, the time the pole products alone would take at the float32 peak.
The line before the last is the card's name and power limit; the one
before it lists each kernel as JSON. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from fractions import Fraction
from functools import partial

# the port imports neither jax nor the JAX package
sys.modules["jax"] = None
sys.modules["cvsim_tpu"] = None

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# chain tolerance (cvsim_tpu_torch.testing.assert_chain_equal): at most
# 1 LSB on at most 0.1% of samples
TOLERANCE = "max |diff| <= 1 LSB on <= 0.1% of samples"
IIR_TOLERANCE = "max |diff| <= 8 float32 ULPs of max|x| times (1 + |gain|)"

# the H100 SXM data sheet's peaks (float32 outside the tensor cores, HBM3)
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# one pole y[t] = y[t-1] + a * (x[t] - y[t-1]) per sample: a subtract and a
# multiply-add, 3 operations (a multiply-add counts 2, as the peak does).
# The kernels' blocked form (pole.cuh) does far more: a 128 x 128
# lower-triangular product per block, 129 operations per sample for one
# pole or for a group of three.
POLE_FLOPS = 3
# the blocked form's floor: its products' multiply-adds (8,256 per block:
# the triangle with its diagonal; pole3's two block-end dots left out) at
# the float32 peak's multiply-add rate
BLOCK_FMAS = 128 * 129 // 2
FMA_PER_S = F32_FLOPS / 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def colour_bars(w: int, h: int):
    """RGB [h, w, 3] of seven 75% bars (SMPTE order)."""
    import numpy as np

    bars = [(192, 192, 192), (192, 192, 0), (0, 192, 192), (0, 192, 0),
            (192, 0, 192), (192, 0, 0), (0, 0, 192)]
    rgb = np.zeros((h, w, 3), np.uint8)
    bw = w // len(bars)
    for k, c in enumerate(bars):
        rgb[:, k * bw:(k + 1) * bw] = c
    return rgb, bw


def write_bars_y4m(path: str, frames: int, w: int = 720, h: int = 480):
    import numpy as np

    from cvsim_tpu_torch.host import y4m
    from cvsim_tpu_torch.host.colorconv import rgb_to_yuv601_np

    rgb, _ = colour_bars(w, h)
    y, u, v = (p.astype(np.uint8) for p in rgb_to_yuv601_np(
        *(rgb[..., c].astype(np.int32) for c in range(3))))
    hdr = y4m.Y4MHeader(width=w, height=h, fps=Fraction(30000, 1001),
                        colorspace="420jpeg")
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, hdr)
        for _ in range(frames):
            wr.write(y, u[0::2, 0::2], v[0::2, 0::2])
    return y, u[0::2, 0::2], v[0::2, 0::2]


def write_dark_y4m(path: str, frames: int, w: int = 720, h: int = 480):
    """Colour bars on the top half, dark near-neutral noise (Y 16..47, U/V
    118..137, a new draw every frame) on the bottom half: the bottom rows
    key under -bkey-feedback 20, so the filter frame carries from field
    to field."""
    import numpy as np

    from cvsim_tpu_torch.host import y4m

    y, u, v = write_bars_y4m(path, 0, w, h)
    rng = np.random.default_rng(20)
    hdr = y4m.Y4MHeader(width=w, height=h, fps=Fraction(30000, 1001),
                        colorspace="420jpeg")
    with open(path, "wb") as f:
        wr = y4m.Y4MWriter(f, hdr)
        for _ in range(frames):
            yk, uk, vk = y.copy(), u.copy(), v.copy()
            yk[h // 2:] = rng.integers(16, 48, (h - h // 2, w))
            uk[h // 4:] = rng.integers(118, 138, (h // 2 - h // 4, w // 2))
            vk[h // 4:] = rng.integers(118, 138, (h // 2 - h // 4, w // 2))
            wr.write(yk, uk, vk)


def read_y4m(path: str):
    from cvsim_tpu_torch.host import y4m

    with open(path, "rb") as f:
        r = y4m.Y4MReader(f)
        return r.header, list(r)


def check_bars(frames, y_in, u_in, v_in, limit: float) -> float:
    """Per-bar interior means of every 16th output frame near the input's;
    returns the worst difference in LSB."""
    _, bw = colour_bars(720, 480)
    worst = 0.0
    for k in range(7):
        xs = slice(k * bw + 20, (k + 1) * bw - 20)
        for (yo, uo, vo) in frames[::16]:
            for name, po, pi, rows, cols in (
                    ("Y", yo, y_in, slice(40, 400), xs),
                    ("U", uo, u_in, slice(20, 200),
                     slice(xs.start // 2, xs.stop // 2)),
                    ("V", vo, v_in, slice(20, 200),
                     slice(xs.start // 2, xs.stop // 2))):
                d = abs(float(po[rows, cols].mean())
                        - float(pi[rows, cols].mean()))
                worst = max(worst, d)
                if d > limit:
                    raise AssertionError(f"bar {k} {name}: mean off by {d:.2f}")
    return worst


def compare_cli(frames_gpu, frames_cpu, n_fields: int | None,
                what: str) -> int:
    """CUDA CLI output vs CPU CLI output, frame by frame, within the chain
    tolerance: the CPU run's fields (n_fields of them, when given) against
    the first as many of the CUDA run's; returns the largest difference."""
    from cvsim_tpu_torch.testing import assert_chain_equal, chain_diff

    if n_fields is not None and len(frames_cpu) != n_fields:
        raise AssertionError(f"{what} CPU run: {len(frames_cpu)} fields, "
                             f"expected {n_fields}")
    if not 0 < len(frames_cpu) <= len(frames_gpu):
        raise AssertionError(f"{what}: {len(frames_cpu)} CPU fields against "
                             f"{len(frames_gpu)} CUDA fields")
    err = 0
    for k, (fc, fg) in enumerate(zip(frames_cpu, frames_gpu)):
        for pc, pg in zip(fc, fg):
            err = max(err, chain_diff(pc, pg)[0])
            assert_chain_equal(pg, pc, err_msg=f"{what} cuda vs cpu field {k}")
    return err


def check_prepare(prep, prepare_cpu, what: str):
    import torch

    cpu = prepare_cpu()
    for field in ("xi", "keys_ab", "keep", "shifts"):
        if not torch.equal(getattr(prep, field).cpu(), getattr(cpu, field)):
            raise AssertionError(f"prepare {field}: cuda != cpu ({what})")


def streams_calls(dev, key) -> list:
    """[3] and [5]'s field_streams calls: (label, kernel call, plain call)
    in both benchmark configurations, at 64 fields of 240x720 (the
    benchmark's batch) and at 4096 random field numbers up to 2^31 - 1."""
    import torch

    from cvsim_tpu_torch.models import chain_prep, yiq
    from cvsim_tpu_torch.testing import bench_cli_configs

    gen = torch.Generator().manual_seed(18)
    batches = (("64 fields", torch.arange(1000, 1064, dtype=torch.int32)),
               ("4096 fields", torch.randint(0, 2 ** 31, (4096,),
                                             generator=gen,
                                             dtype=torch.int32)))
    calls = []
    for name, (cfg, gen1) in bench_cli_configs().items():
        for what, fn in batches:
            fn = fn.to(dev)
            args = (cfg, fn, (fn & 1) ^ 1, 240, 720, key)
            calls.append((f"{name} {what} of 240x720",
                          partial(chain_prep.field_streams_fused, *args,
                                  gen1=gen1),
                          partial(yiq.field_streams, *args, gen1=gen1)))
    return calls


def check_streams(calls) -> None:
    """[3] field_streams against yiq.field_streams on the card: all five
    outputs bit for bit, the floats as their int32 bits (-0.0 counts)."""
    import torch

    from cvsim_tpu_torch.models import yiq

    for label, kern, plain in calls:
        got, want = kern(), plain()
        for field, g, w in zip(yiq.FieldStreams._fields, got, want):
            g, w = g.cpu(), w.cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"field_streams {label} {field}: "
                                     "kernel != yiq.field_streams")
        print(f"[3] field_streams {label}: xi, keys_ab, sincos, keep, shifts "
              f"bit for bit equal to yiq.field_streams on the card")


def streams_bytes(b: int, l: int) -> int:
    """Bytes field_streams reads and writes for b fields of l lines: the
    int32 field numbers and parities in; xi, sin and cos, keep, shifts
    (20 bytes a line) and the two int64 keys out (the phase table's few
    hundred bytes left out)."""
    return b * (4 + 4 + 16) + b * l * (4 + 8 + 4 + 4)


def payload_calls(dev) -> list:
    """[3] and [5]'s y4m_payload calls at the render's GOP, 64 random RGB
    fields of 240x720 bobbed to 480 lines, at 4:2:0 and 4:2:2: (label,
    kernel call, plain call on the fields' host copy, bytes read and
    written)."""
    import torch

    from cvsim_tpu_torch.host import payload

    gen = torch.Generator().manual_seed(20)
    fields = torch.randint(0, 256, (64, 240, 720, 3), generator=gen,
                           dtype=torch.uint8)
    card = fields.to(dev)
    host = fields.numpy()
    return [(f"64 fields of 240x720 to 480 lines {name}",
             partial(payload.payloads, card, 480, is422),
             partial(payload.payloads_np, host, 480, is422),
             fields.numel() + 64 * payload.frame_bytes(480, 720, is422))
            for name, is422 in (("4:2:0", False), ("4:2:2", True))]


def check_payloads(calls) -> None:
    """[3] y4m_payload against payloads_np, every byte of every row."""
    import numpy as np

    for label, kern, plain, _ in calls:
        bad = np.flatnonzero(kern().cpu().numpy() != plain())
        if bad.size:
            raise AssertionError(f"y4m_payload {label}: {bad.size} bytes != "
                                 f"payloads_np, first at {bad[:5]}")
        print(f"[3] y4m_payload {label}: bit for bit equal to payloads_np")


def wall_ms(fn, reps: int = 3) -> float:
    """Median wall time in ms of `reps` calls of a host function."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def chain_cases(kernel: str, configs: dict) -> list:
    """(name, config, shape) of kernel #1's or #5's [3] cases: every
    configuration at the two small shapes, then the pinned bench cases."""
    from cvsim_tpu_torch.testing import BENCH_CONFIGS, PINNED_CHAIN_CRC32

    cases = [(n, c, s) for n, c in sorted(configs.items())
             for s in ((2, 32, 128), (1, 16, 176))]
    return cases + [(n, BENCH_CONFIGS[n], s)
                    for k, n, s in PINNED_CHAIN_CRC32 if k == kernel]


def kernel_cases_gen2(dev) -> int:
    """[3] yiq_chain vs fused_yiq.chain_reference; returns the largest
    difference."""
    import torch

    from cvsim_tpu_torch.models import fused_yiq
    from cvsim_tpu_torch.testing import (CHAIN_CONFIGS, assert_chain_equal,
                                         chain_diff, chain_inputs)

    cases = chain_cases("yiq_chain", CHAIN_CONFIGS)
    max_err, exact = 0, 0
    for name, cfg, shape in cases:
        (rgb,), prep = chain_inputs("yiq_chain", name, cfg, shape, dev)
        got = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
        torch.cuda.synchronize()
        want = fused_yiq.chain_reference(rgb, prep, cfg=cfg)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        dmax, frac = chain_diff(got, want)
        max_err = max(max_err, dmax)
        exact += dmax == 0
        print(f"[3] yiq_chain {name} {shape}: kernel vs plain max {dmax}, "
              f"frac {frac:.2e}")
        assert_chain_equal(got, want, err_msg=f"{name} {shape}")
        check_prepare(prep, lambda: chain_inputs(
            "yiq_chain", name, cfg, shape, "cpu")[1], name)
    print(f"[3] yiq_chain: exact in {exact} of {len(cases)} cases; prepare() "
          f"on the card == on the CPU for xi, keys_ab, keep, shifts in all; "
          f"tolerance: {TOLERANCE}")
    return max_err


def kernel_cases_gen1(dev) -> int:
    """[3] yuv_chain vs fused_yuv.chain_reference; returns the largest
    difference over the three planes."""
    import torch

    from cvsim_tpu_torch.models import fused_yuv
    from cvsim_tpu_torch.testing import (GEN1_CHAIN_CONFIGS,
                                         assert_chain_equal, chain_diff,
                                         chain_inputs)

    cases = chain_cases("yuv_chain", GEN1_CHAIN_CONFIGS)
    max_err, exact = 0, 0
    for name, cfg, shape in cases:
        planes, prep = chain_inputs("yuv_chain", name, cfg, shape, dev)
        got = fused_yuv.composite_video_process_fused(*planes, prep, cfg=cfg)
        torch.cuda.synchronize()
        want = fused_yuv.chain_reference(*planes, prep, cfg=cfg)
        diffs = []
        for k, (g, wnt) in enumerate(zip(got, want)):
            g, wnt = g.cpu().numpy(), wnt.cpu().numpy()
            diffs.append(chain_diff(g, wnt))
            assert_chain_equal(g, wnt, err_msg=f"{name} {shape} plane {k}")
        dmax = max(d for d, _ in diffs)
        max_err = max(max_err, dmax)
        exact += dmax == 0
        print(f"[3] yuv_chain {name} {shape}: kernel vs plain max {dmax}, "
              f"frac y/u/v {' '.join(f'{f:.2e}' for _, f in diffs)}")
        check_prepare(prep, lambda: chain_inputs(
            "yuv_chain", name, cfg, shape, "cpu")[1], name)
    print(f"[3] yuv_chain: exact in {exact} of {len(cases)} cases; prepare() "
          f"on the card == on the CPU for xi, keys_ab, keep, shifts in all; "
          f"tolerance: {TOLERANCE}")
    return max_err


def check_pinned(dev) -> None:
    """[3] kernels #1 and #5 on their bench cases (#5 launched directly)
    against the CRC32s of b8c5917's kernels."""
    from cvsim_tpu_torch.testing import (BENCH_CONFIGS, PINNED_CHAIN_CRC32,
                                         chain_crc32, chain_inputs)

    for (kernel, name, shape), pinned in PINNED_CHAIN_CRC32.items():
        cfg = BENCH_CONFIGS[name]
        crc = chain_crc32(kernel, cfg, *chain_inputs(kernel, name, cfg,
                                                     shape, dev))
        if crc != pinned:
            raise AssertionError(f"{kernel} {name} {shape}: CRC32 {crc:#010x}"
                                 f" != pinned {pinned:#010x}")
    print(f"[3] yiq_chain, yuv_chain: outputs byte-identical to b8c5917's "
          f"kernels in all {len(PINNED_CHAIN_CRC32)} bench cases (CRC32 == "
          f"testing.PINNED_CHAIN_CRC32)")


SPLIT_KERNELS = ("yiq_a", "yiq_b1", "yiq_b2")


def kernel_cases_split(dev, key) -> dict:
    """[3] yiq_a, yiq_b1, yiq_b2 vs their plain versions on row shards
    (testing.check_split_kernels); returns each kernel's largest difference
    of its own output (a float plane for yiq_a and yiq_b1)."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import fused_yiq
    from cvsim_tpu_torch.testing import (BENCH_VHS_EP, CHAIN_CONFIGS,
                                         check_split_kernels)

    cases = [(n, c, shape, row0, 16) for n, c in sorted(CHAIN_CONFIGS.items())
             for shape, row0 in (((2, 64, 128), 0), ((2, 64, 128), 48),
                                 ((1, 64, 176), 16))]
    cases += [("bench-vhs-ep", BENCH_VHS_EP, (64, 240, 704), row0, 60)
              for row0 in (0, 180)]
    cases += [("bench-vhs-ep", BENCH_VHS_EP, (16, 540, 1888), row0, 135)
              for row0 in (0, 405)]
    errs = dict.fromkeys(SPLIT_KERNELS, 0)
    for name, cfg, (b, l, w), row0, rows in cases:
        rng = np.random.default_rng(
            zlib.crc32(f"split{name}{b}{l}{w}{row0}".encode()))
        rgb_np = rng.integers(0, 256, (b, rows, w, 3)).astype(np.uint8)
        rgb = torch.from_numpy(rgb_np).to(dev)
        fn = torch.arange(b, dtype=torch.int32) + 3
        par = fn % 2
        prep = fused_yiq.prepare(cfg, rgb, fn, par, key, row0=row0, l_glob=l)
        diffs = check_split_kernels(cfg, rgb, prep,
                                    err_msg=f"{name} {(b, l, w)} row0 {row0}")
        for k, d in diffs.items():
            errs[k] = max(errs[k], d["plane"][0])
        print(f"[3] split {name} {(b, l, w)} rows {row0}..{row0 + rows - 1}: "
              + "; ".join(f"{k} own output max {d['plane'][0]} frac "
                          f"{d['plane'][1]:.2e}, to RGB max {d['rgb'][0]} "
                          f"frac {d['rgb'][1]:.2e}" for k, d in diffs.items()))
        check_prepare(prep, lambda: fused_yiq.prepare(
            cfg, torch.from_numpy(rgb_np), fn, par, key, row0=row0,
            l_glob=l), name)
    print(f"[3] split kernels: prepare() on the card == on the CPU in all "
          f"{len(cases)} cases; tolerance: the float planes of yiq_a and "
          f"yiq_b1 max |diff| <= 16 on <= 2% of samples, every output "
          f"once carried to 8-bit RGB {TOLERANCE}")
    return errs


GEN1_SPLIT_KERNELS = ("yuv_a", "yuv_b1", "yuv_b2")


def kernel_cases_gen1_split(dev) -> dict:
    """[3] yuv_a, yuv_b1, yuv_b2 each vs its plain version, and the split
    route vs yuv_chain (testing.check_gen1_split_kernels); returns each
    one's largest difference."""
    from cvsim_tpu_torch.testing import (BENCH_GEN1_EP, GEN1_CHAIN_CONFIGS,
                                         chain_inputs,
                                         check_gen1_split_kernels)

    cases = [(n, c, s) for n, c in sorted(GEN1_CHAIN_CONFIGS.items())
             for s in ((2, 32, 128), (1, 16, 176))]
    cases += [("bench-gen1-ep-pal", BENCH_GEN1_EP.with_(ntsc=False),
               (64, 288, 720)),
              ("bench-gen1-ep", BENCH_GEN1_EP, (16, 540, 1888))]
    errs, exact = {}, 0
    for name, cfg, shape in cases:
        (y, u, v), prep = chain_inputs("yuv_chain", f"split{name}", cfg,
                                       shape, dev)
        diffs = check_gen1_split_kernels(cfg, y, u, v, prep,
                                         err_msg=f"{name} {shape}")
        for k, (dmax, _) in diffs.items():
            errs[k] = max(errs.get(k, 0), dmax)
        exact += all(d == (0, 0.0) for d in diffs.values())
        print(f"[3] gen-1 split {name} {shape}: " + "; ".join(
            f"{k} max {d[0]} frac {d[1]:.2e}" for k, d in diffs.items()))
    print(f"[3] gen-1 split kernels: all outputs exact in {exact} of "
          f"{len(cases)} cases; tolerance: {TOLERANCE}")
    return errs


def kernel_cases_iir(cases) -> float:
    """[3] fused_iir vs fused_iir_reference on its timed cases
    (testing.iir_cases); returns the largest difference."""
    import torch

    from cvsim_tpu_torch.testing import iir_bound

    max_err = 0.0
    for case in cases:
        if case.kernel != "fused_iir":
            continue
        got = case.kern()
        torch.cuda.synchronize()
        want = case.plain()
        err = float((got - want).abs().max())
        bound = iir_bound(float(case.inputs[0].abs().max()), case.cfg["gain"])
        max_err = max(max_err, err)
        print(f"[3] fused_iir {case.label}: kernel vs plain max {err} (bound "
              f"{bound:.3e})")
        if not err <= bound:
            raise AssertionError(f"fused_iir {case.label}: max diff {err} > "
                                 f"{bound}")
    print(f"[3] fused_iir: tolerance {IIR_TOLERANCE}")
    return max_err


def rows_a_cta(case) -> int:
    """The rows a CTA that a multi-row kernel (testing.PINNED_KERNELS)
    takes on a timed case."""
    from cvsim_tpu_torch import kernels

    def padded(w):
        return -(-w // 128) * 128

    w = case.shape[-1]
    choose = getattr(kernels.load(), f"cvsim_{case.kernel}_rows_per_cta")
    # the gen-1 kernels' rows hold luma and half-width chroma planes
    widths = ((padded(w), padded(w // 2)) if case.kernel.startswith("yuv")
              else (padded(w),))
    return choose(*widths)


def check_case_pins(cases) -> None:
    """[3] the kernels that take several rows a CTA (yiq_b1, fused_iir,
    yuv_b1, yuv_b2, yuv_a, yiq_a, yiq_b2) on each of their timed cases
    against the CRC32s of the one-row kernels before them, and the rows a
    CTA each chose."""
    from cvsim_tpu_torch.testing import (PINNED_CASE_CRC32, PINNED_KERNELS,
                                         case_crc32)

    n, rows = 0, {}
    for case in cases:
        if case.kernel not in PINNED_KERNELS:
            continue
        label = f"{case.kernel} {case.label}"
        crc, pinned = case_crc32(case), PINNED_CASE_CRC32[label]
        if crc != pinned:
            raise AssertionError(f"{label}: CRC32 {crc:#010x} != pinned "
                                 f"{pinned:#010x}")
        n += 1
        rows[f"{case.kernel} at {case.shape[-1]} samples"] = rows_a_cta(case)
    print(f"[3] {', '.join(PINNED_KERNELS)}: outputs byte-identical to the "
          f"one-row kernels before them in all {n} timed cases (CRC32 == "
          f"testing.PINNED_CASE_CRC32); rows a CTA: "
          + ", ".join(f"{k} {v}" for k, v in rows.items()))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def prep_bytes(prep) -> int:
    """Bytes of a prepare()'s per-line inputs and constant tables."""
    return nbytes(*(t for t in prep if hasattr(t, "numel")), *prep.tables)


def bound_ms(flops: float, n_bytes: float) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes"): the larger of flops
    over the float32 peak and bytes over the memory rate."""
    t_ops = flops / F32_FLOPS * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gen2_poles(cfg) -> dict:
    """One-pole passes per row of kernels #1-#4 for cfg, all at the luma
    width, counted from yiq_chain.cu's row functions: a lowpass writeback
    is three poles, the VHS luma emphasis four, a noise walk one."""
    from cvsim_tpu_torch.models import fused_yiq

    p = fused_yiq._chain_params(cfg, 1, 1, 8, 128)
    a = 6 * p.in_lowpass + p.preemph + int(p.video_noise != 0)
    b1 = 2 * int(p.chroma_noise != 0) + 10 * p.vhs
    b2 = 3 * p.vhs + 6 * int(p.out_lowpass != 0)
    return {"yiq_a": a, "yiq_b1": b1, "yiq_b2": b2, "yiq_chain": a + b1 + b2}


def gen2_flops(cfg, name: str, b: int, l: int, w: int) -> float:
    return b * l * w * gen2_poles(cfg)[name] * POLE_FLOPS


def gen2_products(cfg) -> dict:
    """Block products per row of kernels #1-#4 for cfg, counted like
    gen2_poles: a lowpass writeback is one (T^3), the VHS luma emphasis
    two (T^3 and T), a noise walk or the preemphasis one."""
    from cvsim_tpu_torch.models import fused_yiq

    p = fused_yiq._chain_params(cfg, 1, 1, 8, 128)
    a = 2 * p.in_lowpass + p.preemph + int(p.video_noise != 0)
    b1 = 2 * int(p.chroma_noise != 0) + 4 * p.vhs
    b2 = p.vhs + 2 * int(p.out_lowpass != 0)
    return {"yiq_a": a, "yiq_b1": b1, "yiq_b2": b2, "yiq_chain": a + b1 + b2}


def blocks(w: int) -> int:
    return -(-w // 128)


def gen2_floor(cfg, name: str, b: int, l: int, w: int) -> float:
    """Kernel `name`'s blocked-form floor in ms."""
    fmas = b * l * gen2_products(cfg)[name] * blocks(w) * BLOCK_FMAS
    return fmas / FMA_PER_S * 1e3


def gen1_poles(cfg) -> dict:
    """(luma poles at w, chroma poles at w/2) per row of kernels #5-#8 for
    cfg, counted from yuv_chain.cu's row functions: a full chroma lowpass
    is four poles (the half-cut pole and three at the cut), a lite one or
    a VHS bandlimit three, the VHS luma emphasis four, a noise walk one."""
    from cvsim_tpu_torch.models import fused_yuv

    p = fused_yuv._yuv_params(cfg, 1, 1, 8, 128, 4, 128)
    out_lp = {0: 0, 1: 6, 2: 8}[p.out_lowpass]
    a = (p.preemph + int(p.video_noise != 0), 8 * p.in_lowpass)
    b1 = (4 * p.vhs, 2 * int(p.chroma_noise != 0) + 6 * p.vhs)
    b2 = (3 * p.vhs, 6 * p.vhs + out_lp)
    return {"yuv_a": a, "yuv_b1": b1, "yuv_b2": b2,
            "yuv_chain": tuple(map(sum, zip(a, b1, b2)))}


def gen1_flops(cfg, name: str, b: int, l: int, w: int) -> float:
    luma, chroma = gen1_poles(cfg)[name]
    return b * l * (luma * w + chroma * (w // 2)) * POLE_FLOPS


def gen1_products(cfg) -> dict:
    """(luma products at w, chroma products at w/2) per row of kernels
    #5-#8 for cfg, counted like gen1_poles: a full chroma lowpass is two
    (the half-cut pole and a T^3), a lite one or a VHS bandlimit one, the
    VHS luma emphasis two, a noise walk one."""
    from cvsim_tpu_torch.models import fused_yuv

    p = fused_yuv._yuv_params(cfg, 1, 1, 8, 128, 4, 128)
    out_lp = {0: 0, 1: 2, 2: 4}[p.out_lowpass]
    a = (p.preemph + int(p.video_noise != 0), 4 * p.in_lowpass)
    b1 = (2 * p.vhs, 2 * int(p.chroma_noise != 0) + 2 * p.vhs)
    b2 = (p.vhs, 2 * p.vhs + out_lp)
    return {"yuv_a": a, "yuv_b1": b1, "yuv_b2": b2,
            "yuv_chain": tuple(map(sum, zip(a, b1, b2)))}


def gen1_floor(cfg, name: str, b: int, l: int, w: int) -> float:
    luma, chroma = gen1_products(cfg)[name]
    fmas = b * l * (luma * blocks(w) + chroma * blocks(w // 2)) * BLOCK_FMAS
    return fmas / FMA_PER_S * 1e3


def iir_flops(rows: int, w: int, k: int, mode: str) -> float:
    """k poles over rows rows of w samples, plus the emph/unsharp combine
    (a subtract and a multiply-add per sample)."""
    return rows * w * (k * POLE_FLOPS + (0 if mode == "none" else 3))


def case_bound(case) -> tuple[float, str, float]:
    """(bound ms, "operations" or "bytes", blocked-form floor ms) of a
    testing.timed_cases case: its operations from its pole counts, its
    bytes from its inputs (a prepare()'s lines and tables among them)
    read once and its outputs written once."""
    out = case.kern()
    n_bytes = nbytes(*(out if isinstance(out, tuple) else (out,))) + sum(
        prep_bytes(t) if hasattr(t, "tables") else nbytes(t)
        for t in case.inputs)
    if case.kernel == "fused_iir":
        (rows, w), k = case.shape, len(case.cfg["alphas"])
        n_bytes += k * (128 * 128 + 128) * 4   # its tables
        # one product per pole (#9 does not group three)
        return (*bound_ms(iir_flops(rows, w, k, case.cfg["mode"]), n_bytes),
                rows * k * blocks(w) * BLOCK_FMAS / FMA_PER_S * 1e3)
    flops, floor = ((gen2_flops, gen2_floor) if case.kernel.startswith("yiq")
                    else (gen1_flops, gen1_floor))
    return (*bound_ms(flops(case.cfg, case.kernel, *case.shape), n_bytes),
            floor(case.cfg, case.kernel, *case.shape))


def launch_counts(kernels: dict) -> dict:
    """{label: launches so far} of `kernels` ({label: kernel name})."""
    from cvsim_tpu_torch.testing import launches

    return {label: launches(kernel) for label, kernel in kernels.items()}


def run_cli(cli_main, kernels, args):
    """One in-process CLI run; returns (seconds, {label: launches during
    it} of `kernels` ({label: kernel name}), header, frames)."""
    import torch

    before = launch_counts(kernels)
    t0 = time.perf_counter()
    rc = cli_main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {label: n - before[label]
                for label, n in launch_counts(kernels).items()}
    if rc != 0:
        raise AssertionError(f"CLI {args[:3]} rc {rc}")
    hdr, frames = read_y4m(args[args.index("-o") + 1])
    return seconds, launches, hdr, frames


def cli_fails(cli_main, args) -> tuple[int, str]:
    """(exit code, standard error) of an in-process CLI run."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(args)
    return rc, err.getvalue()


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def split_shapes(dev, key):
    """The bench VHS-EP inputs at the two full-width shapes of the split
    program: (label, rgb, fieldno, parity, prepare() of the whole field)."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import fused_yiq
    from cvsim_tpu_torch.testing import BENCH_VHS_EP

    out = []
    for b, l, w in ((64, 240, 704), (16, 540, 1888)):
        rng = np.random.default_rng(zlib.crc32(f"lines{b}{l}{w}".encode()))
        rgb = torch.from_numpy(
            rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8)).to(dev)
        fn = torch.arange(b, dtype=torch.int32) + 11
        prep = fused_yiq.prepare(BENCH_VHS_EP, rgb, fn, fn % 2, key)
        out.append((f"{l}x{w} B={b}", rgb, fn, fn % 2, prep))
    return out


def line_sharded_paths(shapes, key) -> dict:
    """[4] the line-sharded program (kernels #2-#4) with the split
    kernels' launch counts set to 0 just before and read just after: 4 row
    shards on card 0 (run_fused_lines_local), then the mesh path over every
    card (run_sharded_chain_fused_lines, one row shard per card), each
    against kernel #1 on the whole field. Returns the launch counts."""
    import torch

    from cvsim_tpu_torch.models import fused_yiq
    from cvsim_tpu_torch.parallel import (make_mesh, run_fused_lines_local,
                                          run_sharded_chain_fused_lines)
    from cvsim_tpu_torch.testing import (BENCH_VHS_EP, assert_chain_equal,
                                         chain_diff)

    count = torch.cuda.device_count()
    mesh = make_mesh(count, "cuda", dp=1)
    want = [fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=BENCH_VHS_EP)
            .cpu().numpy() for _, rgb, _, _, prep in shapes]
    split = {k: k for k in ("yiq_a", "yiq_b1", "yiq_b2")}
    before = launch_counts(split)
    results = []
    for (label, rgb, fn, par, _), ref in zip(shapes, want):
        got = run_fused_lines_local(BENCH_VHS_EP, rgb, fn, par, key, sp=4)
        results.append((f"{label} sp=4 on one card", got, ref))
        if rgb.shape[1] % count == 0:
            got = run_sharded_chain_fused_lines(mesh, BENCH_VHS_EP, rgb, fn,
                                                par, key)
            results.append((f"{label} over {count} card(s)", got, ref))
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in launch_counts(split).items()}
    for what, got, ref in results:
        got = got.cpu().numpy()
        dmax, frac = chain_diff(got, ref)
        print(f"[4] line-sharded program {what} vs yiq_chain: max diff "
              f"{dmax}, frac {frac:.2e}; tolerance: {TOLERANCE}")
        assert_chain_equal(got, ref, err_msg=what)
    print(f"[4] line-sharded program: kernel launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched by the line-"
                                 "sharded program")
    return launches


# the audio chains of [4] and [5]: the default hi-fi track (44.1 kHz
# stereo) and tests/test_audio.py's PAL linear track at 48 kHz (sync buzz
# and high boost), each with the CLI's default hiss; and cassette -preset 2
AUDIO_CONFIGS = {
    "hi-fi 44.1 kHz": {},
    "PAL linear 48 kHz": dict(ntsc=False, rate=48000, vhs_hifi=False,
                              vhs_linear_audio=True, lowpass_hz=10000.0,
                              highpass_hz=100.0, preemphasis_cut_hz=8000.0),
}
AUDIO_CHUNK = 1 << 20


def tone_samples(n: int, rate: int, seed: int):
    """int16 [n, 2]: a 440 Hz and a 3 kHz tone with noise."""
    import numpy as np

    t = np.arange(n)[:, None] / rate
    rng = np.random.default_rng(seed)
    sig = (8000 * np.sin(2 * np.pi * 440 * t)
           + 4000 * np.sin(2 * np.pi * 3000 * t + np.arange(2))
           + rng.normal(0, 800, (n, 2)))
    return np.clip(sig, -32768, 32767).astype(np.int16)


def write_tone_wav(path: str, seconds: float, rate: int, seed: int) -> int:
    from cvsim_tpu_torch.host import wavio

    n = int(round(seconds * rate))
    wavio.write_wav(path, tone_samples(n, rate, seed), rate)
    return n


def compare_audio(got, want, what: str) -> int:
    """Holds two int16 streams to the chain tolerance; returns the max
    difference."""
    from cvsim_tpu_torch.testing import assert_chain_equal, chain_diff

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    dmax, frac = chain_diff(got, want)
    print(f"[4] {what}: {got.shape[0]} samples x {got.shape[1]}, cuda vs "
          f"cpu max diff {dmax}, frac {frac:.2e}; tolerance: {TOLERANCE}")
    assert_chain_equal(got, want, err_msg=what)
    return dmax


def audio_cli_paths(cli_main, src: str, outs: dict, flags: list,
                    tmp: str) -> None:
    """[4] the audio paths through the CLI, each on the card and then on
    the CPU: `to-composite -vhs -audio-in` (a 48 kHz WAV as long as the
    128-field clip, so the sinc resampler runs) and `ntsc -audio-in`, both
    beside their video, whose bytes must equal the runs without audio;
    then `cassette -preset 2`."""
    from cvsim_tpu_torch.host import wavio

    seconds = 128 * 1001 / 60000
    wav48 = os.path.join(tmp, "tone48.wav")
    wav44 = os.path.join(tmp, "tone44.wav")
    write_tone_wav(wav48, seconds, 48000, 1)
    write_tone_wav(wav44, seconds, 44100, 2)
    for tool, kernel, extra, wav in (
            ("to-composite", "yuv_chain", ["-vhs"], wav48),
            ("ntsc", "yiq_chain", [], wav44)):
        out = os.path.join(tmp, f"out-{tool}-audio.y4m")
        aout = os.path.join(tmp, f"{tool}-cuda.wav")
        cli_s, counts, _, frames = run_cli(
            cli_main, {"kernel": kernel},
            ["--device", "cuda", tool, "-i", src, "-o", out, *extra, *flags,
             "-audio-in", wav, "-audio-out", aout])
        gops = -(-len(frames) // 64)
        if counts["kernel"] != gops or not same_bytes(out, outs[tool]):
            raise AssertionError(f"{tool} -audio-in: launches {counts}, "
                                 "or video bytes differ from the run "
                                 "without audio")
        aout_cpu = os.path.join(tmp, f"{tool}-cpu.wav")
        rc = cli_main(["--device", "cpu", tool, *extra, *flags,
                       "-audio-in", wav, "-audio-out", aout_cpu])
        if rc != 0:
            raise AssertionError(f"{tool} -audio-in CPU CLI rc {rc}")
        got, rate = wavio.read_wav(aout)
        print(f"[4] {tool} -audio-in --device cuda: {len(frames)} fields "
              f"and {got.shape[0]} samples at {rate} Hz in {cli_s:.3f} s; "
              f"kernel launches {counts['kernel']} for {gops} GOPs; video "
              f"byte-identical to the run without -audio-in")
        compare_audio(got, wavio.read_wav(aout_cpu)[0], f"{tool} -audio-in")
    outs_cas = [os.path.join(tmp, f"cassette-{d}.wav") for d in ("cuda",
                                                                 "cpu")]
    for dev, out in zip(("cuda", "cpu"), outs_cas):
        rc = cli_main(["--device", dev, "cassette", "-i", wav44, "-o", out,
                       "-preset", "2"])
        if rc != 0:
            raise AssertionError(f"cassette --device {dev} rc {rc}")
    compare_audio(wavio.read_wav(outs_cas[0])[0],
                  wavio.read_wav(outs_cas[1])[0], "cassette -preset 2")


def audio_chain_checks(dev) -> None:
    """[4] composite_audio_process on 2^21 stereo samples (two 1M-sample
    chunks with a carried state) in both AUDIO_CONFIGS, on the card and on
    the CPU."""
    from cvsim_tpu_torch.config import AudioConfig
    from cvsim_tpu_torch.host.pipeline import audio_chain

    for k, (name, kw) in enumerate(AUDIO_CONFIGS.items()):
        acfg = AudioConfig(**kw)
        samples = tone_samples(2 * AUDIO_CHUNK, acfg.rate, 10 + k)
        got = audio_chain(samples, acfg, 7, dev, AUDIO_CHUNK)
        want = audio_chain(samples, acfg, 7, "cpu", AUDIO_CHUNK)
        compare_audio(got, want, f"audio chain {name}, two 1M chunks")
    import torch

    # TF32 in the block products breaks the 1-LSB bound
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on for the audio chains' products")
    print("[4] audio chains: TF32 off (allow_tf32 False, float32 matmul "
          "precision 'highest')")


def count_ops():
    """A TorchDispatchMode that counts the aten ops dispatched inside its
    `with` block (in `.n`)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return CountOps()


def device_activities(fn) -> tuple[int, float] | None:
    """(count, summed duration in ms) of the device activities (kernels,
    copies, memsets) torch.profiler records in one call of fn; None when
    it records none (profiler not tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(us), sum(us) / 1e3) if us else None


def audio_steps(dev) -> dict:
    """{name: (rate, host note, step)}: one 1M-sample stereo chunk of each
    AUDIO_CONFIGS chain and of cassette -preset 2 on `dev`, each step a
    call of the chain from its initial state."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.audio import (buzz_pulse_counts,
                                       composite_audio_process,
                                       init_audio_state)
    from cvsim_tpu_torch.audio.cassette import (CASSETTE_PRESETS,
                                                CassetteConfig,
                                                cassette_audio_process,
                                                init_cassette_state)
    from cvsim_tpu_torch.config import AudioConfig

    steps = {}
    for k, (name, kw) in enumerate(AUDIO_CONFIGS.items()):
        acfg = AudioConfig(**kw)
        x = torch.from_numpy(tone_samples(AUDIO_CHUNK, acfg.rate, 20 + k)
                             .astype(np.int32)).to(dev)
        t0 = time.perf_counter()
        pulses = (None if acfg.vhs_hifi
                  else buzz_pulse_counts(acfg, 0, AUDIO_CHUNK))
        host_ms = (time.perf_counter() - t0) * 1e3
        host = (f"; buzz_pulse_counts on the host {host_ms:.1f} ms"
                if pulses is not None else "")
        state = init_audio_state(acfg, torch.float32, dev)
        steps[f"audio chain {name}"] = (acfg.rate, host, partial(
            composite_audio_process, x, state, 7, cfg=acfg, pulses=pulses))
    ccfg = CassetteConfig(**CASSETTE_PRESETS[2])
    x = torch.from_numpy(tone_samples(AUDIO_CHUNK, ccfg.rate, 30)
                         .astype(np.int32)).to(dev)
    steps["cassette -preset 2"] = (ccfg.rate, "", partial(
        cassette_audio_process, x, init_cassette_state(ccfg, torch.float32,
                                                       dev), 0, cfg=ccfg))
    return steps


def audio_times(dev, card: str) -> None:
    """[5] ms per 1M-sample stereo chunk on the card (testing.time_ms:
    CUDA events over one call, host launches included, median of 5), its
    multiple of real time, the ops it launches and the device time they
    take (torch.profiler: the durations of its device activities summed)."""
    from cvsim_tpu_torch.testing import time_ms

    for name, (rate, host, step) in audio_steps(dev).items():
        ms = time_ms(step)
        with count_ops() as ops:
            step()
        acts = device_activities(step)
        seconds = AUDIO_CHUNK / rate
        device = ("device time not measured (torch.profiler recorded no "
                  "device activity)" if acts is None else
                  f"{acts[0]} device activities, {acts[1]:.3f} ms of device "
                  f"time summed (torch.profiler) = {100 * acts[1] / ms:.1f}% "
                  f"of the chunk's {ms:.3f} ms")
        print(f"[5] {name}, one 1M-sample stereo chunk ({seconds:.2f} s of "
              f"audio) on {card}: {ms:.3f} ms = {seconds * 1e3 / ms:.1f}x "
              f"real time; {ops.n} aten ops dispatched; {device}{host}")


# ---- raw28ntsc and scanimate

RAW28_FIELDS = 64          # fields of the synthesized capture of [4]
RAW28_CPU_BYTES = 8 << 20  # its prefix decoded again on the CPU (the CLI
# reads 1 MiB chunks, so a whole number of them decodes the same fields)
# the H100 SXM's int32 rate outside the tensor cores: 64 INT32 units an SM
# (Hopper architecture white paper) x 132 SMs x 1.98 GHz boost
INT32_OPS = 64 * 132 * 1.98e9
# raw28_tails' integer operations a line: the enhancement's 3 per column
# of 28, 4 denoise passes of 3 per column, 12 chroma divides and luma
# subtracts, 16 carry divides
RAW28_LINE_OPS = 3 * 28 + 4 * 3 * 28 + 2 * 12 + 16


def raw28_timing():
    from cvsim_tpu_torch.models import raw28

    return raw28.RawTiming(raw28.rate_preset("ntsc28")).raw_length


def capture_lines(rl: int):
    """uint8 [262, rl + 24]: the 262 lines of one field of the synthesized
    ntsc28 capture, gathered from the line starts as Raw28Decoder does."""
    import numpy as np

    from cvsim_tpu_torch.testing import raw28_capture

    cap = raw28_capture(1, rl)
    idx = 6 * rl + np.arange(262)[:, None] * rl + np.arange(rl + 24)[None, :]
    return cap[np.minimum(idx, len(cap) - 1)]


def raw28_tail_case(lines, blank: float, white: float, dev):
    """(c3_tail, scan_tail) on dev of a field of raw lines, equalized as
    decode_lines equalizes them."""
    import torch

    from cvsim_tpu_torch.models import raw28

    lut = torch.from_numpy(raw28.equalize_lut(blank, white)).to(dev)
    x = torch.take(lut, torch.from_numpy(lines).to(dev).long())
    return raw28.tail_inputs(*raw28.split_lines(x, raw28_timing()))


def kernel_cases_raw28(dev) -> int:
    """[3] raw28_tails vs tail_chain_reference (its plain loop) on the
    card: three random [262, 1844] fields with random carries and AGC
    levels, then two fields of the synthesized ntsc28 capture's lines,
    the second carried from the first. Exact, or it raises."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import raw28
    from cvsim_tpu_torch.testing import RAW28_BLANK, RAW28_WHITE

    rl = raw28_timing()
    rng = np.random.default_rng(28)
    cases = [(f"random field {k}", rng.integers(0, 256, (262, rl + 24))
              .astype(np.uint8), rng.integers(-300, 300, 16),
              float(rng.uniform(0, 60)), float(rng.uniform(180, 250)))
             for k in range(3)]
    lines = capture_lines(rl)
    cases += [("capture field 1", lines, np.zeros(16), RAW28_BLANK,
               RAW28_WHITE), ("capture field 2", lines, None, RAW28_BLANK,
                              RAW28_WHITE)]
    carry_out = None
    for name, x, carry, blank, white in cases:
        c3t, st = raw28_tail_case(x, blank, white, dev)
        carry = (carry_out if carry is None else
                 torch.from_numpy(carry.astype(np.int32)).to(dev))
        got = raw28.raw28_tails(c3t, st, carry)
        torch.cuda.synchronize()
        want = raw28.tail_chain_reference(c3t, st, carry)
        for what, g, w in zip(("chroma", "luma", "carry"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"raw28_tails {name}: {what} differs "
                                     "from the plain loop")
        carry_out = got[2]
        print(f"[3] raw28_tails {name} ({x.shape[0]} lines of {rl} samples): "
              f"kernel == plain loop (chroma and luma at columns "
              f"{rl - 12}..{rl - 1}, carry)")
    print("[3] raw28_tails: exact in all cases (integers only)")
    return 0


def raw28_cli_paths(cli_main, tmp: str) -> dict:
    """[4] `raw28ntsc` on two synthesized ntsc28 captures of RAW28_FIELDS
    fields (1820 samples a line): the clean one (plain, -color, -nosig,
    -showsc) and the jittery one (testing.raw28_capture_jittery: line
    jitter, DC drift, noise; plain and -color). Each run has raw28_tails'
    launch count set to 0 just before and read just after (one launch a
    field), then the capture's first RAW28_CPU_BYTES go through `--device
    cpu`: its fields byte-identical to the card's first ones, or with
    -color luma identical and chroma within the chain tolerance. Returns
    {mode: (fields, seconds, launches)}."""
    import numpy as np

    from cvsim_tpu_torch.models import raw28
    from cvsim_tpu_torch.testing import (assert_chain_equal, chain_diff,
                                         raw28_capture, raw28_capture_jittery)

    rl = raw28_timing()
    paths = {}
    for kind, make in (("mono", lambda: raw28_capture(RAW28_FIELDS, rl)),
                       ("color", lambda: raw28_capture(RAW28_FIELDS, rl,
                                                       color=True)),
                       ("jittery", lambda: raw28_capture_jittery(
                           RAW28_FIELDS, rl))):
        cap = make()
        paths[kind] = os.path.join(tmp, f"capture-{kind}.raw")
        cap.tofile(paths[kind])
        cap[:RAW28_CPU_BYTES].tofile(paths[kind] + ".head")
    out_cpu = os.path.join(tmp, "raw28-cpu.y4m")
    results = {}
    for mode, flags, kind in (("plain", [], "mono"),
                              ("-color", ["-color"], "color"),
                              ("-nosig", ["-nosig"], "mono"),
                              ("-showsc", ["-showsc"], "mono"),
                              ("jittery", [], "jittery"),
                              ("jittery -color", ["-color"], "jittery")):
        out = os.path.join(tmp, f"raw28{mode.replace(' ', '')}.y4m")
        secs, counts, hdr, frames = run_cli(
            cli_main, {"raw28_tails": "raw28_tails"},
            ["--device", "cuda", "raw28ntsc", "-i", paths[kind], "-o", out,
             *flags])
        n = len(frames)
        if n < RAW28_FIELDS - 4 or counts["raw28_tails"] != n:
            raise AssertionError(f"raw28ntsc {mode}: {n} fields, "
                                 f"raw28_tails launches {counts}")
        if (hdr.width, hdr.height) != ((rl + 1) & ~1, 262):
            raise AssertionError(f"raw28ntsc {mode}: {hdr.width}x{hdr.height}")
        if (mode in ("plain", "jittery")
                and frames[10][0][100, 400:1700].max() < 100):
            raise AssertionError(f"raw28ntsc {mode}: the ramp was not "
                                 "recovered")
        rc = cli_main(["--device", "cpu", "raw28ntsc", "-i",
                       paths[kind] + ".head", "-o", out_cpu, *flags])
        if rc != 0:
            raise AssertionError(f"raw28ntsc {mode} CPU CLI rc {rc}")
        frames_cpu = read_y4m(out_cpu)[1]
        if not 8 <= len(frames_cpu) <= n:
            raise AssertionError(f"raw28ntsc {mode}: {len(frames_cpu)} CPU "
                                 "fields")
        err = 0
        for k, (fg, fc) in enumerate(zip(frames, frames_cpu)):
            for plane, (pg, pc) in enumerate(zip(fg, fc)):
                if "-color" in flags and plane > 0:
                    err = max(err, chain_diff(pg, pc)[0])
                    assert_chain_equal(pg, pc, err_msg=f"raw28ntsc {mode} "
                                       f"field {k} plane {plane}")
                elif not np.array_equal(pg, pc):
                    raise AssertionError(f"raw28ntsc {mode} field {k} plane "
                                         f"{plane}: cuda != cpu")
        how = (f"luma identical, chroma max diff {err} ({TOLERANCE})"
               if "-color" in flags else "byte-identical")
        print(f"[4] raw28ntsc {mode} --device cuda: {n} fields "
              f"({hdr.width}x{hdr.height}) in {secs:.3f} s = {n / secs:.2f} "
              f"fields/s, raw28_tails launches {counts['raw28_tails']}; the "
              f"first {len(frames_cpu)} against --device cpu: {how}")
        results[mode] = (n, secs, counts["raw28_tails"])
    return results


SCANIMATE_CASES = (
    # label, flags, raster, frames on the card, frames on the CPU
    ("720x480", [], (720, 480), 16, 4),
    ("720x480 -inntsc", ["-inntsc"], (720, 480), 16, 4),
    ("1080p60 -inntsc", ["-tvstd", "1080p60", "-inntsc"], (1920, 1080), 8, 1),
)


def scanimate_cli_paths(cli_main, tmp: str) -> dict:
    """[4] `scanimate` on colour bars at its raster (2 fields a frame),
    cuda, then the first frames again through `--device cpu`: identical
    (the card and the CPU run the same float32 and float64 math, each op
    correctly rounded). Returns {label: (fields, seconds, args)}."""
    import numpy as np

    out_cpu = os.path.join(tmp, "scanimate-cpu.y4m")
    results = {}
    for label, flags, (w, h), frames_n, cpu_frames in SCANIMATE_CASES:
        src = os.path.join(tmp, f"bars{w}x{h}.y4m")
        head = src + ".head.y4m"
        write_bars_y4m(src, frames_n, w, h)
        write_bars_y4m(head, cpu_frames, w, h)
        out = os.path.join(tmp, f"scanimate-{w}{''.join(flags)}.y4m")
        args = ["--device", "cuda", "scanimate", "-i", src, "-o", out, *flags]
        secs, _, hdr, frames = run_cli(cli_main, {}, args)
        if len(frames) != 2 * frames_n or (hdr.width, hdr.height) != (w, h):
            raise AssertionError(f"scanimate {label}: {len(frames)} fields "
                                 f"of {hdr.width}x{hdr.height}")
        if frames[1][0].max() < 100:
            raise AssertionError(f"scanimate {label}: no phosphor dots")
        rc = cli_main(["--device", "cpu", "scanimate", "-i", head, "-o",
                       out_cpu, *flags])
        if rc != 0:
            raise AssertionError(f"scanimate {label} CPU CLI rc {rc}")
        frames_cpu = read_y4m(out_cpu)[1]
        if len(frames_cpu) != 2 * cpu_frames:
            raise AssertionError(f"scanimate {label}: {len(frames_cpu)} CPU "
                                 "fields")
        for k, (fg, fc) in enumerate(zip(frames, frames_cpu)):
            for a, b in zip(fg, fc):
                if not np.array_equal(a, b):
                    raise AssertionError(f"scanimate {label} field {k}: cuda "
                                         "!= cpu")
        print(f"[4] scanimate {label} --device cuda: {len(frames)} fields in "
              f"{secs:.3f} s = {len(frames) / secs:.2f} fields/s; the first "
              f"{2 * cpu_frames} against --device cpu: identical")
        results[label] = (len(frames), secs, args)
    return results


def scanimate_field_effects(dev) -> None:
    """[4] scanimate_field at 1080p (1920x1080 colour bars), one field in
    each of the 4 warp effects, progressive and -inntsc, card against
    CPU: identical, or it raises."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import tools
    from cvsim_tpu_torch.testing import chain_diff

    rgb, _ = colour_bars(1920, 1080)
    src = torch.from_numpy(rgb)[None]
    for ntsc in (False, True):
        mode = "-inntsc" if ntsc else "progressive"
        for fieldno in (40, 220, 400, 580):
            got = tools.scanimate_field(src.to(dev), 1080, 1920, 1, [fieldno],
                                        input_ntsc=ntsc).cpu().numpy()
            want = tools.scanimate_field(src, 1080, 1920, 1, [fieldno],
                                         input_ntsc=ntsc).numpy()
            if not np.array_equal(got, want):
                dmax, frac = chain_diff(got, want)
                raise AssertionError(f"scanimate_field 1080p {mode} field "
                                     f"{fieldno}: cuda != cpu (max diff "
                                     f"{dmax}, frac {frac:.2e})")
            print(f"[4] scanimate_field 1080p {mode} field {fieldno} (effect "
                  f"{fieldno // 180}): cuda == cpu, raster max "
                  f"{int(want.max())}")


def cli_device_share(cli_main, args) -> str:
    """torch.profiler's device activities over one in-process CLI run:
    their count, summed duration and share of the run's wall."""
    t0 = time.perf_counter()
    acts = device_activities(lambda: cli_main(args))
    wall = (time.perf_counter() - t0) * 1e3
    if acts is None:
        return "device time not measured (torch.profiler recorded none)"
    return (f"{acts[0]} device activities, {acts[1]:.3f} ms of device time "
            f"summed = {100 * acts[1] / wall:.1f}% of the {wall:.1f} ms "
            "profiled run")


def raw28_host_stages(cli_main, args) -> str:
    """Where one in-process `raw28ntsc` run's wall goes on the host: the
    time inside walk_lines (the line pacing and per-line re-lock, one
    native scan a field; its twin where g++ is missing is
    walk_lines_numpy, relock_hsync a line), hunt_vsync (its native scan
    and the AGC's updates), the DC tracker's process and decode_lines
    (its launches; the card's work is waited for later, in the copy
    back), each wrapped with a timer for this run only, and the rest (the
    line gather, the copies and their waits, the Y4M writes), per field
    and as shares of the wall."""
    import torch

    from cvsim_tpu_torch import native
    from cvsim_tpu_torch.models import raw28

    spent = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return run

    saved = [(obj, name, getattr(obj, name)) for obj, name in (
        (raw28, "walk_lines"), (raw28, "hunt_vsync"),
        (native.HsyncDcTracker, "process"), (raw28, "decode_lines"))]
    for obj, name, fn in saved:
        setattr(obj, name, timed(name, fn))
    try:
        t0 = time.perf_counter()
        rc = cli_main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    if rc != 0:
        raise AssertionError(f"raw28ntsc host stages: rc {rc}")
    n = len(read_y4m(args[args.index("-o") + 1])[1])
    spent["rest"] = wall - sum(spent.values())
    return (f"{n} fields in {wall * 1e3:.1f} ms: " + ", ".join(
        f"{name} {t * 1e3 / n:.3f} ms a field ({100 * t / wall:.1f}%)"
        for name, t in spent.items()))


def raw28_scanimate_times(dev, card: str, cli_main, raw28_runs: dict,
                          scan_runs: dict, tmp: str) -> dict:
    """[5] decode_lines ms a field and raw28_tails against its plain loop
    on the card (testing.time_ms), both CLIs' fields/s from [4], the
    scanimate device step per batch, and both CLIs' device busy share.
    Returns raw28_tails' (ms, plain_ms, bound_ms, bound_by)."""
    import torch

    from cvsim_tpu_torch.models import raw28, tools
    from cvsim_tpu_torch.testing import RAW28_BLANK, RAW28_WHITE, time_ms

    rl = raw28_timing()
    lines_np = capture_lines(rl)
    lines = torch.from_numpy(lines_np).to(dev)
    carry = torch.zeros(16, dtype=torch.int32, device=dev)
    decode = lambda: raw28.decode_lines(lines, RAW28_BLANK, RAW28_WHITE,
                                        raw_len=rl, width=(rl + 1) & ~1,
                                        chroma_carry=carry)
    c3t, st = raw28_tail_case(lines_np, RAW28_BLANK, RAW28_WHITE, dev)
    kern = lambda: raw28.raw28_tails(c3t, st, carry)
    plain = lambda: raw28.tail_chain_reference(c3t, st, carry)
    dec_ms, k_ms, p_ms, k2_ms = (time_ms(decode), time_ms(kern),
                                 time_ms(plain), time_ms(kern))
    k_b2b = time_ms(kern, calls=10)
    n = lines.shape[0]
    n_bytes = nbytes(c3t, st, carry) + nbytes(*kern())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * RAW28_LINE_OPS / INT32_OPS * 1e3
    bound = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
             "operations")
    print(f"[5] decode_lines, one field of {n} lines x {rl} samples on "
          f"{card}: {dec_ms:.3f} ms (equalize, Y/C split, raw28_tails, "
          f"outputs; host launches included)")
    print(f"[5] raw28_tails {n} lines on {card}: kernel {k_ms * 1e3:.1f} us "
          f"(again {k2_ms * 1e3:.1f} us; back to back {k_b2b * 1e3:.1f} us); "
          f"plain loop on the card {p_ms:.3f} ms = {p_ms / k_ms:.0f}x; bound "
          f"{bound[0] * 1e3:.4f} us ({bound[1]}: {n_bytes} bytes, "
          f"{n * RAW28_LINE_OPS} int32 operations), the chain's serial "
          "latency, which no bound counts, sets its time")
    for mode, kind in (("plain", "mono"), ("jittery", "jittery")):
        n_f, secs, _ = raw28_runs[mode]
        what = "clean" if kind == "mono" else "jittery"
        print(f"[5] raw28ntsc CLI end to end, {what} capture, on {card}: "
              f"{n_f / secs:.2f} fields/s against the capture's 59.94 ({n_f} "
              "fields of 262x1820, build excluded)")
        args = ["--device", "cuda", "raw28ntsc", "-i",
                os.path.join(tmp, f"capture-{kind}.raw.head"), "-o",
                os.path.join(tmp, "raw28-prof.y4m")]
        print(f"[5] raw28ntsc CLI device busy, {what} capture "
              f"({RAW28_CPU_BYTES >> 20} MiB): "
              + cli_device_share(cli_main, args))
        print(f"[5] raw28ntsc CLI host stages, {what} capture "
              f"({RAW28_CPU_BYTES >> 20} MiB): "
              + raw28_host_stages(cli_main, args))

    for label, (n_f, secs, args) in scan_runs.items():
        print(f"[5] scanimate {label} CLI end to end on {card}: "
              f"{n_f / secs:.2f} fields/s ({n_f} fields, build excluded)")
    for label, flags, (w, h), _, _ in SCANIMATE_CASES:
        ntsc = "-inntsc" in flags
        b = 8 if ntsc else 16     # a CLI call: 16 fields, 8 a parity
        rgb, _ = colour_bars(w, h)
        src = torch.from_numpy(rgb)[None].expand(b, -1, -1, -1).to(dev)
        ms = time_ms(lambda: tools.scanimate_field(
            src, h, w, 1, list(range(40, 40 + b)), input_ntsc=ntsc))
        print(f"[5] scanimate_field {label}, {b} fields a call on {card}: "
              f"{ms:.3f} ms = {b / ms * 1e3:.1f} fields/s on the device")
    _, _, args = scan_runs["720x480"]
    print(f"[5] scanimate 720x480 CLI device busy: "
          + cli_device_share(cli_main, args))
    return (k_ms, p_ms, *bound)


# ---- the host-only tools, serve/-via, the device twins and CVSIM_PROFILE

def serve_paths(cli_main, src: str, outs: dict, flags: list,
                tmp: str) -> dict:
    """[4] `serve -socket <tmp> -prime` in this process on the card (the
    gen-1 GOP step on a dummy 480x704 GOP: kernel #5 launches during the
    prime), then `-via to-composite -vhs` (through `python -S -m
    cvsim_tpu_torch -via`, the thin client) and `-via ntsc` (in-process
    client) on the 128-field bars clip, each byte-identical to the direct
    run of [4] with kernel #5's and #1's launches read around it; then
    the same to-composite as a fresh process (the kernels loaded from
    _build/, CVSIM_PHASES=1). Returns the walls."""
    import threading

    from cvsim_tpu_torch.cli import serve

    kernels = {"yuv_chain": "yuv_chain", "yiq_chain": "yiq_chain"}
    base = {}

    def zero():
        base.update(launch_counts(kernels))

    def read():
        return {k: n - base[k] for k, n in launch_counts(kernels).items()}

    sock = os.path.join(tmp, "serve.sock")
    ready, stop, box = threading.Event(), threading.Event(), {}

    def run():
        box["rc"] = serve.run_serve(["-socket", sock, "-prime"], "cuda",
                                    ready, stop)
        ready.set()

    zero()
    t0 = time.perf_counter()
    server = threading.Thread(target=run, name="smoke-serve", daemon=True)
    server.start()
    if not ready.wait(600) or "rc" in box:
        raise AssertionError(f"serve -prime did not come up: {box}")
    prime_s = time.perf_counter() - t0
    primed = read()
    print(f"[4] serve -prime --device cuda: ready in {prime_s:.3f} s; "
          f"launches during the prime {primed}")
    if primed["yuv_chain"] < 1:
        raise AssertionError("serve -prime launched no yuv_chain")
    walls = {"prime_s": prime_s}
    runs = (("to-composite", ["-vhs"], "yuv_chain", True),
            ("ntsc", [], "yiq_chain", False))
    try:
        for tool, extra, kernel, thin in runs:
            out = os.path.join(tmp, f"served-{tool}.y4m")
            argv = [tool, "-i", src, "-o", out, *extra, *flags]
            zero()
            t0 = time.perf_counter()
            if thin:
                r = subprocess.run([sys.executable, "-S", "-m",
                                    "cvsim_tpu_torch", "-via", sock, *argv],
                                   cwd=ROOT, capture_output=True, text=True,
                                   timeout=600)
                rc = r.returncode
            else:
                rc = cli_main(["-via", sock, *argv])
            secs = time.perf_counter() - t0
            counts = read()
            if rc != 0:
                raise AssertionError(f"-via {tool}: rc {rc}")
            if not same_bytes(out, outs[tool]):
                raise AssertionError(f"-via {tool}: output differs from the "
                                     "direct run")
            gops = -(-len(read_y4m(out)[1]) // 64)
            if counts[kernel] != gops:
                raise AssertionError(f"-via {tool}: launches {counts}, "
                                     f"expected {gops} of {kernel}")
            walls[tool] = secs
            client = ("python -S -m cvsim_tpu_torch -via" if thin
                      else "in-process -via")
            print(f"[4] served {tool} ({client}): {gops} GOPs byte-identical "
                  f"to the direct run in {secs:.3f} s; launches {counts}")
    finally:
        stop.set()
        server.join(timeout=60)
    if box.get("rc") != 0 or server.is_alive():
        raise AssertionError(f"serve ended with {box}")

    # the same command as a fresh process: interpreter, torch import, CUDA
    # context and the kernels' load from _build/ are all in its wall
    out = os.path.join(tmp, "fresh-to-composite.y4m")
    env = dict(os.environ, CVSIM_PHASES="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cvsim_tpu_torch",
                        "to-composite", "-i", src, "-o", out, "-vhs", *flags],
                       cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=600)
    walls["fresh"] = time.perf_counter() - t0
    if r.returncode != 0 or not same_bytes(out, outs["to-composite"]):
        raise AssertionError(f"fresh to-composite: rc {r.returncode}, "
                             f"{r.stderr[-2000:]}")
    phases = [line.split()[1] + "@" + line.split("proc_age=")[1].split()[0]
              for line in r.stderr.splitlines() if line.startswith("[phase]")]
    print(f"[4] fresh process to-composite: byte-identical in "
          f"{walls['fresh']:.3f} s; phases (seconds since exec): "
          + ", ".join(phases))
    return walls


HOST_TOOLS = [
    ("posterize", ["-threshhold", "3"]),
    ("colormap", []),
    ("colorkey", ["-color", "0x101010", "-threshhold", "40", "-noise",
                  "500", "-xd", "3", "-d", "2"]),
    ("average-delay", ["-d", "2", "-n", "64"]),
    ("frameblend", ["-or", "24"]),
    ("filmac", ["-gamma", "vga"]),
    ("vhsled", []),
    ("normalize-ts", []),
]
RESTORE_TOOLS = ("frameblend", "filmac", "vhsled")


def host_tool_paths(cli_main, src8: str, tmp: str) -> None:
    """[4] each host-only command once on the 8-frame bars clip (the
    repo tools on a temporary git repo), torch.cuda.memory_allocated()
    unchanged across each, and the restore tools through the native
    cvsim-av loop (toolargs.fast_restore returns its exit code) where
    this host can build cvsim-av (g++ and the libav* libraries); where it
    cannot, the line says so and the restore tools run their Python loop
    (the CPU tests hold both loops to the same bytes)."""
    import contextlib
    import io
    import shutil

    import torch

    from cvsim_tpu_torch import native as native_mod
    from cvsim_tpu_torch.cli import toolargs

    have_av = native_mod.build_av_tool() is not None

    native = {}
    fast = toolargs.fast_restore

    def recorded(tool, argv):
        native[tool] = fast(tool, argv)
        return native[tool]

    toolargs.fast_restore = recorded
    lines = []
    try:
        repo = os.path.join(tmp, "repo")
        os.makedirs(repo)
        with open(os.path.join(repo, "a.txt"), "w") as f:
            f.write("a\n")
        for argv in (["init", "-q"], ["config", "user.email", "s@x"],
                     ["config", "user.name", "s"], ["add", "-A"],
                     ["commit", "-qm", "c0"]):
            subprocess.run(["git", "-C", repo, *argv], check=True,
                           capture_output=True)
        with open(os.path.join(repo, "b.txt"), "w") as f:
            f.write("b\n")
        runs = [(tool, [tool, *(["-i", src8] if tool == "colormap" else []),
                        "-i", src8, "-o", os.path.join(tmp, f"{tool}.y4m"),
                        *flags]) for tool, flags in HOST_TOOLS]
        runs += [("vaporwave", ["vaporwave", "cvsim"]),
                 ("repo-update-all", ["repo-update-all", "-no-push", "-C",
                                      repo])]
        if shutil.which("xz"):
            runs.append(("repo-source-pickup", ["repo-source-pickup", "-C",
                                                repo, "-o", tmp]))
        else:
            lines.append("repo-source-pickup not run: no xz on this host")
        for tool, argv in runs:
            before = torch.cuda.memory_allocated()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(argv)
            secs = time.perf_counter() - t0
            after = torch.cuda.memory_allocated()
            if rc != 0 or before != after:
                raise AssertionError(f"{tool}: rc {rc}, device memory "
                                     f"{before} -> {after} bytes")
            if tool in RESTORE_TOOLS and (native.get(tool) is None) == have_av:
                raise AssertionError(f"{tool}: cvsim-av built {have_av}, "
                                     f"fast path rc {native.get(tool)}")
            what = (f"{len(read_y4m(argv[argv.index('-o') + 1])[1])} frames"
                    if "-o" in argv and argv[argv.index("-o") + 1].endswith(
                        ".y4m") else out.getvalue().strip()[:40])
            loop = ((", cvsim-av" if have_av else ", Python loop")
                    if tool in RESTORE_TOOLS else "")
            lines.append(f"{tool} {secs:.3f} s ({what}{loop})")
    finally:
        toolargs.fast_restore = fast
    if not have_av:
        lines.append("cvsim-av not built on this host (g++ or the libav* "
                     "libraries missing): the restore tools ran their "
                     "Python loop")
    print(f"[4] host-only commands, rc 0, device memory unchanged "
          f"({torch.cuda.memory_allocated()} bytes allocated): "
          + "; ".join(lines))


def device_twin_checks(dev) -> None:
    """[4] the host tools' device twins (models/tools.py, models/restore.py,
    ops/noise.randint_stream) on a [16, 480, 720, 3] batch of colour bars
    with noise and jittered left margins, the card against the CPU:
    identical (integers only)."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import restore, tools
    from cvsim_tpu_torch.ops import noise

    rng = np.random.default_rng(12)
    bars, _ = colour_bars(720, 480)
    batch = np.repeat(bars[None].astype(np.int32), 16, axis=0)
    batch = np.clip(batch + rng.integers(-20, 21, batch.shape), 0, 255)
    for k in range(16):
        for y, m in enumerate(8 + (6 * np.sin(np.arange(480) / 7 + k))
                              .astype(int)):
            batch[k, y, :m] = 0
    batch = batch.astype(np.int32)
    other = np.roll(batch, 5, axis=0)
    lut = rng.integers(0, 256, (256, 3)).astype(np.int32)
    gdec, genc = restore.gamma_tables(2.2)
    w16 = [(k, 0x1000) for k in range(16)]
    levels = restore.FilmacState()
    restore.filmac_update_levels(levels, 3 << 22, 200 << 16)
    twins = {
        "randint_stream": lambda d: noise.randint_stream(
            77, (16, 480, 720), 0, 20001, d),
        "posterize": lambda d: tools.posterize(batch, 3, d),
        "colormap_apply": lambda d: tools.colormap_apply(batch, lut, d),
        "colorkey_apply": lambda d: tools.colorkey_apply(
            other, batch, 77, color=(192, 0, 192), threshhold=90,
            invert=True, noisekey=3000, fade=64, xdivr=3, device=d),
        "average_delay_blend": lambda d: tools.average_delay_blend(
            other, batch, list(range(16)), newlevel=100, delay=3, device=d),
        "frameblend_mix": lambda d: restore.frameblend_mix(
            batch, w16, gdec, genc, device=d),
        "filmac_measure": lambda d: torch.tensor(restore.filmac_measure(
            batch, gdec, device=d)),
        "filmac_rescale": lambda d: restore.filmac_rescale(
            batch, levels, 0x10000 * 8192, gdec, genc, device=d),
        "vhsled_dejitter": lambda d: restore.vhsled_dejitter(batch, d),
    }
    shifted = 0
    for name, fn in twins.items():
        got, want = fn(dev).cpu(), fn("cpu")
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{name}: card != CPU")
        if name == "vhsled_dejitter":
            shifted = int((got != torch.from_numpy(batch)).any(-1).any(-1)
                          .sum())
    print(f"[4] device twins on [16, 480, 720, 3], card == CPU exactly: "
          f"{', '.join(twins)} (vhsled shifted {shifted} of 7680 rows)")


def profile_check(cli_main, src8: str, flags: list, tmp: str) -> str:
    """[4] one `to-composite -vhs` on the 8-frame clip under
    CVSIM_PROFILE=<tmp dir>: the Chrome trace is written and not empty;
    returns the device busy share read from it (kernel, copy and set
    events' summed durations over the traced span)."""
    trace_dir = os.path.join(tmp, "profile")
    os.environ["CVSIM_PROFILE"] = trace_dir
    try:
        rc = cli_main(["--device", "cuda", "to-composite", "-i", src8, "-o",
                       os.path.join(tmp, "profiled.y4m"), "-vhs", *flags])
    finally:
        del os.environ["CVSIM_PROFILE"]
    files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    if rc != 0 or len(files) != 1:
        raise AssertionError(f"CVSIM_PROFILE run: rc {rc}, files {files}")
    path = os.path.join(trace_dir, files[0])
    size = os.path.getsize(path)
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    if size == 0 or not events:
        raise AssertionError(f"CVSIM_PROFILE trace {path}: {size} bytes")
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span = (max(e["ts"] + e.get("dur", 0) for e in events)
            - min(e["ts"] for e in events))
    busy = sum(e.get("dur", 0) for e in device)
    share = (f"{len(device)} device events, {busy / 1e3:.3f} ms of "
             f"{span / 1e3:.3f} ms traced = {100 * busy / span:.1f}% busy"
             if device else "no device events in the trace")
    print(f"[4] CVSIM_PROFILE to-composite -vhs (16 fields): trace "
          f"{files[0]} ({size} bytes, {len(events)} events); {share}")
    return share


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from cvsim_tpu_torch import interop, kernels
    from cvsim_tpu_torch.cli.main import main as cli_main
    from cvsim_tpu_torch.host.pipeline import _bkey_scan
    from cvsim_tpu_torch.models import fused_yiq, fused_yuv, yiq
    from cvsim_tpu_torch.ops import fused_iir
    from cvsim_tpu_torch.parallel import run_fused_lines_local
    from cvsim_tpu_torch.testing import (BENCH_VHS_EP, PINNED_KERNELS,
                                         time_ms, timed_cases)

    # ---- 1. the card
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- 2. build
    t0 = time.perf_counter()
    kernels.load()
    print(f"[2] built {kernels.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"    ptxas: {line.strip()}")
    # the CLI's frame scaler is a host C++ library built at first use
    # (g++, seconds); build it here so that the timed CLI runs exclude it
    from cvsim_tpu_torch.native.hostpix import scale_frame_to

    t0 = time.perf_counter()
    grey = np.full((8, 8), 128, np.uint8)
    scale_frame_to(grey, grey[::2, ::2], grey[::2, ::2], 8, 8)
    print(f"[2] host frame scaler ready in {time.perf_counter() - t0:.2f} s")
    # raw28ntsc's DC tracker is host C++ too (libhostio, g++); its numpy
    # twin would pass unseen, so its build is checked here
    from cvsim_tpu_torch.models.raw28 import RawTiming, rate_preset
    from cvsim_tpu_torch.native import HsyncDcTracker

    t0 = time.perf_counter()
    rt = RawTiming(rate_preset("ntsc28"))
    tracker = HsyncDcTracker(rt.sample_rate, rt.one_scanline_time,
                             rt.one_frame_time)
    if tracker._native is None:
        raise AssertionError("libhostio (the raw decoder's DC tracker) did "
                             "not build")
    print(f"[2] host DC tracker (libhostio) ready in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. each kernel vs its plain version on the card
    key = interop.key32_from_seed(5)
    err_yiq = kernel_cases_gen2(dev)
    err_yuv = kernel_cases_gen1(dev)
    check_pinned(dev)
    err_split = kernel_cases_split(dev, key)
    err_g1split = kernel_cases_gen1_split(dev)
    cases = timed_cases(dev)
    err_iir = kernel_cases_iir(cases)
    check_case_pins(cases)
    err_raw28 = kernel_cases_raw28(dev)
    s_calls = streams_calls(dev, key)
    check_streams(s_calls)
    p_calls = payload_calls(dev)
    check_payloads(p_calls)

    # ---- 4. the main paths through the CLI
    tmp = tempfile.mkdtemp(prefix="cvsim_smoke_")
    src = os.path.join(tmp, "bars.y4m")
    src8 = os.path.join(tmp, "bars8.y4m")
    dark = os.path.join(tmp, "dark.y4m")
    y_in, u_in, v_in = write_bars_y4m(src, 64)
    write_bars_y4m(src8, 8)
    write_dark_y4m(dark, 8)
    flags = ["-vhs-speed", "ep", "-vhs-head-switching", "1",
             "-chroma-noise", "16", "-chroma-phase-noise", "4",
             "-chroma-dropout", "4", "-seed", "7"]
    out_cpu = os.path.join(tmp, "out_cpu.y4m")
    outs = {}

    paths, streams_launches, payload_launches = {}, {}, 0
    for tool, kernel, extra, bar_limit in (
            # the VHS-EP chroma bandlimit alone moves the magenta bar's
            # mean U by 9-10 LSB in gen-2 (the CPU path shows the same)
            ("ntsc", "yiq_chain", [], 12.0),
            # gen-1's 8-bit composite clips the blue bar (low luma, high
            # chroma): the JAX package's CPU path moves its mean U by 25
            # LSB without VHS and 32 at VHS-EP, while a lost or swapped
            # decode moves the saturated bars' U/V by ~100
            ("to-composite", "yuv_chain", ["-vhs"], 40.0)):
        out = outs[tool] = os.path.join(tmp, f"out-{tool}.y4m")
        cli_s, counts, hdr, frames = run_cli(
            cli_main, {"kernel": kernel, "streams": "field_streams",
                       "payload": "y4m_payload"},
            ["--device", "cuda", tool, "-i", src, "-o", out, *extra, *flags])
        launches = counts["kernel"]
        n_fields = len(frames)
        gops = -(-n_fields // 64)
        print(f"[4] {tool} --device cuda: {n_fields} fields "
              f"({hdr.width}x{hdr.height}) in {cli_s:.3f} s, kernel "
              f"launches {launches}, field_streams launches "
              f"{counts['streams']} and y4m_payload launches "
              f"{counts['payload']} for {gops} GOPs")
        if n_fields != 128:
            raise AssertionError(f"{tool}: expected 128 output fields, "
                                 f"got {n_fields}")
        # the gen-2 render writes each GOP's payloads with one y4m_payload
        # launch; gen-1 has its own writer
        want_payload = gops if tool == "ntsc" else 0
        if (launches != gops or counts["streams"] != gops
                or counts["payload"] != want_payload):
            raise AssertionError(f"{tool}: launches {counts} != GOPs "
                                 f"{gops} (y4m_payload {want_payload})")
        worst = check_bars(frames, y_in, u_in, v_in, bar_limit)
        print(f"[4] {tool} colour bars kept: worst per-bar mean difference "
              f"{worst:.3f} LSB (limit {bar_limit})")
        rc = cli_main(["--device", "cpu", tool, "-i", src8, "-o", out_cpu,
                       *extra, *flags])
        if rc != 0:
            raise AssertionError(f"{tool} CPU CLI rc {rc}")
        cpu_err = compare_cli(frames, read_y4m(out_cpu)[1], 16, tool)
        print(f"[4] {tool} --device cuda vs --device cpu, first 16 fields: "
              f"max diff {cpu_err}; tolerance: {TOLERANCE}")
        paths[tool] = (launches, n_fields / cli_s)
        streams_launches[tool] = counts["streams"]
        payload_launches += counts["payload"]

    bkey = ["-vhs", "-bkey-feedback", "20", "-seed", "3"]
    _, bk_counts, _, frames = run_cli(
        cli_main, {"yuv_chain": "yuv_chain"},
        ["--device", "cuda", "to-composite", "-i", dark, "-o",
         os.path.join(tmp, "out-bkey.y4m"), *bkey])
    cli_main(["--device", "cpu", "to-composite", "-i", dark, "-o", out_cpu,
              *bkey])
    bk_err = compare_cli(frames, read_y4m(out_cpu)[1], 16, "bkey")
    print(f"[4] to-composite -bkey-feedback 20, 16 fields with keyed dark "
          f"rows: {bk_counts['yuv_chain']} launch, cuda vs cpu max diff "
          f"{bk_err}; tolerance: {TOLERANCE}")

    # the gen-1 split route (576i PAL fields are above the reference's
    # single-tile budget) and the debug-tap route (the stage path with its
    # pole cascades on fused_iir), each with every gen-1 launch count
    src_pal = os.path.join(tmp, "bars576.y4m")
    src_pal8 = os.path.join(tmp, "bars576-8.y4m")
    pal_in = write_bars_y4m(src_pal, 64, 720, 576)
    write_bars_y4m(src_pal8, 8, 720, 576)
    gen1_counters = {k: k for k in ("yuv_chain", "yuv_a", "yuv_b1",
                                    "yuv_b2", "fused_iir")}
    route_launches = {}
    for what, source, source8, extra, expect, bars in (
            ("to-composite -tvstd pal -vhs", src_pal, src_pal8,
             ["-tvstd", "pal", "-vhs"], GEN1_SPLIT_KERNELS, pal_in),
            # the tap drops the chroma subcarrier, so the bars lose colour
            ("to-composite -nocolor-subcarrier -vhs", src, src8,
             ["-nocolor-subcarrier", "-vhs"], ("fused_iir",), None)):
        out = os.path.join(tmp, f"out-{expect[0]}.y4m")
        cli_s, counts, hdr, frames = run_cli(
            cli_main, gen1_counters, ["--device", "cuda", "to-composite",
                                      "-i", source, "-o", out, *extra,
                                      *flags])
        gops = -(-len(frames) // 64)
        print(f"[4] {what} --device cuda: {len(frames)} fields "
              f"({hdr.width}x{hdr.height}) in {cli_s:.3f} s, {gops} GOPs, "
              f"kernel launches {counts}")
        for name, n in counts.items():
            if (n > 0) != (name in expect):
                raise AssertionError(f"{what}: launches {counts}, expected "
                                     f"launches of {expect} only")
        if expect == GEN1_SPLIT_KERNELS and any(counts[k] != gops
                                                for k in expect):
            raise AssertionError(f"{what}: split launches {counts} != GOPs "
                                 f"{gops}")
        if bars is None and len(frames) != 128:
            raise AssertionError(f"{what}: {len(frames)} fields, expected "
                                 "128")
        route_launches.update((k, counts[k]) for k in expect)
        if bars is not None:
            worst = check_bars(frames, *bars, 40.0)
            print(f"[4] {what} colour bars kept: worst per-bar mean "
                  f"difference {worst:.3f} LSB (limit 40.0)")
        rc = cli_main(["--device", "cpu", "to-composite", "-i", source8,
                       "-o", out_cpu, *extra, *flags])
        if rc != 0:
            raise AssertionError(f"{what} CPU CLI rc {rc}")
        frames_cpu = read_y4m(out_cpu)[1]
        err = compare_cli(frames, frames_cpu, None, what)
        print(f"[4] {what} --device cuda vs --device cpu, first "
              f"{len(frames_cpu)} fields: max diff {err}; tolerance: "
              f"{TOLERANCE}")

    # the audio paths: both tools' -audio-in beside their video, cassette,
    # and the chain on two 1M-sample chunks
    audio_cli_paths(cli_main, src, outs, flags, tmp)
    audio_chain_checks(dev)

    # the multi-device paths: -devices through the CLI (fields over the
    # cards), then the line-sharded program
    count = torch.cuda.device_count()
    runs = [1] + ([count] if count > 1 and 64 % count == 0 else [])
    for n in runs:
        for tool, kernel, extra in (("ntsc", "yiq_chain", []),
                                    ("to-composite", "yuv_chain", ["-vhs"])):
            out_n = os.path.join(tmp, f"out-{tool}-{n}.y4m")
            _, counts, _, _ = run_cli(
                cli_main, {"kernel": kernel},
                ["--device", "cuda", tool, "-i", src, "-o", out_n, *extra,
                 *flags, "-devices", str(n)])
            if not same_bytes(out_n, outs[tool]):
                raise AssertionError(f"{tool} -devices {n} output differs "
                                     "from the run without -devices")
            print(f"[4] {tool} -devices {n}: 128 fields byte-identical to the "
                  f"run without -devices; kernel launches {counts['kernel']}")
    for tool in ("ntsc", "to-composite"):
        rc, err = cli_fails(cli_main, ["--device", "cuda", tool, "-i", src,
                                       "-o", os.path.join(tmp, "x.y4m"),
                                       "-devices", str(count + 1)])
        if rc == 0 or f"only {count} CUDA device" not in err:
            raise AssertionError(f"{tool} -devices {count + 1}: rc {rc}, "
                                 f"stderr {err.strip()!r}")
        print(f"[4] {tool} -devices {count + 1}: exit {rc}, "
              f"{err.strip().splitlines()[-1]!r}")
    shapes = split_shapes(dev, key)
    split_launches = line_sharded_paths(shapes, key)

    # raw28ntsc (raw28_tails) and scanimate (plain torch)
    raw28_runs = raw28_cli_paths(cli_main, tmp)
    scan_runs = scanimate_cli_paths(cli_main, tmp)
    scanimate_field_effects(dev)

    # serve/-via with the kernels resident (#5 in the prime and
    # to-composite, #1 in ntsc), the host-only commands, the device twins,
    # and a CVSIM_PROFILE trace
    serve_walls = serve_paths(cli_main, src, outs, flags, tmp)
    host_tool_paths(cli_main, src8, tmp)
    device_twin_checks(dev)
    profile_check(cli_main, src8, flags, tmp)

    # ---- 5. times
    # every kernel vs its plain version on the cases of testing.timed_cases
    # (kernel_ab.py times the same); the first case of each kernel is its
    # row of the kernels line
    times, bounds, floors = {}, {}, {}
    for case in cases:
        ms, plain_ms, ms2 = (time_ms(case.kern), time_ms(case.plain),
                             time_ms(case.kern))
        rate = ("" if case.kernel == "fused_iir" else
                f" = {case.shape[0] / ms * 1e3:.1f} fields/s")
        rows = (f", {rows_a_cta(case)} rows a CTA"
                if case.kernel in PINNED_KERNELS else "")
        print(f"[5] {case.kernel} {case.label} on {card}: kernel {ms:.3f} ms "
              f"(again {ms2:.3f} ms){rate}{rows}; plain {plain_ms:.3f} ms")
        if case.kernel not in times:
            times[case.kernel] = (ms, plain_ms)
            bound, by, floor = case_bound(case)
            bounds[case.kernel], floors[case.kernel] = (bound, by), floor

    # field_streams at the benchmark's batch in both configurations; its
    # row of the kernels line is the first
    for label, kern, plain in s_calls:
        if not label.endswith("64 fields of 240x720"):
            continue
        ms, plain_ms, ms2 = time_ms(kern), time_ms(plain), time_ms(kern)
        b2b = time_ms(kern, calls=10)
        # a call's events span the wrapper's host work, which is longer
        # than the kernel: its device time is the profiler's
        act = device_activities(kern)
        if act is not None and act[0] != 1:
            raise AssertionError(f"field_streams {label}: device activities "
                                 f"{act}, expected one kernel")
        # without the profiler's events, the call's time bounds it above
        dev_ms = act[1] if act else ms
        n_bytes = streams_bytes(64, 240)
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        dev_s = (f"{dev_ms * 1e3:.1f} us (torch.profiler)" if act else
                 "not measured (torch.profiler recorded nothing)")
        print(f"[5] field_streams {label} on {card}: kernel on the card "
              f"{dev_s}; a call "
              f"{ms * 1e3:.1f} us (again {ms2 * 1e3:.1f} us; back to back "
              f"{b2b * 1e3:.1f} us: the wrapper's host work); plain "
              f"{plain_ms:.3f} ms = {plain_ms / ms:.0f}x a call; bound "
              f"{bound * 1e3:.4f} us (bytes: {n_bytes}) = "
              f"{bound / dev_ms:.1%}; the walk's serial chains set its time")
        if "field_streams" not in times:
            times["field_streams"] = (dev_ms, plain_ms)
            bounds["field_streams"] = (bound, "bytes")

    # y4m_payload at the render's GOP in both layouts against payloads_np
    # on the host (the per-field numpy work it took off the render); its
    # row of the kernels line is the first, 4:2:0, the benchmark's layout
    for label, kern, plain, n_bytes in p_calls:
        ms, ms2 = time_ms(kern), time_ms(kern)
        b2b = time_ms(kern, calls=10)
        plain_ms = wall_ms(plain)
        act = device_activities(kern)
        if act is not None and act[0] != 1:
            raise AssertionError(f"y4m_payload {label}: device activities "
                                 f"{act}, expected one kernel")
        # without the profiler's events, back-to-back calls bound it above
        dev_ms = act[1] if act else b2b
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        dev_s = (f"{dev_ms * 1e3:.1f} us (torch.profiler)" if act else
                 "not measured (torch.profiler recorded nothing)")
        print(f"[5] y4m_payload {label} on {card}: kernel on the card "
              f"{dev_s}; a call {ms * 1e3:.1f} us (again {ms2 * 1e3:.1f} "
              f"us; back to back {b2b * 1e3:.1f} us); payloads_np on the "
              f"host {plain_ms:.3f} ms = {plain_ms / dev_ms:.0f}x the "
              f"kernel; bound {bound * 1e3:.2f} us (bytes: {n_bytes}) = "
              f"{bound / dev_ms:.1%}")
        if "y4m_payload" not in times:
            times["y4m_payload"] = (dev_ms, plain_ms)
            bounds["y4m_payload"] = (bound, "bytes")

    # the line-sharded program vs kernel #1's path (prepare + kernel); both
    # paths include prepare()'s host work, so their events span it
    cfg = BENCH_VHS_EP
    for label, rgb2, fn2, par2, prep2 in shapes:
        nb = rgb2.shape[0]
        k1 = time_ms(lambda: fused_yiq.composite_layer_rgb_fused(
            rgb2, prep2, cfg=cfg))
        prog = time_ms(lambda: run_fused_lines_local(cfg, rgb2, fn2, par2,
                                                     key, sp=4))
        main1 = time_ms(lambda: yiq.composite_layer_rgb_auto(
            rgb2, fn2, par2, key, cfg=cfg))
        print(f"[5] {label} on {card}: yiq_chain kernel {k1:.3f} ms; "
              f"line-sharded program (4 shards, prepare included) "
              f"{prog:.3f} ms = {nb / prog * 1e3:.1f} fields/s; kernel #1's "
              f"path (prepare + yiq_chain) {main1:.3f} ms = "
              f"{nb / main1 * 1e3:.1f} fields/s")

    # the gen-1 split route vs yuv_chain on #5's 576i PAL and 1080i cases
    for case in cases:
        if case.kernel != "yuv_chain" or case.shape[1] == 240:
            continue
        split = partial(fused_yuv.composite_video_process_split,
                        *case.inputs, cfg=case.cfg)
        s1, m1, s2, m2 = (time_ms(split), time_ms(case.kern),
                          time_ms(split), time_ms(case.kern))
        print(f"[5] {case.label} on {card}: split route (yuv_a, head switch, "
              f"yuv_b1, blend, yuv_b2) {s1:.3f} / {s2:.3f} ms against "
              f"yuv_chain {m1:.3f} / {m2:.3f} ms (in turns: split, chain, "
              f"split, chain)")

    # the gen-1 black-key scan: 64 sequential steps of small eager ops, on
    # #5's 240x720 B=64 case
    gen1 = next(c for c in cases if c.kernel == "yuv_chain")
    b, l, w = gen1.shape
    planes = [p.to(torch.int32) for p in gen1.inputs[:3]]
    filt = (torch.full((l, w), 16, dtype=torch.int32, device=dev),
            torch.full((l, w // 2), 128, dtype=torch.int32, device=dev),
            torch.full((l, w // 2), 128, dtype=torch.int32, device=dev))
    scan = lambda: _bkey_scan(*planes, *filt, 20, [1] * b)
    scan_ms = time_ms(scan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"[5] black-key scan, one GOP of 64 fields 240x720 on {card}: "
          f"{scan_ms:.3f} ms (CUDA events), host enqueue {host_ms:.3f} ms")
    for tool, (_, rate) in paths.items():
        print(f"[5] {tool} CLI end to end on {card}: {rate:.2f} fields/s "
              f"(128 fields, 720x480, build excluded, start-up included)")
    print(f"[5] to-composite -vhs, 128 fields, on {card}: first served "
          f"command {serve_walls['to-composite']:.3f} s (python -S -m "
          f"cvsim_tpu_torch -via, a server primed in "
          f"{serve_walls['prime_s']:.3f} s) against a fresh process "
          f"{serve_walls['fresh']:.3f} s (interpreter, torch import, CUDA "
          f"context, kernels loaded from _build/); served ntsc "
          f"{serve_walls['ntsc']:.3f} s")

    audio_times(dev, card)
    r_ms, r_plain, r_bound, r_by = raw28_scanimate_times(
        dev, card, cli_main, raw28_runs, scan_runs, tmp)
    times["raw28_tails"] = (r_ms, r_plain)
    bounds["raw28_tails"] = (r_bound, r_by)

    # name: (source, TPU kernel it replaces, main-path launches, largest
    # difference against its plain version)
    table = {
        "yiq_chain": ("yiq_chain", "cvsim_tpu/models/fused_yiq.py:472",
                      paths["ntsc"][0], err_yiq),
        "yiq_a": ("yiq_chain", "cvsim_tpu/models/fused_yiq.py:346",
                  split_launches["yiq_a"], err_split["yiq_a"]),
        "yiq_b1": ("yiq_chain", "cvsim_tpu/models/fused_yiq.py:537",
                   split_launches["yiq_b1"], err_split["yiq_b1"]),
        "yiq_b2": ("yiq_chain", "cvsim_tpu/models/fused_yiq.py:557",
                   split_launches["yiq_b2"], err_split["yiq_b2"]),
        "yuv_chain": ("yuv_chain", "cvsim_tpu/models/fused_yuv.py:343",
                      paths["to-composite"][0], err_yuv),
        "yuv_a": ("yuv_chain", "cvsim_tpu/models/fused_yuv.py:220",
                  route_launches["yuv_a"], err_g1split["yuv_a"]),
        "yuv_b1": ("yuv_chain", "cvsim_tpu/models/fused_yuv.py:402",
                   route_launches["yuv_b1"], err_g1split["yuv_b1"]),
        "yuv_b2": ("yuv_chain", "cvsim_tpu/models/fused_yuv.py:422",
                   route_launches["yuv_b2"], err_g1split["yuv_b2"]),
        "fused_iir": ("fused_iir", "cvsim_tpu/ops/pallas/fused_iir.py:52",
                      route_launches["fused_iir"], err_iir),
        # no TPU twin: the JAX package runs this chain as a lax.scan
        "raw28_tails": ("raw28", "cvsim_tpu/models/raw28.py:283 (lax.scan, "
                        "no pallas_call)", raw28_runs["plain"][2], err_raw28),
        # no TPU twin: the JAX package builds the per-line inputs with XLA
        # ops around its Pallas kernels; [3] raises on any differing bit
        "field_streams": ("streams", "none (XLA ops in cvsim_tpu/models/"
                          "fused_yiq.py _fused_prepare)",
                          sum(streams_launches.values()), 0),
        # no TPU twin: the JAX package bobs and converts each field in
        # numpy on the host; [3] raises on any differing byte
        "y4m_payload": ("y4m_payload", "none (numpy on the host in "
                        "cvsim_tpu/host/pipeline_yiq.py _emit)",
                        payload_launches, 0),
    }
    for name, (ms, by) in bounds.items():
        if name not in floors:
            continue   # raw28_tails, field_streams, y4m_payload: no
            # blocked form; [5] printed them
        k_ms, fl = times[name][0], floors[name]
        print(f"[5] {name} bound {ms:.4f} ms ({by}); blocked-form floor "
              f"{fl:.4f} ms (block products' multiply-adds at "
              f"{FMA_PER_S:.3g}/s); kernel {k_ms:.3f} ms = {ms / k_ms:.1%} "
              f"of the bound, {k_ms / fl:.2f}x the floor")
    # library_ms: no single PyTorch call computes these IIR chains, the
    # raw decoder's carried line tails, the per-line inputs or the Y4M
    # payloads
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"cvsim_tpu_torch/csrc/{src_name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": times[name][0],
        "plain_ms": times[name][1],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": None,
    } for name, (src_name, replaces, launches, err) in table.items()]}))
    for name in ("jax", "cvsim_tpu"):
        if sys.modules.get(name) is not None:
            raise AssertionError(f"{name} was imported")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
