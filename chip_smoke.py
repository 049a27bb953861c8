"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (or more).

    python3 chip_smoke.py

Phases, each printing its own lines (any failure raises, exit code != 0):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the CUDA kernels from cvsim_tpu_torch/csrc with nvcc;
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
     shards; prepare() on the card == on the CPU for all;
  4. the main paths, each with its kernels' launch counts set to 0 just
     before and read just after: `python -m cvsim_tpu_torch ntsc` and
     `python -m cvsim_tpu_torch to-composite` in-process on a 720x480
     colour-bar clip of 64 frames (128 fields, two GOPs); colour bars
     kept; the first 8 frames again through `--device cpu`, compared
     within the chain tolerance; then a short `to-composite
     -bkey-feedback 20` run on a clip with dark, keyed rows, cuda vs cpu;
     then the multi-device paths: both tools with `-devices 1`, byte-
     identical to the runs without it; `-devices <count+1>` fails and names
     the count; the line-sharded program (4 row shards on one card, and
     over every card) at 240x704 B=64 and 540x1888 B=16 against kernel #1;
     with more than one card, both tools with `-devices <count>`;
  5. times: each kernel vs its plain version at B=64 (240x704 gen-2,
     240x720 gen-1; the split kernels also at 540x1888 B=16; CUDA events,
     median of 5), the split program vs kernel #1's path, the gen-1
     black-key scan's host cost per GOP, and each CLI's end-to-end
     fields/s.
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

sys.modules["jax"] = None   # the port must never import jax

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# chain tolerance (cvsim_tpu_torch.testing.assert_chain_equal): at most
# 1 LSB on at most 0.1% of samples
TOLERANCE = "max |diff| <= 1 LSB on <= 0.1% of samples"


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

    from cvsim_tpu.host import y4m
    from cvsim_tpu.host.colorconv import rgb_to_yuv601_np

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

    from cvsim_tpu.host import y4m

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
    from cvsim_tpu.host import y4m

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


def compare_cli(frames_gpu, frames_cpu, n_fields: int, what: str) -> int:
    """CUDA CLI output vs CPU CLI output, frame by frame, within the chain
    tolerance; returns the largest difference."""
    from cvsim_tpu_torch.testing import assert_chain_equal, chain_diff

    if len(frames_cpu) != n_fields:
        raise AssertionError(f"{what} CPU run: {len(frames_cpu)} fields, "
                             f"expected {n_fields}")
    err = 0
    for k, (fc, fg) in enumerate(zip(frames_cpu, frames_gpu)):
        for pc, pg in zip(fc, fg):
            err = max(err, chain_diff(pc, pg)[0])
            assert_chain_equal(pg, pc, err_msg=f"{what} cuda vs cpu field {k}")
    return err


def time_ms(fn, reps: int = 5):
    """Median of `reps` CUDA-event timings of fn() (after two warm-ups)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def check_prepare(prep, prepare_cpu, what: str):
    import torch

    cpu = prepare_cpu()
    for field in ("xi", "keys_ab", "keep", "shifts"):
        if not torch.equal(getattr(prep, field).cpu(), getattr(cpu, field)):
            raise AssertionError(f"prepare {field}: cuda != cpu ({what})")


def kernel_cases_gen2(dev, key) -> int:
    """[3] yiq_chain vs fused_yiq.chain_reference; returns the largest
    difference."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import fused_yiq
    from cvsim_tpu_torch.testing import (
        BENCH_VHS_EP, CHAIN_CONFIGS, assert_chain_equal, chain_diff)

    cases = [(n, c, s) for n, c in sorted(CHAIN_CONFIGS.items())
             for s in ((2, 32, 128), (1, 16, 176))]
    cases += [("bench-vhs-ep", BENCH_VHS_EP, s)
              for s in ((8, 240, 704), (2, 540, 1888))]
    max_err = 0
    for name, cfg, (b, l, w) in cases:
        rng = np.random.default_rng(zlib.crc32(f"{name}{b}{l}{w}".encode()))
        rgb_np = rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8)
        rgb = torch.from_numpy(rgb_np).to(dev)
        fn = torch.arange(b, dtype=torch.int32) + 3
        par = fn % 2
        prep = fused_yiq.prepare(cfg, rgb, fn, par, key)
        got = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
        torch.cuda.synchronize()
        want = fused_yiq.chain_reference(rgb, prep, cfg=cfg)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        dmax, frac = chain_diff(got, want)
        max_err = max(max_err, dmax)
        print(f"[3] yiq_chain {name} {(b, l, w)}: kernel vs plain max {dmax}, "
              f"frac {frac:.2e}")
        assert_chain_equal(got, want, err_msg=f"{name} {(b, l, w)}")
        check_prepare(prep, lambda: fused_yiq.prepare(
            cfg, torch.from_numpy(rgb_np), fn, par, key), name)
    print(f"[3] yiq_chain: prepare() on the card == on the CPU for xi, "
          f"keys_ab, keep, shifts in all {len(cases)} cases; tolerance: "
          f"{TOLERANCE}")
    return max_err


def kernel_cases_gen1(dev, key) -> int:
    """[3] yuv_chain vs fused_yuv.chain_reference; returns the largest
    difference over the three planes."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import fused_yuv
    from cvsim_tpu_torch.testing import (
        BENCH_GEN1_EP, GEN1_CHAIN_CONFIGS, assert_chain_equal, chain_diff)

    cases = [(n, c, s) for n, c in sorted(GEN1_CHAIN_CONFIGS.items())
             for s in ((2, 32, 128), (1, 16, 176))]
    cases += [("bench-gen1-ep", BENCH_GEN1_EP, (8, 240, 720)),
              ("bench-gen1-ep-pal", BENCH_GEN1_EP.with_(ntsc=False),
               (8, 288, 720)),
              ("bench-gen1-ep", BENCH_GEN1_EP, (2, 540, 1888))]
    max_err = 0
    for name, cfg, (b, l, w) in cases:
        rng = np.random.default_rng(zlib.crc32(f"g1{name}{b}{l}{w}".encode()))
        planes_np = [rng.integers(0, 256, s).astype(np.uint8)
                     for s in ((b, l, w), (b, l, w // 2), (b, l, w // 2))]
        y, u, v = (torch.from_numpy(p).to(dev) for p in planes_np)
        fn = torch.arange(b, dtype=torch.int32) + 3
        par = fn % 2
        prep = fused_yuv.prepare(cfg, y, fn, par, key)
        got = fused_yuv.composite_video_process_fused(y, u, v, prep, cfg=cfg)
        torch.cuda.synchronize()
        want = fused_yuv.chain_reference(y, u, v, prep, cfg=cfg)
        diffs = []
        for k, (g, wnt) in enumerate(zip(got, want)):
            g, wnt = g.cpu().numpy(), wnt.cpu().numpy()
            diffs.append(chain_diff(g, wnt))
            assert_chain_equal(g, wnt, err_msg=f"{name} {(b, l, w)} plane {k}")
        dmax = max(d for d, _ in diffs)
        max_err = max(max_err, dmax)
        print(f"[3] yuv_chain {name} {(b, l, w)}: kernel vs plain max {dmax}, "
              f"frac y/u/v {' '.join(f'{f:.2e}' for _, f in diffs)}")
        check_prepare(prep, lambda: fused_yuv.prepare(
            cfg, torch.from_numpy(planes_np[0]), fn, par, key), name)
    print(f"[3] yuv_chain: prepare() on the card == on the CPU for xi, "
          f"keys_ab, keep, shifts in all {len(cases)} cases; tolerance: "
          f"{TOLERANCE}")
    return max_err


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


def run_cli(cli_main, module, args):
    """One in-process CLI run with `module`'s launch count set to 0 just
    before it; returns (seconds, launches, header, frames)."""
    import torch

    module.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli_main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = module.KERNEL_LAUNCHES
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
    fused_yiq.A_LAUNCHES = fused_yiq.B1_LAUNCHES = fused_yiq.B2_LAUNCHES = 0
    results = []
    for (label, rgb, fn, par, _), ref in zip(shapes, want):
        got = run_fused_lines_local(BENCH_VHS_EP, rgb, fn, par, key, sp=4)
        results.append((f"{label} sp=4 on one card", got, ref))
        if rgb.shape[1] % count == 0:
            got = run_sharded_chain_fused_lines(mesh, BENCH_VHS_EP, rgb, fn,
                                                par, key)
            results.append((f"{label} over {count} card(s)", got, ref))
    torch.cuda.synchronize()
    launches = {"yiq_a": fused_yiq.A_LAUNCHES,
                "yiq_b1": fused_yiq.B1_LAUNCHES,
                "yiq_b2": fused_yiq.B2_LAUNCHES}
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
    from cvsim_tpu_torch.parallel import run_fused_lines_local
    from cvsim_tpu_torch.testing import BENCH_GEN1_EP, BENCH_VHS_EP

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
    from cvsim_tpu.native.hostpix import scale_frame_to

    t0 = time.perf_counter()
    grey = np.full((8, 8), 128, np.uint8)
    scale_frame_to(grey, grey[::2, ::2], grey[::2, ::2], 8, 8)
    print(f"[2] host frame scaler ready in {time.perf_counter() - t0:.2f} s")

    # ---- 3. each kernel vs its plain version on the card
    key = interop.key32_from_seed(5)
    err_yiq = kernel_cases_gen2(dev, key)
    err_yuv = kernel_cases_gen1(dev, key)
    err_split = kernel_cases_split(dev, key)

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

    paths = {}
    for tool, module, extra, bar_limit in (
            # the VHS-EP chroma bandlimit alone moves the magenta bar's
            # mean U by 9-10 LSB in gen-2 (the CPU path shows the same)
            ("ntsc", fused_yiq, [], 12.0),
            # gen-1's 8-bit composite clips the blue bar (low luma, high
            # chroma): the JAX package's CPU path moves its mean U by 25
            # LSB without VHS and 32 at VHS-EP, while a lost or swapped
            # decode moves the saturated bars' U/V by ~100
            ("to-composite", fused_yuv, ["-vhs"], 40.0)):
        out = outs[tool] = os.path.join(tmp, f"out-{tool}.y4m")
        cli_s, launches, hdr, frames = run_cli(
            cli_main, module,
            ["--device", "cuda", tool, "-i", src, "-o", out, *extra, *flags])
        n_fields = len(frames)
        gops = -(-n_fields // 64)
        print(f"[4] {tool} --device cuda: {n_fields} fields "
              f"({hdr.width}x{hdr.height}) in {cli_s:.3f} s, kernel "
              f"launches {launches} for {gops} GOPs")
        if n_fields != 128:
            raise AssertionError(f"{tool}: expected 128 output fields, "
                                 f"got {n_fields}")
        if launches != gops:
            raise AssertionError(f"{tool}: kernel launches {launches} != "
                                 f"GOPs {gops}")
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

    bkey = ["-vhs", "-bkey-feedback", "20", "-seed", "3"]
    _, bk_launches, _, frames = run_cli(
        cli_main, fused_yuv,
        ["--device", "cuda", "to-composite", "-i", dark, "-o",
         os.path.join(tmp, "out-bkey.y4m"), *bkey])
    cli_main(["--device", "cpu", "to-composite", "-i", dark, "-o", out_cpu,
              *bkey])
    bk_err = compare_cli(frames, read_y4m(out_cpu)[1], 16, "bkey")
    print(f"[4] to-composite -bkey-feedback 20, 16 fields with keyed dark "
          f"rows: {bk_launches} launch, cuda vs cpu max diff {bk_err}; "
          f"tolerance: {TOLERANCE}")

    # the multi-device paths: -devices through the CLI (fields over the
    # cards), then the line-sharded program
    count = torch.cuda.device_count()
    runs = [1] + ([count] if count > 1 and 64 % count == 0 else [])
    for n in runs:
        for tool, module, extra in (("ntsc", fused_yiq, []),
                                    ("to-composite", fused_yuv, ["-vhs"])):
            out_n = os.path.join(tmp, f"out-{tool}-{n}.y4m")
            _, launches, _, _ = run_cli(
                cli_main, module, ["--device", "cuda", tool, "-i", src, "-o",
                                   out_n, *extra, *flags, "-devices", str(n)])
            if not same_bytes(out_n, outs[tool]):
                raise AssertionError(f"{tool} -devices {n} output differs "
                                     "from the run without -devices")
            print(f"[4] {tool} -devices {n}: 128 fields byte-identical to the "
                  f"run without -devices; kernel launches {launches}")
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

    # ---- 5. times
    times = {}
    rng = np.random.default_rng(0)
    b, l, w = 64, 240, 704
    rgb = torch.from_numpy(
        rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8)).to(dev)
    fn = torch.arange(b, dtype=torch.int32)
    prep = fused_yiq.prepare(BENCH_VHS_EP, rgb, fn, fn % 2, key)
    kern = lambda: fused_yiq.composite_layer_rgb_fused(rgb, prep,
                                                       cfg=BENCH_VHS_EP)
    plain = lambda: fused_yiq.chain_reference(rgb, prep, cfg=BENCH_VHS_EP)
    times["yiq_chain"] = (time_ms(kern), time_ms(plain), time_ms(kern))

    w = 720
    y, u, v = (torch.from_numpy(rng.integers(16, 236, s).astype(np.uint8))
               .to(dev) for s in ((b, l, w), (b, l, w // 2), (b, l, w // 2)))
    prep1 = fused_yuv.prepare(BENCH_GEN1_EP, y, fn, fn % 2, key)
    kern = lambda: fused_yuv.composite_video_process_fused(
        y, u, v, prep1, cfg=BENCH_GEN1_EP)
    plain = lambda: fused_yuv.chain_reference(y, u, v, prep1,
                                              cfg=BENCH_GEN1_EP)
    times["yuv_chain"] = (time_ms(kern), time_ms(plain), time_ms(kern))
    for name, shape, (ms, plain_ms, ms2) in (
            ("yiq_chain", "240x704 bench VHS-EP", times["yiq_chain"]),
            ("yuv_chain", "240x720 gen-1 bench VHS-EP", times["yuv_chain"])):
        print(f"[5] {name} B=64 {shape} on {card}: kernel {ms:.3f} ms "
              f"(again {ms2:.3f} ms) = {b / ms * 1e3:.1f} fields/s; plain "
              f"{plain_ms:.3f} ms = {b / plain_ms * 1e3:.1f} fields/s")

    # the split kernels on whole fields vs their plain versions, and the
    # line-sharded program vs kernel #1's path (prepare + kernel); both
    # paths include prepare()'s host work, so their events span it
    cfg = BENCH_VHS_EP
    for label, rgb2, fn2, par2, prep2 in shapes:
        w2 = rgb2.shape[2]
        ya = fused_yiq.stage_a(rgb2, prep2, cfg=cfg)
        yh = fused_yiq.head_switch_rows(ya, prep2.shifts, w2)
        p1 = fused_yiq.stage_b1(yh, prep2, cfg=cfg, w=w2)
        t = {"yiq_a": (lambda: fused_yiq.stage_a(rgb2, prep2, cfg=cfg),
                       lambda: fused_yiq.stage_a_reference(rgb2, prep2,
                                                           cfg=cfg)),
             "yiq_b1": (lambda: fused_yiq.stage_b1(yh, prep2, cfg=cfg, w=w2),
                        lambda: fused_yiq.stage_b1_reference(
                            yh, prep2, cfg=cfg, w=w2)),
             "yiq_b2": (lambda: fused_yiq.stage_b2(*p1, prep2, cfg=cfg, w=w2),
                        lambda: fused_yiq.stage_b2_reference(
                            *p1, prep2, cfg=cfg, w=w2))}
        nb = rgb2.shape[0]
        for name, (kern, plain) in t.items():
            ms, plain_ms = time_ms(kern), time_ms(plain)
            if label.startswith("240x704"):
                times[name] = (ms, plain_ms)
            print(f"[5] {name} {label} bench VHS-EP on {card}: kernel "
                  f"{ms:.3f} ms = {nb / ms * 1e3:.1f} fields/s; plain "
                  f"{plain_ms:.3f} ms = {nb / plain_ms * 1e3:.1f} fields/s")
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

    # the gen-1 black-key scan: 64 sequential steps of small eager ops
    planes = [p.to(torch.int32) for p in (y, u, v)]
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

    rows = [("yiq_chain", "yiq_chain", "cvsim_tpu/models/fused_yiq.py:472",
             paths["ntsc"][0], err_yiq),
            ("yuv_chain", "yuv_chain", "cvsim_tpu/models/fused_yuv.py:343",
             paths["to-composite"][0], err_yuv)]
    rows += [(name, "yiq_chain", f"cvsim_tpu/models/fused_yiq.py:{line}",
              split_launches[name], err_split[name])
             for name, line in zip(SPLIT_KERNELS, (346, 537, 557))]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"cvsim_tpu_torch/csrc/{src_name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": times[name][0],
        "plain_ms": times[name][1],
    } for name, src_name, replaces, launches, err in rows]}))
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("jax was imported")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
