"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure raises, exit code != 0):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the CUDA kernels from cvsim_tpu_torch/csrc with nvcc;
  3. kernel vs its plain PyTorch version on the card, same prepared inputs,
     for every chain configuration of the port's tests at (2,32,128) and
     (1,16,176) and the bench's stochastic VHS-EP configuration at
     (8,240,704) and (2,540,1888); prepare() on the card == on the CPU;
  4. the main path: `python -m cvsim_tpu_torch ntsc` in-process on a
     720x480 colour-bar clip of 64 frames (128 fields, two GOPs) with the
     kernel launch count read around it; colour bars kept; the first 8
     frames again through `--device cpu`, compared within the chain
     tolerance;
  5. times: kernel vs plain at B=64, 240x704 (CUDA events, median of 5)
     and the CLI's end-to-end fields/s.
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


def read_y4m(path: str):
    from cvsim_tpu.host import y4m

    with open(path, "rb") as f:
        r = y4m.Y4MReader(f)
        return r.header, list(r)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from cvsim_tpu_torch import interop, kernels
    from cvsim_tpu_torch.cli.main import main as cli_main
    from cvsim_tpu_torch.models import fused_yiq
    from cvsim_tpu_torch.testing import (
        BENCH_VHS_EP, CHAIN_CONFIGS, assert_chain_equal, chain_diff)

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
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    # the CLI's frame scaler is a host C++ library built at first use
    # (g++, seconds); build it here so that the timed CLI run excludes it
    from cvsim_tpu.native.hostpix import scale_frame_to

    t0 = time.perf_counter()
    grey = np.full((8, 8), 128, np.uint8)
    scale_frame_to(grey, grey[::2, ::2], grey[::2, ::2], 8, 8)
    print(f"[2] host frame scaler ready in {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernel vs plain on the card
    key = interop.key32_from_seed(5)
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
        print(f"[3] {name} {(b, l, w)}: kernel vs plain max {dmax}, "
              f"frac {frac:.2e}")
        assert_chain_equal(got, want, err_msg=f"{name} {(b, l, w)}")
        cpu = fused_yiq.prepare(cfg, torch.from_numpy(rgb_np), fn, par, key)
        for field in ("xi", "keys_ab", "keep", "shifts"):
            a = getattr(prep, field).cpu()
            if not torch.equal(a, getattr(cpu, field)):
                raise AssertionError(f"prepare {field}: cuda != cpu ({name})")
    print(f"[3] prepare() on the card == on the CPU for xi, keys_ab, keep, "
          f"shifts in all {len(cases)} cases; tolerance: {TOLERANCE}")

    # ---- 4. the main path through the CLI
    tmp = tempfile.mkdtemp(prefix="cvsim_smoke_")
    src = os.path.join(tmp, "bars.y4m")
    src8 = os.path.join(tmp, "bars8.y4m")
    out = os.path.join(tmp, "out.y4m")
    out_cpu = os.path.join(tmp, "out_cpu.y4m")
    y_in, u_in, v_in = write_bars_y4m(src, 64)
    write_bars_y4m(src8, 8)
    flags = ["-vhs-speed", "ep", "-vhs-head-switching", "1",
             "-chroma-noise", "16", "-chroma-phase-noise", "4",
             "-chroma-dropout", "4", "-seed", "7"]
    fused_yiq.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli_main(["--device", "cuda", "ntsc", "-i", src, "-o", out, *flags])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = fused_yiq.KERNEL_LAUNCHES
    if rc != 0:
        raise AssertionError(f"CLI rc {rc}")
    hdr, frames = read_y4m(out)
    n_fields = len(frames)
    gops = -(-n_fields // 64)
    print(f"[4] CLI --device cuda: rc {rc}, {n_fields} fields "
          f"({hdr.width}x{hdr.height}) in {cli_s:.3f} s, kernel launches "
          f"{launches} for {gops} GOPs")
    if n_fields != 128:
        raise AssertionError(f"expected 128 output fields, got {n_fields}")
    if launches != gops:
        raise AssertionError(f"kernel launches {launches} != GOPs {gops}")

    # bar hues kept: per-bar interior means near the input's. The VHS-EP
    # chroma bandlimit alone moves the magenta bar's mean U by 9-10 LSB
    # (the CPU path shows the same), so the limit is 12
    bar_limit = 12.0
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
                if d > bar_limit:
                    raise AssertionError(f"bar {k} {name}: mean off by {d:.2f}")
    print(f"[4] colour bars kept: worst per-bar mean difference "
          f"{worst:.3f} LSB (limit {bar_limit})")

    rc = cli_main(["--device", "cpu", "ntsc", "-i", src8, "-o", out_cpu,
                   *flags])
    if rc != 0:
        raise AssertionError(f"CPU CLI rc {rc}")
    _, frames_cpu = read_y4m(out_cpu)
    if len(frames_cpu) != 16:
        raise AssertionError(f"CPU run: {len(frames_cpu)} fields, expected 16")
    cpu_err = 0
    for k, (fc, fg) in enumerate(zip(frames_cpu, frames)):
        for pc, pg in zip(fc, fg):
            cpu_err = max(cpu_err, chain_diff(pc, pg)[0])
            assert_chain_equal(pg, pc, err_msg=f"cuda vs cpu field {k}")
    print(f"[4] CLI --device cuda vs --device cpu, first 16 fields: max "
          f"diff {cpu_err}; tolerance: {TOLERANCE}")

    # ---- 5. times
    b, l, w = 64, 240, 704
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(
        rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8)).to(dev)
    fn = torch.arange(b, dtype=torch.int32)
    prep = fused_yiq.prepare(BENCH_VHS_EP, rgb, fn, fn % 2, key)
    ms = time_ms(lambda: fused_yiq.composite_layer_rgb_fused(
        rgb, prep, cfg=BENCH_VHS_EP))
    plain_ms = time_ms(lambda: fused_yiq.chain_reference(
        rgb, prep, cfg=BENCH_VHS_EP))
    ms2 = time_ms(lambda: fused_yiq.composite_layer_rgb_fused(
        rgb, prep, cfg=BENCH_VHS_EP))
    print(f"[5] B=64 240x704 bench VHS-EP on {card}: kernel {ms:.3f} ms "
          f"(again {ms2:.3f} ms) = {b / ms * 1e3:.1f} fields/s; plain "
          f"{plain_ms:.3f} ms = {b / plain_ms * 1e3:.1f} fields/s")
    print(f"[5] CLI end to end on {card}: {n_fields / cli_s:.2f} fields/s "
          f"({n_fields} fields, 720x480, build excluded, start-up included)")

    print(json.dumps({"kernels": [{
        "name": "yiq_chain",
        "route": "cuda",
        "source": "cvsim_tpu_torch/csrc/yiq_chain.cu",
        "replaces": "cvsim_tpu/models/fused_yiq.py:472",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("jax was imported")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
