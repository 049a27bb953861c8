"""Bits and times of one tree's CUDA kernels, for comparing two trees on
one card.

    python3 kernel_ab.py [--root DIR] [--rows-per-cta R] [--lines | --raw28]

Builds the kernels of the tree at DIR (default: this checkout), prints the
CRC32 of kernels #1 and #5 on every case of testing.PINNED_CHAIN_CRC32 and
of the multi-row kernels (#2, #3, #4, #9, #6, #7, #8) on every case of
testing.PINNED_CASE_CRC32, and whether each equals the pinned value, then
times every kernel on the cases of
testing.timed_cases, the ones chip_smoke.py [5] times (testing.time_ms:
CUDA events, median of 5 after two warm-ups), once a call and once over
10 calls back to back (the device time without the wrapper's host work).
The inputs, the pinned values and the timing come from this checkout's
testing.py, so two trees (say a parent unpacked with `git archive` into
an ignored directory, and this one) get the same inputs; run them in
turns within one call, parent, change, change, parent. --rows-per-cta sets
the library's cvsim_rows_per_cta_override, so that every multi-row kernel
of the tree takes R rows a CTA. A run that builds prints ptxas's register
and spill lines. The last line is one JSON object {"root", "card",
"rows_per_cta", "crc32", "pinned_equal", "ms", "ms_back_to_back"}. Needs
one card; exits 1 without one, and 1 if a CRC32 differs from its pin.

--lines times the line-sharded program (kernels #2-#4 on row shards,
prepare() included: parallel.run_fused_lines_local and
run_sharded_chain_fused_lines) in place of the kernels: at 240x704 B=64
and 540x1888 B=16 of testing.BENCH_VHS_EP (testing.chain_inputs), 4 row
shards on card 0 and one shard on each visible card, beside kernel #1's
path (prepare() and kernel #1), each output held to kernel #1's with
assert_chain_equal (a difference raises). Its last line is {"root",
"card", "cards", "ms"}.

--raw28 times the raw decoder's line-tail kernel (raw28_tails) in place
of the others: on one field (262 lines of 1820 samples) of each of
testing.raw28_capture and testing.raw28_capture_jittery and on a random
field with a random carry, each first held exactly to the tree's plain
loop (tail_chain_reference; a difference raises). Its last line is
{"root", "card", "ms", "ms_back_to_back"}.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _testing():
    """This checkout's testing.py, run against the package at --root (it
    uses only modules that every tree of the port has)."""
    spec = importlib.util.spec_from_file_location(
        "cvsim_ab_testing",
        os.path.join(HERE, "cvsim_tpu_torch", "testing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows-per-cta", type=int, default=0,
                    help="rows a CTA of the multi-row kernels (0: their own "
                    "choice)")
    ap.add_argument("--lines", action="store_true",
                    help="time the line-sharded program instead")
    ap.add_argument("--raw28", action="store_true",
                    help="time the raw decoder's raw28_tails instead")
    args = ap.parse_args()
    sys.modules["jax"] = None
    sys.modules["cvsim_tpu"] = None
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from cvsim_tpu_torch import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lib = kernels.load()
    ctypes.c_int.in_dll(lib, "cvsim_rows_per_cta_override").value = (
        args.rows_per_cta)
    if kernels.BUILD_LOG:   # built in this process
        for line in kernels.BUILD_LOG.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "Function properties")):
                print(f"    ptxas: {line.strip()}")
    print(f"kernel_ab: {root} on {card}, rows a CTA "
          f"{args.rows_per_cta or 'chosen by each kernel'}")
    T = _testing()
    if args.raw28:
        ms, b2b = raw28_ms(T, dev)
        print(json.dumps({"root": root, "card": card, "ms": ms,
                          "ms_back_to_back": b2b}))
        return 0
    if args.lines:
        ms = lines_ms(T, dev)
        print(json.dumps({"root": root, "card": card,
                          "cards": torch.cuda.device_count(), "ms": ms}))
        return 0
    crcs, equal = {}, True
    for (kernel, name, shape), pinned in T.PINNED_CHAIN_CRC32.items():
        cfg = T.BENCH_CONFIGS[name]
        planes, prep = T.chain_inputs(kernel, name, cfg, shape, dev)
        crc = T.chain_crc32(kernel, cfg, planes, prep)
        crcs[f"{kernel} {name} {shape}"] = crc
        equal &= crc == pinned
        print(f"{kernel} {name} {shape}: crc32 {crc:#010x} (pinned "
              f"{pinned:#010x})")
    ms, b2b = {}, {}
    for case in T.timed_cases(dev):
        label = f"{case.kernel} {case.label}"
        if case.kernel in T.PINNED_KERNELS:
            crc = crcs[label] = T.case_crc32(case)
            pinned = T.PINNED_CASE_CRC32.get(label)
            equal &= crc == pinned
            print(f"{label}: crc32 {crc:#010x} (pinned "
                  f"{'none' if pinned is None else f'{pinned:#010x}'})")
        ms[label] = T.time_ms(case.kern)
        b2b[label] = T.time_ms(case.kern, calls=10)
        print(f"{label}: {ms[label]:.3f} ms, back to back "
              f"{b2b[label]:.3f} ms")
    print(json.dumps({"root": root, "card": card,
                      "rows_per_cta": args.rows_per_cta, "crc32": crcs,
                      "pinned_equal": equal, "ms": ms,
                      "ms_back_to_back": b2b}))
    return 0 if equal else 1


def lines_ms(T, dev) -> dict:
    """--lines: {label: CUDA-event ms} of the line-sharded program and of
    kernel #1's path, each checked against kernel #1's output first."""
    import torch

    from cvsim_tpu_torch.interop import key32_from_seed
    from cvsim_tpu_torch.models import fused_yiq, yiq
    from cvsim_tpu_torch.parallel import (make_mesh, run_fused_lines_local,
                                          run_sharded_chain_fused_lines)

    cfg, key = T.BENCH_VHS_EP, key32_from_seed(5)
    count = torch.cuda.device_count()
    mesh = make_mesh(count, "cuda", dp=1)
    ms = {}
    for b, l, w in ((64, 240, 704), (16, 540, 1888)):
        (rgb,), prep = T.chain_inputs("yiq_chain", "time", cfg, (b, l, w),
                                      dev)
        fn = torch.arange(b, dtype=torch.int32, device=dev) + 3
        want = fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
        runs = {"4 shards on one card": lambda: run_fused_lines_local(
            cfg, rgb, fn, fn % 2, key, sp=4)}
        if l % count == 0:
            runs[f"one shard on each of {count} card(s)"] = (
                lambda: run_sharded_chain_fused_lines(mesh, cfg, rgb, fn,
                                                      fn % 2, key))
        runs["kernel #1's path"] = lambda: yiq.composite_layer_rgb_auto(
            rgb, fn, fn % 2, key, cfg=cfg)
        for what, run in runs.items():
            label = f"{l}x{w} B={b} {what}"
            T.assert_chain_equal(run().cpu().numpy(), want.cpu().numpy(),
                                 err_msg=label)
            ms[label] = T.time_ms(run)
            print(f"{label}: {ms[label]:.3f} ms = "
                  f"{b / ms[label] * 1e3:.1f} fields/s")
    return ms


def raw28_ms(T, dev) -> tuple[dict, dict]:
    """--raw28: ({label: CUDA-event ms}, {label: ms back to back}) of
    raw28_tails, each case checked against the plain loop first."""
    import numpy as np
    import torch

    from cvsim_tpu_torch.models import raw28

    rl = raw28.RawTiming(raw28.rate_preset("ntsc28")).raw_length
    lut = torch.from_numpy(raw28.equalize_lut(T.RAW28_BLANK,
                                              T.RAW28_WHITE)).to(dev)
    idx = 6 * rl + np.arange(262)[:, None] * rl + np.arange(rl + 24)[None, :]
    rng = np.random.default_rng(28)
    fields = {"capture": T.raw28_capture(1, rl),
              "jittery capture": T.raw28_capture_jittery(1, rl),
              "random": rng.integers(0, 256, 262 * rl + 6 * rl + 24)
              .astype(np.uint8)}
    ms, b2b = {}, {}
    for label, cap in fields.items():
        lines = torch.from_numpy(cap[np.minimum(idx, len(cap) - 1)]).to(dev)
        c3t, st = raw28.tail_inputs(*raw28.split_lines(
            torch.take(lut, lines.long()), rl))
        carry = torch.from_numpy(rng.integers(-300, 300, 16)
                                 .astype(np.int32)).to(dev)
        for g, w in zip(raw28.raw28_tails(c3t, st, carry),
                        raw28.tail_chain_reference(c3t, st, carry)):
            if not torch.equal(g, w):
                raise AssertionError(f"raw28_tails {label}: kernel != plain "
                                     "loop")
        kern = lambda: raw28.raw28_tails(c3t, st, carry)
        ms[label] = T.time_ms(kern)
        b2b[label] = T.time_ms(kern, calls=10)
        print(f"raw28_tails {label}, 262 lines: {ms[label] * 1e3:.1f} us, "
              f"back to back {b2b[label] * 1e3:.1f} us (== plain loop)")
    return ms, b2b


if __name__ == "__main__":
    raise SystemExit(main())
