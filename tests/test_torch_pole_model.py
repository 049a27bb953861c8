"""The multi-row pole primitives of csrc/pole.cuh (pole_rows, pole3_rows)
and the multi-row noise walk of csrc/noise.cuh (add_walk_rows, gen-2 and
u8-masked gen-1), which kernels #2 (yiq_a), #3 (yiq_b1), #4 (yiq_b2),
#9 (fused_iir), #6 (yuv_a), #7 (yuv_b1) and #8 (yuv_b2) run, against the
one-row forms that every other kernel runs, bit for bit, on the CPU.

There is no CUDA compiler here, so tests/pole_model.cpp compiles the two
headers with g++ under a shim (128 std::threads for a CTA, barriers for
__syncthreads/__syncwarp) and runs ROWS random rows, each with its own
reset value (or noise stream), through the one-row form and through the
multi-row form R rows a CTA, the last CTA holding fewer; pole and pole3
are also held against a plain sequential loop with the same operation
order. The same build holds pole.cuh's rows_per_cta_of, the rows a CTA
that the multi-row kernels choose per width, as #3 and #9 call it (rows
of 5 or 3 planes) and as #7 and #8 call it (a gen-1 row of 3 luma and 3
half-width chroma planes), at an H100 SM's shared memory. Built beside a
copy of csrc/yuv_chain.cu, the model runs kernels #6, #7 and #8 whole,
through their C entry points, on the inputs the port's CPU path prepares;
built beside a copy of csrc/yiq_chain.cu, kernels #2, #3 and #4, on
whole fields and on a row shard. The multi-row instance at several rows
a CTA gives the bytes of the one-row instance, and the one-row instance
agrees with the plain PyTorch version (assert_chain_equal). Skips
without g++.
"""

import os
import re
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from cvsim_tpu_torch.config import CompositeConfig
from cvsim_tpu_torch.interop import key32_from_seed
from cvsim_tpu_torch.models import fused_yiq, fused_yuv
from cvsim_tpu_torch.models.chain_prep import u32_as_i32
from cvsim_tpu_torch.testing import (BENCH_CONFIGS, CHAIN_CONFIGS,
                                     GEN1_CHAIN_CONFIGS, assert_chain_equal)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, os.pardir, "cvsim_tpu_torch", "csrc")


def _build(out_dir, *flags):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU model of pole.cuh")
    exe = str(out_dir / "pole_model")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-pthread", *flags, "-I", CSRC,
                    os.path.join(HERE, "pole_model.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


@pytest.fixture(scope="module")
def pole_model(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("pole_model"))


def _kernels_model(d, source, flag):
    """The model with the kernels of csrc/<source>, each launch rewritten
    to run its CTAs one after another on the model's threads."""
    with open(os.path.join(CSRC, source)) as f:
        src = f.read().replace("#include <cuda_runtime.h>\n", "")
    src, launches = re.subn(r"(\w+)<<<(.*?),.*?>>>\((.*?)\);",
                            r"cvsim_launch(\2, [&] { \1(\3); });", src,
                            flags=re.S)
    # yuv_chain.cu: #5's two, #6, #7, #8; yiq_chain.cu: #1's two, #2-#4
    assert launches == 5
    (d / source.replace(".cu", "_cpu.cu")).write_text(src)
    return _build(d, flag, "-I", str(d))


@pytest.fixture(scope="module")
def gen1_model(tmp_path_factory):
    return _kernels_model(tmp_path_factory.mktemp("gen1_model"),
                          "yuv_chain.cu", "-DGEN1_KERNELS")


@pytest.fixture(scope="module")
def gen2_model(tmp_path_factory):
    return _kernels_model(tmp_path_factory.mktemp("gen2_model"),
                          "yiq_chain.cu", "-DGEN2_KERNELS")


def _write_inputs(d, files):
    for fname, t in files.items():
        data = t if isinstance(t, bytes) else t.contiguous().numpy().tobytes()
        (d / fname).write_bytes(data)


# widths of the half-width chroma (3 blocks), luma (6) and 1080i (15)
# rows; R = 2 and 5 at 1888 samples put rows across rounds of 16 blocks
@pytest.mark.parametrize("form", ["pole", "pole3", "walk"])
@pytest.mark.parametrize("w", [360, 720, 1888])
@pytest.mark.parametrize("rows_per_cta", [1, 2, 5])
def test_multi_row_form_equals_one_row_form(pole_model, form, w,
                                            rows_per_cta):
    rows = 2 * rows_per_cta + 1   # the last CTA holds one row
    seed = w * 10 + rows_per_cta
    res = subprocess.run([pole_model, form, str(w), str(rows_per_cta),
                          str(rows), str(seed)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok"), res.stdout


# the u8-masked walk of gen-1 (yuv_b1's chroma noise): the half-width
# chroma of 720 samples (3 blocks), a full 720-sample row (6) and the
# half-width chroma of 1888 (944: 8 blocks, R = 4 across two rounds)
@pytest.mark.parametrize("w", [360, 720, 944])
@pytest.mark.parametrize("rows_per_cta", [1, 2, 4])
def test_masked_multi_row_walk_equals_one_row_walk(pole_model, w,
                                                   rows_per_cta):
    rows = 2 * rows_per_cta + 1   # the last CTA holds one row
    res = subprocess.run([pole_model, "walk8", str(w), str(rows_per_cta),
                          str(rows), str(w + rows_per_cta)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok"), res.stdout


# fused_iir (3 planes a row): 3 blocks a row at 360 samples, 5 rows in one
# round of 15 blocks; 6 at 720, 5 rows in two rounds (30 blocks); 15 at
# 1888, one row (two fit, in two rounds: no fewer rounds a row). yiq_b1
# (5 planes): 3 rows of 720 samples fit, 2 fill one round best.
@pytest.mark.parametrize("planes,rows", [(3, [16, 5, 5, 1, 1]),
                                         (5, [16, 5, 2, 1, 1])])
def test_rows_per_cta_takes_fewest_rounds_a_row(pole_model, planes, rows):
    res = subprocess.run([pole_model, "rows", str(planes), "128", "384",
                          "768", "1920", "2560"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    assert [int(v) for v in res.stdout.split()] == rows


def test_rows_per_cta_fits_four_ctas_an_sm(pole_model):
    # a quarter of 228 KB, less the 1 KB kept a CTA and the poles' carry
    # scratch (pole.cuh RED_FLOATS, 304 floats)
    room = 228 * 1024 // 4 - 1024 - 304 * 4
    wps = list(range(128, 4096 + 1, 128))
    for planes in (1, 3, 5):
        res = subprocess.run([pole_model, "rows", str(planes),
                              *map(str, wps)],
                             capture_output=True, text=True, timeout=60,
                             check=True)
        for wp, r in zip(wps, map(int, res.stdout.split()), strict=True):
            assert 1 <= r <= 16
            assert r == 1 or r * planes * wp * 4 <= room


# the gen-1 kernels #7 and #8: 576i and 480i rows (wp 768, wp2 384: 54
# KB) 4 a CTA, luma in 2 rounds and chroma in 1 for the four; 1080i rows
# (1920, 1024: 34.5 KB) one a CTA; narrow rows up to ROUND
@pytest.mark.parametrize("wp,wp2,rows", [(768, 384, 4), (1920, 1024, 1),
                                         (128, 128, 16), (256, 128, 8)])
def test_gen1_rows_per_cta(pole_model, wp, wp2, rows):
    res = subprocess.run([pole_model, "gen1", str(wp), str(wp2)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    assert int(res.stdout) == rows


def test_gen1_rows_per_cta_fits_four_ctas_an_sm(pole_model):
    # every width w of 3..4096 samples: its padded luma and half-width
    # chroma rows, R of them beside the carries, within a quarter of 228 KB
    # less the 1 KB kept a CTA (57 KB)
    room = 228 * 1024 // 4 - 1024 - 304 * 4
    pairs = sorted({(-(-w // 128) * 128, -(-(w // 2) // 128) * 128)
                    for w in range(3, 4097)})
    res = subprocess.run([pole_model, "gen1",
                          *(str(v) for pair in pairs for v in pair)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    for (wp, wp2), r in zip(pairs, map(int, res.stdout.split()), strict=True):
        assert 1 <= r <= 16
        assert r == 1 or r * (3 * wp + 3 * wp2) * 4 <= room


# Kernels #6, #7 and #8 whole on the CPU model: every gen-1 configuration
# of the chain tests and the PAL bench configuration, at a 720-sample
# raster of 18 rows (4 rows a CTA: the last CTA holds 2, and CTAs hold rows
# of two fields) and at 1888 samples (rows across rounds of 16 blocks at 2
# and 3 rows a CTA)
GEN1_MODEL_CONFIGS = {**GEN1_CHAIN_CONFIGS,
                      "bench-pal": BENCH_CONFIGS["bench-gen1-ep-pal"]}


@pytest.mark.parametrize("shape", [(2, 9, 720), (1, 5, 1888)])
@pytest.mark.parametrize("name", sorted(GEN1_MODEL_CONFIGS))
def test_gen1_kernels_at_any_rows_per_cta(gen1_model, tmp_path, name, shape):
    cfg = GEN1_MODEL_CONFIGS[name]
    b, l, w = shape
    rng = np.random.default_rng(zlib.crc32(f"{name}/{shape}".encode()))
    y, u, v = (torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
               for s in ((b, l, w), (b, l, w // 2), (b, l, w // 2)))
    fn = torch.arange(b, dtype=torch.int32) + 3
    prep = fused_yuv.prepare(cfg, y, fn, fn % 2, key32_from_seed(5))
    w2 = w // 2
    params = fused_yuv._yuv_params(cfg, b, l, w, -(-w // 128) * 128, w2,
                                   -(-w2 // 128) * 128)
    _write_inputs(tmp_path, {
        "params": bytes(params), "y": y, "u": u, "v": v, "xi": prep.xi,
        "keys": u32_as_i32(prep.keys_ab), "sincos": prep.sincos,
        "keep": prep.keep,
        **dict(zip(("tt", "d", "tt3", "d3", "vt"), prep.tables))})

    def run(kernel, rows_per_cta):
        out = tmp_path / f"{kernel}_{rows_per_cta}"
        res = subprocess.run([gen1_model, "yuv", str(tmp_path), kernel,
                              str(rows_per_cta), str(out)],
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        data = np.frombuffer(out.read_bytes(), np.uint8)
        if kernel == "a":
            return [data]
        return np.split(data, [y.numel(), y.numel() + u.numel()])

    plain = {"a": (fused_yuv.stage_a_reference(y, u, v, prep, cfg=cfg),),
             "b1": fused_yuv.stage_b1_reference(y, prep, cfg=cfg),
             "b2": fused_yuv.stage_b2_reference(y, u, v, prep, cfg=cfg)}
    for kernel in ("a", "b1", "b2"):
        one_row = run(kernel, 1)
        for k, want in enumerate(plain[kernel]):
            assert_chain_equal(one_row[k], want.numpy().ravel(),
                               err_msg=f"{kernel} plane {k}")
        for rows_per_cta in (0, 2, 3, 4):
            got = run(kernel, rows_per_cta)
            assert len(got) == len(one_row)
            for k, g in enumerate(got):
                assert np.array_equal(g, one_row[k]), (kernel, k,
                                                       rows_per_cta)


# Kernels #2, #3 and #4 whole on the CPU model: every gen-2 configuration
# of the chain tests and the bench configuration, on whole fields of 9 rows
# at 720 samples (the last CTA holds fewer rows, CTAs hold rows of two
# fields) and of 5 rows at 1888, and on a row shard: rows 5..11 of two
# fields 16 rows high (row0 > 0, an odd height, so that at 2 rows a CTA the
# fourth CTA holds line 11 of field 0 and line 5 of field 1). The chain
# configurations take #4 down each of its branches: the sharpen with and
# without the re-encode/decode (vhs-sp, svideo), Y/C recombine (yc-recomb)
# and the output lowpass off, 'tv' and full (bare, defaults-noise-off,
# full-lowpass-out); chroma dropout takes a row in 100,000 per unit of
# video_chroma_loss, so "chroma-loss-half" drops about every other row, and
# each CTA's rows take their own keep.
GEN2_MODEL_CONFIGS = {
    **CHAIN_CONFIGS, "bench": BENCH_CONFIGS["bench-vhs-ep"],
    "chroma-loss-half": CompositeConfig(video_noise=0, emulating_vhs=True,
                                        video_chroma_loss=50000)}
GEN2_MODEL_SHAPES = [(2, 9, 720, 0, 9), (1, 5, 1888, 0, 5),
                     (2, 16, 720, 5, 7)]


def _gen2_kernel_at_any_rows_per_cta(gen2_model, tmp_path, kernel, name,
                                     shape):
    """Kernel #2 (a), #3 (b1) or #4 (b2) through the CPU model at 1 row a
    CTA against its plain version (assert_chain_equal), and at 0 (its own
    choice), 2, 3 and 4 rows a CTA against 1, byte for byte. #3 runs on
    #2's plain output, head-switched; #4 on #3's plain output."""
    cfg = GEN2_MODEL_CONFIGS[name]
    b, l_glob, w, row0, l = shape
    rng = np.random.default_rng(zlib.crc32(f"{name}/{shape}".encode()))
    rgb = torch.from_numpy(
        rng.integers(0, 256, (b, l, w, 3)).astype(np.uint8))
    fn = torch.arange(b, dtype=torch.int32) + 3
    prep = fused_yiq.prepare(cfg, rgb, fn, fn % 2, key32_from_seed(5),
                             row0=row0, l_glob=l_glob)
    wp = -(-w // 128) * 128
    params = fused_yiq._chain_params(cfg, b, l, w, wp, row0, l_glob)
    files = {"params": bytes(params), "xi": prep.xi,
             "keys": u32_as_i32(prep.keys_ab), "sincos": prep.sincos,
             "keep": prep.keep,
             **dict(zip(("tt", "d", "tt3", "d3", "vt"), prep.tables))}
    if kernel == "a":
        files["rgb"] = rgb
        plain = [fused_yiq.stage_a_reference(rgb, prep, cfg=cfg)]
    else:
        y = fused_yiq.stage_a_reference(rgb, prep, cfg=cfg)
        if cfg.vhs_head_switching:
            y = fused_yiq.head_switch_rows(y, prep.shifts, w)
        planes = fused_yiq.stage_b1_reference(y, prep, cfg=cfg, w=w)
        if kernel == "b1":
            files["y"] = y
            plain = list(planes)
        else:
            files.update(zip(("y", "i", "q"), planes))
            plain = [fused_yiq.stage_b2_reference(*planes, prep, cfg=cfg,
                                                  w=w)]
    _write_inputs(tmp_path, files)

    def run(rows_per_cta):
        out = tmp_path / f"{kernel}_{rows_per_cta}"
        res = subprocess.run([gen2_model, "yiq", str(tmp_path), kernel,
                              str(rows_per_cta), str(out)],
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        dtype = np.uint8 if kernel == "b2" else np.float32
        return np.split(np.frombuffer(out.read_bytes(), dtype), len(plain))

    one_row = run(1)
    for k, want in enumerate(plain):
        assert_chain_equal(one_row[k], want.numpy().ravel(),
                           err_msg=f"{kernel} plane {k}")
    for rows_per_cta in (0, 2, 3, 4):
        got = run(rows_per_cta)
        for k, g in enumerate(got):
            assert np.array_equal(g, one_row[k]), (kernel, k, rows_per_cta)


@pytest.mark.parametrize("shape", GEN2_MODEL_SHAPES)
@pytest.mark.parametrize("name", sorted(GEN2_MODEL_CONFIGS))
def test_gen2_kernel_a_at_any_rows_per_cta(gen2_model, tmp_path, name,
                                           shape):
    _gen2_kernel_at_any_rows_per_cta(gen2_model, tmp_path, "a", name, shape)


@pytest.mark.parametrize("shape", GEN2_MODEL_SHAPES)
@pytest.mark.parametrize("name", sorted(GEN2_MODEL_CONFIGS))
def test_gen2_kernel_b1_at_any_rows_per_cta(gen2_model, tmp_path, name,
                                            shape):
    _gen2_kernel_at_any_rows_per_cta(gen2_model, tmp_path, "b1", name, shape)


@pytest.mark.parametrize("shape", GEN2_MODEL_SHAPES)
@pytest.mark.parametrize("name", sorted(GEN2_MODEL_CONFIGS))
def test_gen2_kernel_b2_at_any_rows_per_cta(gen2_model, tmp_path, name,
                                            shape):
    _gen2_kernel_at_any_rows_per_cta(gen2_model, tmp_path, "b2", name, shape)
