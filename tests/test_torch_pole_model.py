"""The multi-row pole primitives of csrc/pole.cuh (pole_rows, pole3_rows)
and the multi-row noise walk of csrc/noise.cuh (add_walk_rows), which
kernels #3 (yiq_b1) and #9 (fused_iir) run, against the one-row forms
that every other kernel runs, bit for bit, on the CPU.

There is no CUDA compiler here, so tests/pole_model.cpp compiles the two
headers with g++ under a shim (128 std::threads for a CTA, barriers for
__syncthreads/__syncwarp) and runs ROWS random rows, each with its own
reset value (or noise stream), through the one-row form and through the
multi-row form R rows a CTA, the last CTA holding fewer; pole and pole3
are also held against a plain sequential loop with the same operation
order. The same build holds pole.cuh's rows_per_cta, the rows a CTA
that kernels #3 and #9 choose per width, at an H100 SM's shared memory.
Skips without g++.
"""

import os
import shutil
import subprocess

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, os.pardir, "cvsim_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def pole_model(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU model of pole.cuh")
    exe = str(tmp_path_factory.mktemp("pole_model") / "pole_model")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-pthread", "-I", CSRC,
                    os.path.join(HERE, "pole_model.cpp"), "-o", exe],
                   check=True, capture_output=True, text=True)
    return exe


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
