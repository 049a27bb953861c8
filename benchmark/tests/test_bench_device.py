"""A run without a CUDA card fails and prints no result; on the card
(marked `cuda`), one short run of a cell prints a correct result line."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


def _run_py(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), *args],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("a CUDA card is visible")
    p = _run_py("--workload", "ntsc-480i-tensors", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    if not _has_card():
        pytest.skip("needs a CUDA card")
    p = _run_py("--workload", "ntsc-480i-tensors", "--seed", "2147483701",
                "--seconds", "2", "--trace", trace)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"
    assert p.stderr.rstrip().splitlines()[-1].startswith("check ")
