"""A cell on a program entry other than the two chains comes as new files.

In a copy of the benchmark, `tests/new_entry/` is dropped in: a driver on
`host/payload.payloads` that brings its entry, control, faults, small
size and reference module, a per-layer reader of its kernel's device
time, and a reader of a program counter with its own `CASE`; beside them
a configuration, a workload and their entries in the copy's
BENCHMARK.json. The copy's own tests, unedited, then run the new cell
correct on the CPU, its control and each of its faults not correct, and
the reader's case; `calibrate.readings` takes the driver's control; and
no file that the benchmark had changes."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness import spec as spec_mod
from conftest import BENCH, ROOT

NEW = os.path.join(BENCH, "tests", "new_entry")
CELL = "payload-480i-tensors"
CONFIG = "ntsc-vhs-ep-480i-payload"
COUNTER = "syncs_per_gop.gen2"
FAULTS = ("altered", "half_batch", "unchanged")


def _entries(bench: dict, source: str) -> None:
    bench["configs"].append({
        "name": CONFIG, "source": source,
        "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
        "why": "gen-2 ntsc at VHS-EP, 720x480: the output the payloads make"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "payloads", "chips": 1,
        "why": "one closed-loop caller of host.payload.payloads, 64 RGB "
               "fields of 240x720 a call: kernel y4m_payload"})
    bench["per_layer"] += [
        {"name": "payload_kernel_ms_per_call", "unit": "ms",
         "better": "lower", "source": "device_trace",
         "layer": "Y4M payload kernel (csrc/y4m_payload.cu)",
         "moves": "fields_per_s", "workloads": [CELL]},
        {"name": COUNTER, "unit": "syncs/GOP", "better": "lower",
         "source": "program_counter",
         "layer": "gen-2 host loop (host/pipeline_yiq.py)",
         "moves": "fields_per_s", "workloads": ["ntsc-480i-render"]}]


def _python(root, *args):
    """A fresh process in the copy, with the program importable from the
    checkout it was copied from."""
    env = {**os.environ, "PYTHONPATH": ROOT, "PYTHONDONTWRITEBYTECODE": "1"}
    return subprocess.run([sys.executable, *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


CALIBRATE = """\
import json, sys
sys.path[:0] = ["benchmark", "benchmark/tests"]
import calibrate, small
from harness import spec as spec_mod
spec = spec_mod.Spec.load(".")
print(json.dumps(list(calibrate.readings(
    spec, CELL, [11], [12], 0.3, device="cpu",
    overrides=small.overrides(spec, CELL)))))
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """The copy's own tests and a calibration, run in the copy: {"tests",
    "calibrate": the finished processes; "before", "after": the bytes of
    every file the benchmark had, before the new files and after the
    runs}."""
    root = tmp_path_factory.mktemp("new_entry") / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    for d, _, files in os.walk(NEW):
        for f in files:
            if f.endswith(".pyc"):
                continue
            src = os.path.join(d, f)
            dst = bench_dir / os.path.relpath(src, NEW)
            assert not dst.exists(), dst
            shutil.copyfile(src, dst)
    spec = spec_mod.Spec.load(ROOT)
    cfg = spec.config("ntsc-vhs-ep-480i")
    cfg["name"] = CONFIG
    (bench_dir / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(spec.bench))
    _entries(bench, [c for c in bench["configs"]
                     if c["name"] == "ntsc-vhs-ep-480i"][0]["source"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))

    tests = _python(root, "-m", "pytest", "-q", "-rA", "-p",
                    "no:cacheprovider",
                    "benchmark/tests/test_bench_check.py",
                    "benchmark/tests/test_bench_program_trace.py",
                    "benchmark/tests/test_bench_spec.py",
                    "benchmark/tests/test_bench_contract.py",
                    "-k", f"{CELL} or not test_bench_check")
    calibrate = _python(root, "-c", f"CELL = {CELL!r}\n" + CALIBRATE)
    after = {p: p.read_bytes() if p.is_file() else None for p in before}
    return {"tests": tests, "calibrate": calibrate, "before": before,
            "after": after}


def test_the_copy_s_own_tests_take_the_new_cell_and_reader(copy):
    p = copy["tests"]
    assert p.returncode == 0, p.stdout[-6000:] + p.stderr[-2000:]
    passed = set(re.findall(r"^PASSED (\S+)", p.stdout, re.M))
    check = "benchmark/tests/test_bench_check.py::"
    trace = "benchmark/tests/test_bench_program_trace.py::"
    want = {f"{check}test_the_program_reads_correct[{CELL}]",
            f"{check}test_the_lower_precision_control_reads_not_correct"
            f"[{CELL}]",
            f"{trace}test_every_program_metric_has_a_case",
            f"{trace}test_reader_on_a_snapshot[{COUNTER}]",
            "benchmark/tests/test_bench_spec.py::"
            "test_every_entry_has_its_file"}
    want |= {f"{check}test_each_fault_reads_not_correct[{CELL}-{f}]"
             for f in FAULTS}
    assert want <= passed, sorted(want - passed)


def test_calibrate_takes_the_driver_s_control(copy):
    p = copy["calibrate"]
    assert p.returncode == 0, p.stderr[-4000:]
    program, control = json.loads(p.stdout.splitlines()[-1])
    assert (program["side"], program["correct"]) == ("program", True)
    assert program["numbers"]["worst_field_mismatch_pct"] == 0
    assert (control["side"], control["correct"]) == ("control", False)


def test_no_file_the_benchmark_had_changes(copy):
    assert copy["after"] == copy["before"]
