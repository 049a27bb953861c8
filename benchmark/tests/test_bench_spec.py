"""The harness finds configurations, cells and metrics by name: every
entry of BENCHMARK.json has its file, and one dropped into a copy of the
benchmark is found with no edit to an existing file."""

import json
import os
import shutil

import pytest

from harness import core, spec as spec_mod
from conftest import BENCH, ROOT


@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec.load(ROOT)


def test_every_entry_has_its_file(spec):
    b = spec.bench
    for c in b["configs"]:
        assert spec.config(c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        assert spec_mod.driver_module(cell["driver"]).Driver
        assert set(cell["limits"]) == {"worst_field_mismatch_pct",
                                       "missing_fields"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec_mod.metric_reader(spec.bench_dir, m["name"]))


def test_cells_report_what_the_contract_asks(spec):
    for w in spec.bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(w["name"], "per_layer")


def test_new_files_are_found_without_edits(spec, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    # a new configuration, a new cell on it (an existing driver) and a
    # new per-layer metric: new files and new entries only
    cfg = spec.config("ntsc-vhs-ep-480i")
    cfg.update(name="ntsc-vhs-ep-480i-w64", argv=cfg["argv"] + ["-width", "64"],
               output={**cfg["output"], "width": 64})
    (root / "benchmark/configs/ntsc-vhs-ep-480i-w64.json").write_text(
        json.dumps(cfg))
    work = spec_mod.load_json(BENCH, "workloads", "ntsc-480i-tensors")
    work.update(name="ntsc-w64-tensors", config="ntsc-vhs-ep-480i-w64",
                batch=4, field_shape=[240, 64], pool_batches=2,
                warmup_calls=1, sample_calls=2)
    (root / "benchmark/workloads/ntsc-w64-tensors.json").write_text(
        json.dumps(work))
    (root / "benchmark/metrics/calls_made.py").write_text(
        "def read(run):\n    return float(run.window.units)\n")
    bench["configs"].append({"name": "ntsc-vhs-ep-480i-w64",
                             "source": "https://example.org/x",
                             "file": "benchmark/configs/"
                                     "ntsc-vhs-ep-480i-w64.json",
                             "reduced": ["width"], "why": "test"})
    bench["workloads"].append({"name": "ntsc-w64-tensors",
                               "config": "ntsc-vhs-ep-480i-w64",
                               "traffic": "tensors", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("ntsc-w64-tensors")
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["ntsc-w64-tensors"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    new = spec_mod.Spec.load(str(root))
    result = core.run_cell(new, "ntsc-w64-tensors", 5, 0.5, False,
                           core.Clock(), {}, device="cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"fields_per_s", "batch_ms_p95",
                                      "setup_s", "calls_made"}
    after = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
             if p.is_file() and p in before}
    assert after == before
