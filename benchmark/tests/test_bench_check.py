"""The check that decides `correct`, driven through a whole run on the
CPU at a small size (the look for a card skipped): the program reads
correct; the cell's driver's control (the reference in the program's
place one precision step down: TF32 products on the chains) reads not
correct, and so does each fault the driver plants under the timed path.
Every workload file is run."""

import glob
import os

import pytest

from harness import core, spec as spec_mod
from conftest import BENCH, ROOT

import small

CELLS = sorted(os.path.basename(p)[:-len(".json")]
               for p in glob.glob(os.path.join(BENCH, "workloads", "*.json")))


def _driver(name):
    return spec_mod.driver_module(
        spec_mod.load_json(BENCH, "workloads", name)["driver"])


FAULTS = [(name, fault) for name in CELLS
          for fault in sorted(_driver(name).FAULTS)]


@pytest.fixture(scope="module")
def spec():
    return spec_mod.Spec.load(ROOT)


def _run(spec, name, entry=None, seed=2 ** 31 + 3):
    return core.run_cell(spec, name, seed, 0.3, False, core.Clock(), {},
                         device="cpu", overrides=small.overrides(spec, name),
                         entry=entry)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_reads_correct(spec, name):
    r = _run(spec, name)
    assert r["correct"], r["check"]
    assert r["_sampled_fields"] >= 4 and r["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_reads_not_correct(spec, name):
    control = _driver(name).control(spec.config(spec.cell(name)["config"]))
    r = _run(spec, name, control)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_each_fault_reads_not_correct(spec, name, fault):
    r = _run(spec, name, _driver(name).FAULTS[fault])
    assert not r["correct"], r["check"]
