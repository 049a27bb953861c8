"""The check that decides `correct`, driven through a whole run on the
CPU at a small size (the look for a card skipped): the program reads
correct; the reference in its place one precision step down (TF32
products) reads not correct, and so does each fault planted under the
timed path. Every workload file is run."""

import glob
import os

import pytest

from harness import controls, core, spec as spec_mod
from conftest import BENCH, ROOT

import small

CELLS = sorted(os.path.basename(p)[:-len(".json")]
               for p in glob.glob(os.path.join(BENCH, "workloads", "*.json")))


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
    gen = spec_mod.driver_module(spec.cell(name)["driver"]).GEN
    r = _run(spec, name, controls.control(gen, spec.config(
        spec.cell(name)["config"])))
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_reads_not_correct(spec, name, fault):
    r = _run(spec, name, controls.FAULTS[fault])
    assert not r["correct"], r["check"]
