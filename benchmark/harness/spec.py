"""What the harness reads by name: BENCHMARK.json at the root of the
checkout, and under benchmark/ the workload files (`workloads/<cell>.json`),
the configuration files they name, the driver modules
(`drivers/<driver>.py`) and the metric readers (`metrics/<metric>.py`).
A new cell, configuration or metric is a new file and an entry in
BENCHMARK.json: nothing here lists them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from fractions import Fraction

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Spec:
    root: str               # the checkout's root (holds BENCHMARK.json)
    bench: dict             # BENCHMARK.json

    @classmethod
    def load(cls, root: str | None = None) -> "Spec":
        root = root or os.path.dirname(BENCH_DIR)
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            return cls(root, json.load(f))

    @property
    def bench_dir(self) -> str:
        return os.path.join(self.root, "benchmark")

    def cell(self, name: str) -> dict:
        """The BENCHMARK.json entry of a cell, merged with its workload
        file (the file's keys win over nothing: both must agree)."""
        entries = [w for w in self.bench["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[0]
        work = load_json(self.bench_dir, "workloads", name)
        if work.get("config") != entry["config"]:
            raise ValueError(f"{name}: BENCHMARK.json names configuration "
                             f"{entry['config']!r}, its file "
                             f"{work.get('config')!r}")
        return {**work, **entry}

    def config(self, name: str) -> dict:
        entries = [c for c in self.bench["configs"] if c["name"] == name]
        if not entries:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        with open(os.path.join(self.root, entries[0]["file"])) as f:
            return json.load(f)

    def metrics_of(self, cell: str, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` entries that `cell` reports: those
        that list it, and those without a list whose end-to-end metric the
        cell reports (every cell, for an end-to-end metric)."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]


def load_json(bench_dir: str, kind: str, name: str) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def driver_module(name: str):
    return importlib.import_module(f"drivers.{name}")


def metric_module(bench_dir: str, name: str):
    """metrics/<name>.py (names may hold dots, so the file is loaded by
    path): its `read(run)`, and for a reader of the program's spans or
    counters optionally its `CASE`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: str, name: str):
    """The `read(run)` function of metrics/<name>.py."""
    return metric_module(bench_dir, name).read


def fraction(text: str) -> Fraction:
    num, _, den = str(text).partition("/")
    return Fraction(int(num), int(den or 1))
