"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line.

    run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the result's metrics are the cell's end-to-end metrics;
with --trace 1 the window runs under torch.profiler with the benchmark's
spans around the program's layers, and the metrics are the cell's
per-layer metrics. Either way the sampled outputs are checked against
the plain reference once the window has closed, the peak memory has been
read and the program's state has been freed."""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field

from harness import judge, spec as spec_mod

# modules the process that prints a result may not hold (compared by
# their top-level name, whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "cvsim_tpu")


def process_age() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


class Clock:
    """Process age on the perf_counter clock."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.age0 = process_age()

    def age(self) -> float:
        return self.age0 + time.perf_counter() - self.t0


@dataclass
class Window:
    """What the measured window did."""
    fields: int                 # output fields completed
    units: int                  # GOPs (renders) or library calls
    seconds: float              # the window's whole wall time
    latencies: list = field(default_factory=list)   # per call, seconds


@dataclass
class RunRecord:
    """Everything a metric reader may read."""
    config: dict
    setup_s: float
    startup: dict               # seconds: torch, port, kernels
    window: Window
    spans: object = None        # trace.Spans of a traced run
    trace: object = None        # trace.DeviceTrace of a traced run
    least_time: tuple = None    # (seconds, "bytes"|"operations") a call


class Cell:
    """A cell as its driver sees it: the merged workload, its configuration,
    the seed, the device and a few helpers."""

    def __init__(self, spec, name: str, seed: int, device: str,
                 overrides: dict | None = None):
        import numpy as np

        self.spec = spec
        self.name = name
        self.workload = spec.cell(name)
        self.config = spec.config(self.workload["config"])
        for key, value in (overrides or {}).items():
            target = self.config if key in self.config else self.workload
            target[key] = ({**target[key], **value}
                           if isinstance(value, dict) else value)
        self.seed = int(seed)
        self.device = device
        # the sampling draws from its own stream of the seed
        self.rng = np.random.default_rng([self.seed & (2 ** 64 - 1), 0x5A3])

    def sync(self):
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()


def _device_info(device: str) -> dict:
    import torch

    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             clock: Clock, startup: dict, device: str = "cuda",
             overrides: dict | None = None, entry=None) -> dict:
    """One run; returns the result object (not yet printed). `entry`:
    fn(original, *args, **kwargs) in place of the program function that
    the cell's driver names as its ENTRY (the driver's control and its
    planted faults)."""
    import contextlib

    import torch

    from harness import program
    from harness.trace import WINDOW, Spans, reduce_profile

    cell = Cell(spec, name, seed, device, overrides)
    t = time.perf_counter()
    # the driver imports the program's modules that the cell runs
    mod = spec_mod.driver_module(cell.workload["driver"])
    startup["port"] = time.perf_counter() - t
    swap = (program.replaced_entry(mod.ENTRY, entry) if entry
            else contextlib.nullcontext())
    prof = None
    spans = Spans() if trace else None
    with swap:
        drv = mod.Driver(cell)
        t = time.perf_counter()
        if device.startswith("cuda"):
            from cvsim_tpu_torch import kernels

            kernels.load()
        startup["kernels"] = time.perf_counter() - t
        drv.warm_up()
        cell.sync()
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)

                acts = [ProfilerActivity.CPU]
                if device.startswith("cuda"):
                    acts.append(ProfilerActivity.CUDA)
                stack.enter_context(drv.traced(spans))
                prof = stack.enter_context(profile(activities=acts))
            setup_s = clock.age()
            with (record_function(WINDOW) if trace
                  else contextlib.nullcontext()):
                win = drv.window(seconds)
                cell.sync()
    device_info = _device_info(device)
    device_trace = (reduce_profile(prof.profiler.kineto_results.events())
                    if prof is not None else None)
    del prof
    samples = drv.samples()
    drv.release()
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    tally = drv.check(samples)
    correct, check = judge.verdict(tally.numbers(), cell.workload["limits"])

    record = RunRecord(config=cell.config,
                       setup_s=setup_s, startup=dict(startup), window=win,
                       spans=spans, trace=device_trace,
                       least_time=getattr(drv, "least_time", None))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(name, kind):
        value = spec_mod.metric_reader(spec.bench_dir, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win.fields,
              "failed": int(tally.missing), "metrics": metrics,
              "device": device_info}
    if device_trace is not None:
        result["device"]["busy_s"] = device_trace.busy_s
        result["device"]["window_s"] = device_trace.window_s
        result["breakdown"] = {"device_ops": device_trace.device_ops,
                               "idle_gaps": device_trace.idle_gaps}
    result["check"] = check
    result["_sampled_fields"] = tally.fields
    result["_max_diff"] = tally.max_diff
    return result


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse

    clock = Clock()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = spec_mod.Spec.load()
    cell = spec.cell(args.workload)
    startup = {}
    t = time.perf_counter()
    import torch

    startup["torch"] = time.perf_counter() - t
    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is false); "
              "the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), clock, startup)
    bad = forbidden_modules()
    if bad:
        print(f"error: the process holds {', '.join(bad)} after the window",
              file=sys.stderr)
        return 3
    sampled = result.pop("_sampled_fields")
    result.pop("_max_diff")
    judge.print_check(result["check"], sampled)
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    return 0
