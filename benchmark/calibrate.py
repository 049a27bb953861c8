"""Readings that the limits of the check are set from (not part of a
benchmark run): the program's numbers over many seeds, and the
lower-precision control's (the cell's driver's `control(config)`) in the
program's place, all in one process, each a short window at the cell's
own load.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 4

Prints one JSON line a run: the side ("program" or "control"), the seed,
the numbers compared and the fields sampled."""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from harness import core, spec as spec_mod  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(spec, workload: str, program_seeds, control_seeds,
             seconds: float, **run):
    """One reading a run, program seeds first: the side, the seed, the
    numbers compared and the fields sampled. `run`: further arguments of
    core.run_cell (the CPU tests' device and size)."""
    cell = spec.cell(workload)
    control = spec_mod.driver_module(cell["driver"]).control(
        spec.config(cell["config"]))
    runs = [("program", s, None) for s in program_seeds] + [
        ("control", s, control) for s in control_seeds]
    for side, seed, entry in runs:
        r = core.run_cell(spec, workload, seed, seconds, False,
                          core.Clock(), {}, entry=entry, **run)
        yield {"workload": workload, "side": side, "seed": seed,
               "correct": r["correct"], "fields": r["attempted"],
               "sampled": r["_sampled_fields"],
               "numbers": {k: v["value"] for k, v in r["check"].items()},
               "max_diff": r["_max_diff"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    for reading in readings(spec_mod.Spec.load(), args.workload, args.seeds,
                            args.control_seeds, args.seconds):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
