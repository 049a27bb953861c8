"""The gen-1 library entry on the split route, held to the benchmark's
plain reference, with the recorder's spans of the route.

At the PAL raster of the benchmark's `composite-576i-pal-tensors` cell (2
fields of 288 x 720, `to-composite -tvstd pal -vhs -vhs-speed lp`)
`yuv422.composite_video_process_auto` on CPU tensors runs the plain
versions of kernels #6-#8 and the head-switch seam. Its output is
compared with `benchmark/reference/gen1.chain` through the benchmark's
check under the cell's limits; the spans `gen1.split.a`, `.switch`,
`.b1`, `.b2` are recorded once each inside `gen1.launch`, no sync is
counted inside them, and PAL runs no `gen1.split.blend`. At 240 x 720
NTSC the entry takes the merged kernel #5 and records no split span.
"""

import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

from cvsim_tpu_torch.interop import key32_from_seed
from cvsim_tpu_torch.models import yuv422
from cvsim_tpu_torch.utils import log

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import judge, program  # noqa: E402
from reference import gen1  # noqa: E402
from reference.config import chain_config  # noqa: E402

SPLIT = ("a", "switch", "b1", "blend", "b2")
CASES = {
    # (cell, configuration, field shape, the route)
    "pal-576i-split": ("composite-576i-pal-tensors",
                       "composite-pal-vhs-lp-576i", (288, 720), "split"),
    "ntsc-480i-merged": ("composite-480i-tensors", "composite-vhs-ep-480i",
                         (240, 720), "merged"),
}


def _load(kind, name):
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def _planes(tag, b, l, w):
    """Seeded uint8 4:2:2 planes in the ranges the benchmark's pools use."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return tuple(torch.from_numpy(rng.integers(lo, hi + 1, (b, l, ww))
                                  .astype(np.uint8))
                 for lo, hi, ww in ((16, 235, w), (40, 216, w // 2),
                                    (40, 216, w // 2)))


@pytest.fixture
def tracing():
    log.reset()
    log.tracing(True)
    try:
        yield
    finally:
        log.tracing(False)
        log.reset()


def _run(case):
    cell, config_name, (l, w), _ = CASES[case]
    config = _load("configs", config_name)
    cfg, _ = program.run_config(config)
    y, u, v = _planes(case, 2, l, w)
    # a bottom field first, as the benchmark's calls number them
    fieldno = torch.tensor([1000, 1001], dtype=torch.int32)
    parity = (fieldno & 1) ^ 1
    out = yuv422.composite_video_process_auto(
        y, u, v, fieldno, parity, key32_from_seed(cfg.seed),
        cfg=cfg.composite)
    snap = log.snapshot()
    want = gen1.chain(y, u, v, fieldno, parity,
                      chain_config(config["composite"]), config["seed"])
    tally = judge.Tally()
    for k in range(y.shape[0]):
        tally.add(tuple(p[k].numpy() for p in out),
                  tuple(p[k].numpy() for p in want))
    correct, check = judge.verdict(tally.numbers(),
                                   _load("workloads", cell)["limits"])
    return snap, correct, check


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_matches_the_reference_under_the_cells_limits(tracing, case):
    _, correct, check = _run(case)
    print(f"{case}: worst_field_mismatch_pct "
          f"{check['worst_field_mismatch_pct']['value']!r}")
    assert correct, check
    assert check["missing_fields"]["value"] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_spans_recorded_on_the_split_route_only(tracing, case):
    route = CASES[case][3]
    snap, _, _ = _run(case)
    aggs = snap["aggregates"]
    names = {f"gen1.split.{step}" for step in SPLIT}
    if route == "merged":
        assert not names & set(aggs)
        return
    # PAL: the blend between #7 and #8 is NTSC only
    assert names - set(aggs) == {"gen1.split.blend"}
    launch_ids = {s["id"] for s in snap["spans"] if s["name"] == "gen1.launch"}
    for s in snap["spans"]:
        if s["name"] in names:
            assert s["parent"] in launch_ids, s
    for name in names - {"gen1.split.blend"}:
        assert aggs[name]["count"] == 1
        assert aggs[name]["counts"].get("syncs", 0) == 0
