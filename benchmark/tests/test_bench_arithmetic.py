"""The metric arithmetic on synthetic inputs: the union of device
intervals, the 95th percentile over every call, and the least time of a
call's work at the shapes the library cells and the 1080i chains use."""

from types import SimpleNamespace

import numpy as np
import pytest

from harness import spec as spec_mod, trace, work
from conftest import ROOT


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41), (2, 3)]
    u = trace.union(iv)
    assert u.tolist() == [[0, 12], [20, 30], [40, 41]]
    assert trace.covered(iv) == 23
    assert trace.covered(trace.clip(iv, 8, 22)) == 6
    assert trace.covered([]) == 0


def test_idle_gaps_take_the_innermost_span():
    gaps = np.array([[10.0, 20.0], [30.0, 34.0], [50.0, 60.0]])
    spans = [(0, 40, "outer"), (28, 36, "inner")]
    named = trace._name_gaps(gaps, spans)
    assert named == {"outer": 10.0, "inner": 4.0, "no benchmark span": 10.0}


def _run(**kw):
    return SimpleNamespace(**kw)


def test_p95_and_rates():
    root = spec_mod.Spec.load(ROOT).bench_dir
    p95 = spec_mod.metric_reader(root, "batch_ms_p95")
    lat = [0.001 * k for k in range(1, 101)]          # 1 .. 100 ms
    win = _run(latencies=lat, fields=640, units=10, seconds=2.0)
    assert p95(_run(window=win)) == pytest.approx(95.05)
    assert spec_mod.metric_reader(root, "fields_per_s")(
        _run(window=win)) == 320.0
    idle = spec_mod.metric_reader(root, "device_idle_pct")
    t = trace.DeviceTrace(window_s=2.0, busy_s=0.5, copy_s=0.1)
    assert idle(_run(trace=t)) == 75.0
    copies = spec_mod.metric_reader(root, "copy_ms_per_gop")
    assert copies(_run(trace=t, window=win)) == pytest.approx(10.0)


@pytest.fixture(scope="module")
def chains():
    spec = spec_mod.Spec.load(ROOT)
    return (spec.config("ntsc-vhs-ep-480i")["composite"],
            spec.config("composite-vhs-ep-480i")["composite"])


def test_pole_counts(chains):
    gen2, gen1 = chains
    # in lowpass 6, luma noise 1 | chroma noise 2, VHS 10 | VHS 3, out 6
    assert work.gen2_poles(gen2) == 28
    # luma: noise 1 + VHS 4 + 3; chroma: in 8, noise 2, VHS 6 + 6, out 8
    assert work.gen1_poles(gen1) == (8, 30)


@pytest.mark.parametrize("gen,b,l,w", [
    ("gen2", 64, 240, 720), ("gen1", 64, 240, 720),
    ("gen2", 16, 540, 1888), ("gen1", 16, 540, 1888)])
def test_least_time_at_four_shapes(chains, gen, b, l, w):
    c = chains[0] if gen == "gen2" else chains[1]
    if gen == "gen2":
        n_bytes = 2 * b * l * w * 3 + 8 * b
        flops = b * l * w * 28 * 3
        t, kind = work.gen2_call(c, b, l, w)
    else:
        n_bytes = 2 * b * l * 2 * w + 8 * b
        flops = b * l * (8 * w + 30 * (w // 2)) * 3
        t, kind = work.gen1_call(c, b, l, w)
    want = max(n_bytes / 3.35e12, flops / 67e12)
    assert t == pytest.approx(want)
    assert kind == ("bytes" if n_bytes / 3.35e12 >= flops / 67e12
                    else "operations")


class _Event:
    def __init__(self, name, start, end, cuda):
        from torch.autograd import DeviceType

        self._v = (name, start, end - start,
                   DeviceType.CUDA if cuda else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_reduce_profile_reads_the_window_only():
    ev = [_Event("bench.window", 100, 1100, False),
          _Event("bench.window", 100, 1100, True),      # device copy
          _Event("bench.emit", 500, 900, False),
          _Event("bench.emit", 500, 900, True),
          _Event("kernA(int)", 50, 300, True),          # half before
          _Event("kernA(int)", 250, 400, True),         # overlaps
          _Event("Memcpy DtoH (Device -> Pinned)", 600, 700, True),
          _Event("aten::add", 600, 610, False)]
    t = trace.reduce_profile(ev)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(400e-9)          # 100-400, 600-700
    assert t.copy_s == pytest.approx(100e-9)
    assert t.device_ops[0] == ["kernA", pytest.approx(400e-9)]
    assert dict(t.idle_gaps) == {"emit": pytest.approx(200e-9),
                                 "no benchmark span": pytest.approx(400e-9)}
