"""The readers of the gen-1 split route's metrics
(`split_kernels_ms_per_call.gen1`, `eager_ms_per_call.gen1`) on a
hand-built run record: each reads its defined value from a device trace,
and None where the trace, the kernels or the calls are missing."""

import pytest

from conftest import ROOT
from harness import spec as spec_mod
from harness.core import RunRecord, Window
from harness.trace import DeviceTrace

CALLS = 4
TRACE = DeviceTrace(
    window_s=0.05, busy_s=0.030, copy_s=0.002,
    device_ops=[["cvsim::yuv_b2<true>", 0.0048],
                ["cvsim::yuv_b1<true>", 0.0044],
                ["cvsim::yuv_a<true>", 0.0036],
                ["at::native::index_elementwise_kernel", 0.0040],
                ["Memcpy_HtoD__Pageable_-__Device_", 0.0020],
                ["cvsim::field_streams", 0.0002],
                ["cvsim::yuv_abc", 0.0001]])


def _run(trace=TRACE, units=CALLS):
    return RunRecord(config={}, setup_s=1.0, startup={},
                     window=Window(fields=64 * units, units=units,
                                   seconds=1.0),
                     trace=trace)


def _reader(name):
    return spec_mod.metric_reader(spec_mod.Spec.load(ROOT).bench_dir, name)


def test_split_kernels_ms_per_call():
    read = _reader("split_kernels_ms_per_call.gen1")
    # #6-#8 only: not field_streams, not a kernel whose name merely starts
    # like one of them
    assert read(_run()) == pytest.approx(1e3 * 0.0128 / CALLS)
    assert read(_run(trace=None)) is None
    assert read(_run(units=0)) is None
    other = DeviceTrace(window_s=0.05, busy_s=0.03, copy_s=0.0,
                        device_ops=[["cvsim::yuv_front", 0.02]])
    assert read(_run(trace=other)) is None


def test_eager_ms_per_call():
    read = _reader("eager_ms_per_call.gen1")
    # busy 30 ms less 13.1 ms of cvsim:: kernels less 2 ms of copies
    assert read(_run()) == pytest.approx((30.0 - 13.1 - 2.0) / CALLS)
    # a subtraction gone wrong reads below 0, and is not hidden
    short = DeviceTrace(window_s=0.05, busy_s=0.010, copy_s=0.002,
                        device_ops=TRACE.device_ops)
    assert read(_run(trace=short)) == pytest.approx((10.0 - 13.1 - 2.0)
                                                    / CALLS)
    assert read(_run(trace=None)) is None
    assert read(_run(units=0)) is None
