"""Spans from the benchmark's own wrappers, and what the profiler saw.

A traced run wraps calls into the program's layers (`Spans.wrap`): each
call's host wall time is kept by name, and a `record_function` range of
the same name marks it in the profiler's timeline. After the window the
profiler's device activities (kernels, copies, memsets) are reduced to
the union of their intervals inside the window, so that overlapping
activities count once."""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW = "bench.window"


class Spans:
    """Host wall times of wrapped calls, by span name (thread-safe)."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        with record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name].append(dt)

    def mean_ms(self, name: str) -> float | None:
        """Mean host wall of the calls of span `name`, in ms; None where
        there was none."""
        calls = self.seconds.get(name)
        return 1e3 * sum(calls) / len(calls) if calls else None

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


def union(intervals) -> np.ndarray:
    """Disjoint sorted [k, 2] cover of [n, 2] (start, end) intervals."""
    iv = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after every earlier end
    starts_run = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    idx = np.flatnonzero(starts_run)
    run_end = np.concatenate([idx[1:] - 1, [len(iv) - 1]])
    return np.stack([iv[idx, 0], ends[run_end]], axis=1)


def clip(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    iv = np.asarray(intervals, dtype=np.float64).reshape(-1, 2)
    iv = np.stack([np.maximum(iv[:, 0], lo), np.minimum(iv[:, 1], hi)], 1)
    return iv[iv[:, 1] > iv[:, 0]]


def covered(intervals) -> float:
    """Length of the union of the intervals."""
    u = union(intervals)
    return float((u[:, 1] - u[:, 0]).sum()) if len(u) else 0.0


@dataclass
class DeviceTrace:
    """What the profiler saw inside the window, in seconds."""
    window_s: float
    busy_s: float                       # union of every device activity
    copy_s: float                       # union of the memory copies
    device_ops: list = field(default_factory=list)   # [[name, s]], top 10
    idle_gaps: list = field(default_factory=list)    # [[host span, s]]


def _short(name: str, n: int = 96) -> str:
    """A kernel's name without its argument list, at most n characters."""
    if name.startswith("void "):
        name = name[5:]
    head = name.split("(", 1)[0] if not name.startswith("Memcpy") else name
    return head if len(head) <= n else head[:n - 3] + "..."


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or "memcpy" in name.lower()


def reduce_profile(events) -> DeviceTrace:
    """The window's DeviceTrace from the profiler's raw events
    (`prof.profiler.kineto_results.events()`: times in ns; read raw, as
    building the profiler's event tree over a window of a million
    launches takes minutes). The window is the `bench.window` range; idle
    gaps are named by the innermost `bench.*` host span over each gap's
    middle, or "no benchmark span" outside them."""
    from torch.autograd import DeviceType

    window = None
    spans = []
    dev, copies = [], []
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        on_device = e.device_type() == DeviceType.CUDA
        if name.startswith("bench."):
            if on_device:
                continue    # the device-side copy of a benchmark span
            if name == WINDOW:
                window = (t0, t1)
            else:
                spans.append((t0, t1, name[len("bench."):]))
        elif on_device:
            dev.append((t0, t1))
            by_name[_short(name)] += t1 - t0
            if _is_copy(name):
                copies.append((t0, t1))
    if window is None:
        raise RuntimeError("the profiler recorded no bench.window range")
    lo, hi = window
    busy = union(clip(dev, lo, hi))
    gaps = np.stack([np.concatenate([[lo], busy[:, 1]]),
                     np.concatenate([busy[:, 0], [hi]])], 1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    gap_by_span = _name_gaps(gaps, spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(
        window_s=(hi - lo) * 1e-9,
        busy_s=float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9,
        copy_s=covered(clip(copies, lo, hi)) * 1e-9,
        device_ops=[[n, ns * 1e-9] for n, ns in top],
        idle_gaps=[[n, ns * 1e-9] for n, ns in sorted(
            gap_by_span.items(), key=lambda kv: -kv[1])[:10]])


def _name_gaps(gaps: np.ndarray, spans) -> dict[str, float]:
    """Idle time by the innermost host span over each gap's middle."""
    total: dict[str, float] = defaultdict(float)
    if not len(gaps):
        return total
    mids = (gaps[:, 0] + gaps[:, 1]) / 2
    order = np.argsort(mids)
    mids, lens = mids[order], (gaps[:, 1] - gaps[:, 0])[order]
    owner = np.full(len(mids), -1)
    names = sorted({s[2] for s in spans})
    index = {n: k for k, n in enumerate(names)}
    for s0, s1, name in sorted(spans, key=lambda s: s[1] - s[0]):
        a, b = np.searchsorted(mids, [s0, s1])
        seg = owner[a:b]
        seg[seg < 0] = index[name]
    for k, name in enumerate(names):
        if (owner == k).any():
            total[name] = float(lens[owner == k].sum())
    rest = float(lens[owner < 0].sum())
    if rest:
        total["no benchmark span"] = rest
    return total
