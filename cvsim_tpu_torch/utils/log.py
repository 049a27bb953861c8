"""Observability (the twin of cvsim_tpu.utils.log).

The reference's only observability is a `\\r Output field N` stderr line
(ffmpeg_to_composite.cpp:1157). The port keeps that exact line for
parity (host/pipeline.py) and adds structured logging, machine-readable
phase lines (CVSIM_PHASES=1), an optional torch.profiler trace
(CVSIM_PROFILE=<dir>) around a whole command, and the recorder below.

**The recorder.** `span(name, gop=, entry=, field=)` times a block,
`count(name, n)` adds to a counter, `event(name, **kv)` marks an instant
(every `phase()` is one); `snapshot()` returns what was recorded and
`reset()` clears it.

- Spans and events are recorded while tracing is on: CVSIM_TRACE=<dir>
  set when this module is imported, `tracing(True)`, or a torch profiler
  active (so a profiled run records them with no other switch). Off,
  `span()` returns one shared no-op context after a flag check.
- A span keeps its name, start and end in ns on the Unix epoch
  (perf_counter_ns plus an offset taken at import, `reset()` and
  `tracing(True)`, the clock of the profiler's events), its thread, its
  parent (the thread's innermost open span), its unit (`gop=<k>`, a
  render's GOP; `field=<k>`, a field of the raw decoder; `call=<k>`, a
  library entry called directly; or its parent's) and the counts its
  thread made while it was open. The last SPAN_BUFFER spans are kept
  (then `dropped` counts); each name's aggregates (count, total ns, self
  ns = duration minus its children's, summed counts) cover every span.
- While a profiler is active each span is also a `cvsim.<name>` range in
  the profiler's CPU timeline, so the device trace's idle gaps fall under
  the program's spans. The range has function scope: a user-scope range
  (`record_function`) gets a device-side copy spanning the kernels it
  launched, which a device-time reader would count as busy time.
- Counters are always counted, into a dict per thread (no count is lost
  between the gen-1 pipeline's three threads); totals sum them. The
  copy helpers `to_device`, `to_host` and `pin` count the bytes that
  cross (`h2d_bytes.pinned|pageable`, `d2h_bytes.pinned|pageable`), the
  host's waits on the card (`syncs`) and the pinned allocations
  (`pinned_allocs`, `pinned_bytes`); the kernel wrappers count
  `launches.<kernel>`.

With CVSIM_TRACE=<dir> each CLI command writes `spans-<pid>-<n>.json`
there (`profile_trace`): a Chrome trace-event file with a `summary` (per
span name count, total and self ms; per thread the busy, blocked (inside
a `*.wait` span) and idle shares of the command's wall; counter totals).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import sys
import threading
import time

SPAN_BUFFER = 1 << 18


def get_logger(name: str = "cvsim") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("CVSIM_LOG", "WARNING").upper())
    return logger


def proc_age() -> float:
    """Seconds since this process started (/proc; 0.0 where unavailable).
    Lets phase lines report true cost-from-exec including interpreter and
    torch import, which time.time() deltas inside the process cannot see."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])        # starttime, field 22 overall
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return uptime - start_ticks / hz
    except (OSError, ValueError, IndexError):
        return 0.0


def phase(name: str, **kv) -> None:
    """Machine-readable phase line (CVSIM_PHASES=1), so that start-up,
    first fetch and steady state read apart instead of differencing two
    subprocess walls. proc_age makes interpreter+import cost visible: a
    one-shot CLI run pays fixed per-process init (the torch import, the
    CUDA context, the kernels' build or load). Also an `event` of the
    recorder."""
    event(name, **kv)
    if os.environ.get("CVSIM_PHASES") == "1":
        extra = "".join(f" {k}={v}" for k, v in kv.items())
        print(f"[phase] {name} t={time.time():.3f}"
              f" proc_age={proc_age():.3f}{extra}",
              file=sys.stderr, flush=True)


# ------------------------------------------------------------ the recorder

class _Recorder:
    """The process's spans, events and counters (one instance, `_REC`)."""

    def __init__(self):
        self.on = bool(os.environ.get("CVSIM_TRACE"))
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.calls = itertools.count()
        self.threads = []       # (thread, its counter dict)
        self.retired = {}       # the counts of threads that have ended
        self.local = threading.local()
        self.clear()

    def clear(self):
        self.offset = time.time_ns() - time.perf_counter_ns()
        self.spans = []         # (name, t0, t1, thread, id, parent, unit,
        self.dropped = 0        #  counts), times on the epoch
        self.events = []        # (name, t, thread, kv)
        self.aggregates = {}    # name: [count, total ns, self ns, counts]

    def thread_state(self):
        """(open span stack, counter dict) of the calling thread."""
        tl = self.local
        try:
            return tl.stack, tl.counts
        except AttributeError:
            tl.stack, tl.counts = [], {}
            with self.lock:
                live = []
                for thread, counts in self.threads:
                    if thread.is_alive():
                        live.append((thread, counts))
                    else:       # it counts no more: fold it in
                        for k, v in counts.items():
                            self.retired[k] = self.retired.get(k, 0) + v
                live.append((threading.current_thread(), tl.counts))
                self.threads = live
            return tl.stack, tl.counts

    def counter_totals(self) -> dict:
        with self.lock:
            parts = [dict(c) for _, c in self.threads] + [dict(self.retired)]
        total: dict = {}
        for part in parts:
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
        return total


_REC = _Recorder()


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def tracing(on: bool) -> None:
    """Record spans and events (on) or only while a profiler is active."""
    if on and not _REC.on:
        _REC.offset = time.time_ns() - time.perf_counter_ns()
    _REC.on = bool(on)


class _Span:
    __slots__ = ("name", "unit", "id", "parent", "stack", "counts",
                 "counts0", "thread", "range", "child_ns", "t0")

    def __init__(self, name, unit, entry):
        self.name = name
        stack, self.counts = _REC.thread_state()
        self.stack = stack
        self.parent = stack[-1] if stack else None
        if unit is not None:
            self.unit = unit
        elif self.parent is not None and self.parent.unit is not None:
            self.unit = self.parent.unit
        elif entry:
            self.unit = f"call={next(_REC.calls)}"
        else:
            self.unit = None

    def __enter__(self):
        self.id = next(_REC.ids)
        self.thread = threading.current_thread().name
        self.counts0 = dict(self.counts)
        self.child_ns = 0
        self.range = None
        if _profiling():
            import torch

            self.range = torch._C._profiler._RecordFunctionFast(
                f"cvsim.{self.name}")
            self.range.__enter__()
        self.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        dur = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        c0 = self.counts0
        counts = {k: v - c0.get(k, 0) for k, v in self.counts.items()
                  if v != c0.get(k, 0)}
        rec = _REC
        with rec.lock:
            agg = rec.aggregates.get(self.name)
            if agg is None:
                agg = rec.aggregates[self.name] = [0, 0, 0, {}]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - self.child_ns
            for k, v in counts.items():
                agg[3][k] = agg[3].get(k, 0) + v
            if len(rec.spans) < SPAN_BUFFER:
                off = rec.offset
                rec.spans.append((
                    self.name, self.t0 + off, t1 + off, self.thread, self.id,
                    None if parent is None else parent.id, self.unit,
                    counts))
            else:
                rec.dropped += 1
        return False


_NOOP = contextlib.nullcontext()


def span(name: str, gop: int | None = None, entry: bool = False,
         field: int | None = None):
    """A context that records the block as span `name` while tracing is
    on (module docstring), and the shared no-op otherwise. `gop=k` sets
    the unit `gop=<k>`, `field=k` the unit `field=<k>`; without either
    the span takes its parent's unit, and a library entry (`entry=True`)
    outside any unit opens `call=<k>`."""
    if not (_REC.on or _profiling()):
        return _NOOP
    unit = (f"gop={gop}" if gop is not None
            else f"field={field}" if field is not None else None)
    return _Span(name, unit, entry)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (always counted, per thread)."""
    counts = _REC.thread_state()[1]
    counts[name] = counts.get(name, 0) + n


def event(name: str, **kv) -> None:
    """An instant `name` with its values, recorded while tracing is on."""
    if not (_REC.on or _profiling()):
        return
    t = time.time_ns()
    with _REC.lock:
        if len(_REC.events) < SPAN_BUFFER:
            _REC.events.append((name, t, threading.current_thread().name,
                                kv))


def snapshot() -> dict:
    """What was recorded: `spans` (dicts: name, start_ns, end_ns, thread,
    id, parent, unit, counts), `dropped`, `events` (name, t_ns, thread,
    args), `aggregates` ({name: {count, total_ns, self_ns, counts}}) and
    `counters` (totals since the process started)."""
    with _REC.lock:
        spans = list(_REC.spans)
        events = list(_REC.events)
        aggs = {k: (a[0], a[1], a[2], dict(a[3]))
                for k, a in _REC.aggregates.items()}
        dropped = _REC.dropped
    keys = ("name", "start_ns", "end_ns", "thread", "id", "parent", "unit",
            "counts")
    return {
        "spans": [dict(zip(keys, s)) for s in spans],
        "dropped": dropped,
        "events": [{"name": n, "t_ns": t, "thread": th, "args": kv}
                   for n, t, th, kv in events],
        "aggregates": {k: {"count": a[0], "total_ns": a[1], "self_ns": a[2],
                           "counts": a[3]} for k, a in aggs.items()},
        "counters": _REC.counter_totals(),
    }


def reset() -> None:
    """Clear the spans, events and aggregates (counters keep counting:
    read them as differences)."""
    with _REC.lock:
        _REC.clear()


# ------------------------------------------------------- counted copies

def to_device(t, device, non_blocking: bool = False):
    """t.to(device, non_blocking=...), counting a host-to-card copy: its
    bytes (pinned or pageable source) and, when blocking, one sync."""
    out = t.to(device, non_blocking=non_blocking)
    if out is not t and t.device.type == "cpu" and out.device.type == "cuda":
        count("h2d_bytes.pinned" if t.is_pinned() else "h2d_bytes.pageable",
              t.nbytes)
        if not non_blocking:
            count("syncs")
    return out


def to_host(t, non_blocking: bool = False):
    """t.to("cpu", non_blocking=...), counting a card-to-host copy: its
    bytes (non_blocking lands in pinned memory) and, when blocking, one
    sync."""
    out = t.to("cpu", non_blocking=non_blocking)
    if out is not t:
        count("d2h_bytes.pinned" if non_blocking else "d2h_bytes.pageable",
              t.nbytes)
        if not non_blocking:
            count("syncs")
    return out


def pin(t):
    """t.pin_memory(), counted (`pinned_allocs`, `pinned_bytes`)."""
    count("pinned_allocs")
    count("pinned_bytes", t.nbytes)
    return t.pin_memory()


# ------------------------------------------------------------- exporters

_TRACES = {"n": 0, "spans": 0}


def _union_ns(intervals) -> int:
    total, end = 0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def summary(snap: dict, wall_ns: int, counters0: dict | None = None) -> dict:
    """The spans file's summary of a snapshot over `wall_ns` of wall time:
    per span name count, total and self ms; per thread the busy, blocked
    (inside a `*.wait` span) and idle shares of the wall; the counters'
    totals since `counters0`."""
    by_thread: dict = {}
    for s in snap["spans"]:
        iv = (s["start_ns"], s["end_ns"])
        spans, waits = by_thread.setdefault(s["thread"], ([], []))
        spans.append(iv)
        if s["name"].endswith(".wait"):
            waits.append(iv)
    wall = max(wall_ns, 1)
    threads = {}
    for name, (spans, waits) in by_thread.items():
        covered = _union_ns(spans) / wall
        blocked = _union_ns(waits) / wall
        threads[name] = {"busy": covered - blocked, "blocked": blocked,
                         "idle": max(0.0, 1.0 - covered)}
    counters0 = counters0 or {}
    return {
        "wall_ms": wall_ns / 1e6,
        "spans": {k: {"count": a["count"], "total_ms": a["total_ns"] / 1e6,
                      "self_ms": a["self_ns"] / 1e6}
                  for k, a in sorted(snap["aggregates"].items())},
        "threads": threads,
        "counters": {k: v - counters0.get(k, 0)
                     for k, v in sorted(snap["counters"].items())
                     if v != counters0.get(k, 0)},
        "dropped": snap["dropped"],
    }


def _write_spans(path: str, snap: dict, wall_ns: int,
                counters0: dict | None = None) -> None:
    """A Chrome trace-event file of a snapshot (Perfetto opens it beside
    the CVSIM_PROFILE trace): `X` events for spans (unit, parent, counts
    in `args`), `i` events for events, and the `summary`."""
    pid = os.getpid()
    tids: dict = {}
    out = []
    for s in snap["spans"]:
        tid = tids.setdefault(s["thread"], len(tids) + 1)
        out.append({"name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                    "ts": s["start_ns"] / 1e3,
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": {"id": s["id"], "parent": s["parent"],
                             "unit": s["unit"], **s["counts"]}})
    for e in snap["events"]:
        tid = tids.setdefault(e["thread"], len(tids) + 1)
        out.append({"name": e["name"], "ph": "i", "s": "t", "pid": pid,
                    "tid": tid, "ts": e["t_ns"] / 1e3,
                    "args": {k: str(v) for k, v in e["args"].items()}})
    out += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}} for name, tid in tids.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms",
                   "summary": summary(snap, wall_ns, counters0)}, f)


@contextlib.contextmanager
def _spans_file(out_dir: str):
    """Trace the block and write its spans to
    `<out_dir>/spans-<pid>-<n>.json`."""
    os.makedirs(out_dir, exist_ok=True)
    _TRACES["spans"] += 1
    path = os.path.join(out_dir,
                        f"spans-{os.getpid()}-{_TRACES['spans']}.json")
    was_on = _REC.on
    reset()
    tracing(True)
    counters0 = _REC.counter_totals()
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        wall = time.perf_counter_ns() - t0
        tracing(was_on)
        _write_spans(path, snapshot(), wall, counters0)
        get_logger().warning("spans written to %s", path)


@contextlib.contextmanager
def profile_trace(out_dir: str | None = None):
    """The traces of one command. CVSIM_PROFILE=/path (or out_dir): a
    torch.profiler trace (CPU activities, and CUDA ones where a card is
    visible) of the enclosed block, as a Chrome trace
    (`trace-<pid>-<n>.json`) there. CVSIM_TRACE=/path: the recorder's
    spans of the block (`spans-<pid>-<n>.json`, `_spans_file`)."""
    out_dir = out_dir or os.environ.get("CVSIM_PROFILE")
    spans_dir = os.environ.get("CVSIM_TRACE")
    with (_spans_file(spans_dir) if spans_dir
          else contextlib.nullcontext()):
        if not out_dir:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if cuda else [])
        os.makedirs(out_dir, exist_ok=True)
        _TRACES["n"] += 1
        path = os.path.join(out_dir,
                            f"trace-{os.getpid()}-{_TRACES['n']}.json")
        with profile(activities=activities) as prof:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        get_logger().warning("profiler trace written to %s", path)
