"""Observability (the twin of cvsim_tpu.utils.log).

The reference's only observability is a `\\r Output field N` stderr line
(ffmpeg_to_composite.cpp:1157). The port keeps that exact line for
parity (host/pipeline.py) and adds structured logging, machine-readable
phase lines (CVSIM_PHASES=1) and an optional torch.profiler trace
(CVSIM_PROFILE=<dir>) around a whole command.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time


def get_logger(name: str = "cvsim") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("CVSIM_LOG", "WARNING").upper())
    return logger


class Progress:
    """Reference-parity progress line + rate reporting."""

    def __init__(self, label: str = "Output field", stream=sys.stderr,
                 report_every: float = 5.0):
        self.label = label
        self.stream = stream
        self.t0 = time.time()
        self.last_report = self.t0
        self.report_every = report_every
        self.count = 0

    def tick(self, n: int | None = None):
        self.count = self.count + 1 if n is None else n
        now = time.time()
        msg = f"\x0d{self.label} {self.count} "
        if now - self.last_report >= self.report_every:
            rate = self.count / max(1e-9, now - self.t0)
            msg += f"({rate:.1f}/s) "
            self.last_report = now
        print(msg, end="", file=self.stream)

    def done(self):
        dt = time.time() - self.t0
        print(f"\n{self.label}s: {self.count} in {dt:.2f}s "
              f"({self.count / max(1e-9, dt):.1f}/s)", file=self.stream)


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
    CUDA context, the kernels' build or load)."""
    if os.environ.get("CVSIM_PHASES") == "1":
        extra = "".join(f" {k}={v}" for k, v in kv.items())
        print(f"[phase] {name} t={time.time():.3f}"
              f" proc_age={proc_age():.3f}{extra}",
              file=sys.stderr, flush=True)


_TRACES = {"n": 0}


@contextlib.contextmanager
def profile_trace(out_dir: str | None = None):
    """Optional torch.profiler trace (CPU activities, and CUDA ones where a
    card is visible) of the enclosed block: set CVSIM_PROFILE=/path or
    pass out_dir. Writes a Chrome trace (`trace-<pid>-<n>.json`) there."""
    out_dir = out_dir or os.environ.get("CVSIM_PROFILE")
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
