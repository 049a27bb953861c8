"""The library cells: one caller in a closed loop on the chain's library
entry, with batches of fields already on the card.

Each call takes one batch of a pool of seeded batches, field numbers that
advance call by call and alternating parity (bottom field first, as the
renders number them), and is synchronised before the next call. The
field numbers of the whole window are laid out on the device before it
starts, so that inside the window only the library call runs. A
reservoir sample of calls keeps their outputs for the check."""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from harness import program
from harness.core import Window
from harness.judge import Tally
from reference.config import chain_config

CHUNK = 4096    # calls whose field numbers are laid out at once


def small(spec, name: str) -> dict:
    """The CPU tests' size of a library cell on a chain: `-width 64`,
    GOPs of 4 fields, batches of 4 fields of 240x64 from a pool of 2."""
    cfg = spec.config(spec.cell(name)["config"])
    return {**program.at_width(cfg, 64), "gop": 4, "batch": 4,
            "field_shape": [240, 64], "pool_batches": 2, "warmup_calls": 1,
            "sample_calls": 2}


class TensorDriver:
    """Shared by tensors_gen2 and tensors_gen1: a subclass sets ENTRY (the
    program function it calls, (module, function)), makes `self.pool` (a
    tuple of uint8 tensors [P, B, ...]) and `least_time`, and defines
    `_wrapped` and `_reference`."""

    ENTRY = None

    def __init__(self, cell):
        self.cell = cell
        w = cell.workload
        self.batch = w["batch"]
        self.lines, self.width = w["field_shape"]
        self.n_pool = w["pool_batches"]
        cfg, _ = program.run_config(cell.config)
        self.ccfg = cfg.composite
        from cvsim_tpu_torch.interop import key32_from_seed

        self.key = key32_from_seed(cfg.seed)
        mod, self._entry_name = self.ENTRY
        self._entry_mod = importlib.import_module(mod)
        # even, so that call i's first field is bottom (parity 1)
        self.start = 2 * int(cell.rng.integers(0, 1 << 23))
        self._chunk_at = None
        self.kept = {}

    def _field_numbers(self, i: int):
        """(fieldno, parity) int32 [B] of call i, views into a laid-out
        chunk of CHUNK calls."""
        base = i - i % CHUNK
        if self._chunk_at != base:
            dev = self.cell.device
            first = self.start + base * self.batch
            fn = torch.arange(first, first + CHUNK * self.batch,
                              dtype=torch.int32, device=dev)
            self._fn = fn.view(CHUNK, self.batch)
            self._pa = ((fn & 1) ^ 1).view(CHUNK, self.batch)
            self._chunk_at = base
        return self._fn[i - base], self._pa[i - base]

    def _call(self, i: int):
        fn, pa = self._field_numbers(i)
        inputs = tuple(p[i % self.n_pool] for p in self.pool)
        # looked up at each call, as a caller of the module's function does
        entry = getattr(self._entry_mod, self._entry_name)
        return entry(*inputs, fn, pa, self.key, cfg=self.ccfg)

    def warm_up(self):
        for i in range(self.cell.workload["warmup_calls"]):
            self._call(i)
        self.cell.sync()

    def window(self, seconds: float) -> Window:
        keep = self.cell.workload["sample_calls"]
        rng = self.cell.rng
        self._field_numbers(0)
        self.cell.sync()
        lat = []
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            ts = time.perf_counter()
            out = self._call(i)
            self.cell.sync()
            te = time.perf_counter()
            lat.append(te - ts)
            slot = i if i < keep else int(rng.integers(0, i + 1))
            if slot < keep:
                self.kept = {k: v for k, v in self.kept.items()
                             if v[0] != slot}
                self.kept[i] = (slot, out)
            i += 1
            if te >= deadline:
                break
        return Window(fields=i * self.batch, units=i, seconds=te - t0,
                      latencies=lat)

    @contextlib.contextmanager
    def traced(self, spans):
        with program.patched(*self._wrapped(spans)):
            yield

    def samples(self):
        out = {}
        for i, (_, planes) in self.kept.items():
            planes = planes if isinstance(planes, tuple) else (planes,)
            out[i] = tuple(p.cpu().numpy() for p in planes)
        self.kept = {}
        return out

    def release(self):
        self._fn = self._pa = None
        self._chunk_at = None

    def check(self, kept: dict) -> Tally:
        """Every field of every kept call against the reference's."""
        tally = Tally()
        cfg = chain_config(self.cell.config["composite"])
        for i in sorted(kept):
            first = self.start + i * self.batch
            fieldno = torch.arange(first, first + self.batch,
                                   dtype=torch.int32)
            parity = (fieldno & 1) ^ 1
            inputs = tuple(p[i % self.n_pool] for p in self.pool)
            want = self._reference(inputs, fieldno, parity, cfg)
            for k in range(self.batch):
                tally.add(self._fields_of(kept[i], k),
                          self._fields_of(want, k))
        return tally

    def _fields_of(self, planes, k):
        return tuple(np.asarray(p[k]) for p in planes)
