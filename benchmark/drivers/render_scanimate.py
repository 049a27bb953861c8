"""`scanimate -tvstd 1080p60 -inntsc`, the CRT phosphor re-render, on an
endless interlaced NTSC source: the CLI's render loop
(`cli/tools.render_scanimate`: the lockstep field clock, each frame read
and scaled to the raster as int32, batches of 16 fields, one
`scanimate_field` call per parity with the uint8 upload, the warp, the
splat's scatter-adds and the uint8 fetch, the gray RGB, the row-0 rule
and RGB->YUV per field, the writer thread) into an in-memory Y4M sink.

The source cycles a pool of seeded 720x480 4:2:0 frames at 30000/1001
(two fields a frame). The loop is closed: the stream serves the next
frame when the loop asks. Field numbers rotate: batch k (counted from the
warm-up's first) starts at field 180 * effects[k mod E] + 16 * ((k div
E) mod steps), E the number of effects, so that any E consecutive
batches hold each effect once and the mix does not depend on how fast
the program runs. Every batch starts at an even field number and holds
an even number of fields, so the field before a batch is of parity 0.

The check: for each effect one of the window's batches of that effect,
drawn by reservoir as the batches are written; every field written for
it must equal, byte for byte, `reference/scanimate.py`'s frame from the
same pool frame and field number, the field before the batch rendered
too for the row-0 rule. Fields the loop reported but never wrote are
missing."""

from __future__ import annotations

import contextlib
import inspect
import math
import time

import numpy as np
import torch

from cvsim_tpu_torch.cli import tools as cli_tools
from cvsim_tpu_torch.host import y4m
from cvsim_tpu_torch.models import tools
from harness import program, work_scanimate
from harness.core import Window
from harness.judge import Tally
from harness.spec import fraction
from harness.stream import SyntheticY4M, y4m_header
from harness.textures import frame_pool
from reference import host
from reference import scanimate as ref

ENTRY = ("cvsim_tpu_torch.models.tools", "scanimate_field")
FIELDS_PER_EFFECT = 180
# the precision the CLI's calls take (no flag sets it), read before any
# run replaces the entry
PRECISION = inspect.signature(
    tools.scanimate_field).parameters["precision"].default


def small(spec, name: str) -> dict:
    """The CPU tests' size: a 128x72 raster over 48x32 frames from a pool
    of 3, batches of 8 fields, one batch of warm-up."""
    return {"raster": [128, 72],
            "stream": {"width": 48, "height": 32, "pool_frames": 3},
            "batch": 8, "warmup_batches": 1}


def control(config: dict):
    """The reference in scanimate_field's place, the dot positions and the
    cone in bfloat16, the step below the float32 the configuration
    states."""
    def entry(original, src_rgb, dst_h, dst_w, field, fieldnos,
              input_ntsc=False, precision=1):
        return torch.stack([
            ref.field_raster(src, f, dst_h, dst_w, input_ntsc, precision,
                             torch.bfloat16)
            for src, f in zip(src_rgb, fieldnos)])

    return entry


def no_warp(original, *args, **kwargs):
    """The warp hands back its input dots."""
    def unwarped(sx, sy, signal, fieldnos, frame_t):
        return sx.expand_as(signal), sy.expand_as(signal), signal

    with program.patched((tools, "_scanimate_warp", unwarped)):
        return original(*args, **kwargs)


def half_batch(original, *args, **kwargs):
    """The second half of the call's fields comes back zero."""
    out = original(*args, **kwargs).clone()
    out[(out.shape[0] + 1) // 2:] = 0
    return out


def inner_stamp(original, *args, **kwargs):
    """The splat visits only the stamp's inner 4x4, leaving out cells
    inside the cone."""
    splat = tools.splat

    def inner(px, py, sig, radius, r_int, dst_h, dst_w):
        return splat(px, py, sig, radius, r_int - 1, dst_h, dst_w)

    with program.patched((tools, "splat", inner)):
        return original(*args, **kwargs)


def altered(original, *args, **kwargs):
    """One field of the call is altered where it is made (XOR 0x10)."""
    out = original(*args, **kwargs).clone()
    out[0] ^= 0x10
    return out


FAULTS = {"no_warp": no_warp, "half_batch": half_batch,
          "inner_stamp": inner_stamp, "altered": altered}


def run_config(config: dict) -> cli_tools.ScanimateArgs:
    """The configuration's flags through the program's own parser, as its
    CLI parses them; raises where the settings (and scanimate_field's
    precision, which no flag sets) differ from the configuration
    file's."""
    args = cli_tools.parse_scanimate(config["argv"])
    parsed = {"width": args.width, "height": args.height,
              "field_rate_num": args.field_rate.numerator,
              "field_rate_den": args.field_rate.denominator,
              "inntsc": args.inntsc, "use_422_colorspace": args.use_422,
              "precision": PRECISION}
    if parsed != config["render"]:
        raise ValueError(f"{config['name']}: the program parses the flags "
                         f"to {parsed!r}, the configuration states "
                         f"{config['render']!r}")
    return args


class _Source(SyntheticY4M):
    """A SyntheticY4M whose deadline ends it only once `least` frames have
    been served."""

    def __init__(self, header, frames, least: int):
        super().__init__(header, frames)
        self.least = least

    def _advance(self) -> bool:
        if self.frames_served >= self.least:
            return super()._advance()
        deadline, self.deadline = self.deadline, None
        try:
            return super()._advance()
        finally:
            self.deadline = deadline


class BatchSink:
    """A write-only binary stream for the Y4M writer: counts the frames
    and keeps the frames of one batch of each effect, drawn by reservoir
    with `rng` among the batches of that effect (`effect_of(b)`, b the
    batch's index in the stream; None keeps nothing)."""

    def __init__(self, frame_bytes: int, batch: int, effect_of=None,
                 rng=None):
        self.record = 6 + frame_bytes
        self.batch = batch
        self.effect_of = effect_of
        self.rng = rng
        self.header = None
        self.pos = 0
        self.kept: dict[int, list] = {}     # batch index -> chunks
        self._slot: dict[int, int] = {}     # effect -> kept batch index
        self._seen: dict[int, int] = {}     # effect -> batches seen
        self._active = None

    def write(self, b) -> int:
        if self.header is None:
            self.header = bytes(b)
            return len(b)
        frame = self.pos // self.record
        if self.pos % self.record == 0 and frame % self.batch == 0:
            self._start_batch(frame // self.batch)
        if self._active is not None:
            self._active.append(bytes(b))
        self.pos += len(b)
        return len(b)

    def _start_batch(self, b: int):
        self._active = None
        if self.effect_of is None:
            return
        e = self.effect_of(b)
        n = self._seen[e] = self._seen.get(e, 0) + 1
        if n > 1 and int(self.rng.integers(0, n)) != 0:
            return
        old = self._slot.get(e)
        if old is not None:
            del self.kept[old]
        self._slot[e] = b
        self._active = self.kept[b] = []

    @property
    def frames(self) -> int:
        return self.pos // self.record

    def kept_frames(self) -> dict[int, bytes]:
        """{frame index: its planes} of the kept batches' whole frames."""
        out = {}
        for b, chunks in self.kept.items():
            data = b"".join(chunks)
            for k in range(len(data) // self.record):
                rec = data[k * self.record:(k + 1) * self.record]
                if rec[:6] != b"FRAME\n":
                    raise ValueError(f"frame {b * self.batch + k}: "
                                     "bad marker")
                out[b * self.batch + k] = rec[6:]
        return out


class Driver:
    def __init__(self, cell):
        self.cell = cell
        w = cell.workload
        args = run_config(cell.config)
        if w.get("raster"):
            width, height = w["raster"]
            args = args._replace(width=width, height=height)
        self.args = args
        self.batch = w["batch"]
        self.effects = w["effects"]
        self.steps = w["steps"]
        st = w["stream"]
        self.fps = fraction(st["fps"])
        sw, sh = st["width"], st["height"]
        ch, cw = {"420jpeg": (sh // 2, sw // 2),
                  "422": (sh, sw // 2)}[st["colorspace"]]
        self.pool = frame_pool(cell.seed, st["pool_frames"], sw, sh, ch, cw)
        self.pool_bytes = [y.tobytes() + u.tobytes() + v.tobytes()
                           for y, u, v in self.pool]
        self.header = y4m_header(sw, sh, self.fps, st["colorspace"], "b")
        self.out_header = y4m.Y4MHeader(
            width=args.width, height=args.height, fps=args.field_rate,
            interlacing="p", aspect="4:3",
            colorspace="422" if args.use_422 else "420jpeg")
        self.precision = cell.config["render"]["precision"]
        self.least_time = work_scanimate.field_splat(
            args.height, args.width, args.inntsc, self.precision)
        self.k = 0                  # batches started since the warm-up's
        self.k0 = 0                 # the window's first batch
        self.sink = None
        self.returned = 0
        self._rgb = {}

    def start(self, k: int) -> int:
        """Batch k's first field number."""
        e = len(self.effects)
        return (FIELDS_PER_EFFECT * self.effects[k % e]
                + self.batch * ((k // e) % self.steps))

    def _starts(self):
        while True:
            yield self.start(self.k)
            self.k += 1

    def _frames_for(self, batches: int) -> int:
        """Source frames that give `batches` whole batches of fields."""
        return math.ceil(batches * self.batch * self.fps
                         / self.args.field_rate)

    def _render(self, stream, sink) -> int:
        writer = y4m.Y4MWriter(sink, self.out_header)
        return cli_tools.render_scanimate(
            self.args, [y4m.Y4MReader(stream)], writer, self.cell.device,
            self.batch, fields=self._starts())

    def warm_up(self):
        n = self.cell.workload["warmup_batches"]
        stream = SyntheticY4M(self.header, self.pool_bytes,
                              limit=self._frames_for(n))
        self._render(stream, BatchSink(self.out_header.frame_bytes(),
                                       self.batch))

    def window(self, seconds: float) -> Window:
        self.k0 = self.k
        stream = _Source(self.header, self.pool_bytes,
                         least=self._frames_for(len(self.effects)))
        e = len(self.effects)
        self.sink = BatchSink(self.out_header.frame_bytes(), self.batch,
                              lambda b: (self.k0 + b) % e, self.cell.rng)
        t0 = time.perf_counter()
        stream.deadline = t0 + seconds
        self.returned = self._render(stream, self.sink)
        t1 = time.perf_counter()
        fields = self.sink.frames
        return Window(fields=fields, units=-(-fields // self.batch),
                      seconds=t1 - t0)

    @contextlib.contextmanager
    def traced(self, spans):
        """The harness's span around each device call, and the program's
        recorder on for every thread (the writer thread's spans too)."""
        from cvsim_tpu_torch.utils import log

        with program.patched((tools, "scanimate_field",
                              spans.wrap("scanimate_field",
                                         tools.scanimate_field))):
            log.tracing(True)
            try:
                yield
            finally:
                log.tracing(False)

    def samples(self):
        return self.sink.kept_frames()

    def release(self):
        self.pool_bytes = None

    # ------------------------------------------------------------ check

    def _source_rgb(self, frame: int) -> np.ndarray:
        """Pool frame `frame mod pool` as uint8 RGB at the raster."""
        key = frame % len(self.pool)
        if key not in self._rgb:
            self._rgb[key] = host.frame_to_rgb(
                *self.pool[key], self.args.width,
                self.args.height).astype(np.uint8)
        return self._rgb[key]

    def check(self, kept: dict) -> Tally:
        tally = Tally()
        tally.missing += abs(self.returned - self.sink.frames)
        a = self.args
        frames = host.field_frames(self.sink.frames, self.fps, a.field_rate)
        ysz = a.width * a.height
        csz = (a.width // 2) * (a.height if a.use_422 else a.height // 2)
        by_batch: dict[int, list[int]] = {}
        for i in sorted(kept):
            by_batch.setdefault(i // self.batch, []).append(i)
        for b, idx in sorted(by_batch.items()):
            first = self.start(self.k0 + b)
            fieldnos = [first + i - b * self.batch for i in idx]
            prev = None
            if b > 0:
                prev = (self._source_rgb(frames[b * self.batch - 1]),
                        self.start(self.k0 + b - 1) + self.batch - 1)
            want = ref.render([self._source_rgb(frames[i]) for i in idx],
                              fieldnos, a.height, a.width, a.inntsc,
                              a.use_422, prev, self.precision,
                              device=self.cell.device)
            for i, w in zip(idx, want):
                got = kept[i]
                tally.add((got[:ysz], got[ysz:ysz + csz], got[ysz + csz:]),
                          w)
        return tally

