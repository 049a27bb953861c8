"""`raw28ntsc -s ntsc28`, the software TV set, on an endless jittery 8fsc
capture: the CLI's stream loop (`cli/raw28.decode_stream`: 1 MiB reads,
`Raw28Decoder.feed` through the native DC tracker, `decode_field` with
the host's vsync hunt, AGC, pacing and per-line re-lock, the field's
lines on the card through `decode_lines` and kernel `raw28_tails`, the
fetch, one 4:2:2 Y4M frame a field) into an in-memory sink.

The capture cycles a pool of fields made from the seed at set-up: per
field, serration half-lines, then lines whose lengths jitter, over a DC
drift, with gaussian noise and a chroma-like ripple whose phase moves
from line to line (the structure of `testing.raw28_capture_jittery`).
The loop is closed: the stream serves the next read when the decoder
asks for it. The warm-up decodes the first fields; the window goes on
with the same decoder and the same stream.

The check: a reservoir of the window's fields, the first among them, is
drawn as they start; for each, the decoder's state at its start (the
samples buffered, the levels, the chroma carry) is kept, and the frame
written for it must equal, byte for byte, `reference/raw28.py`'s decode
from that state. TRACKED_CHUNKS chunks the window fed, drawn the same
way, must each give the reference tracker's output from the program's
tracker state before it. The check reads only the frames written and the
states kept."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from cvsim_tpu_torch.cli import raw28 as raw28_cli
from cvsim_tpu_torch.host import y4m
from harness import program
from harness.core import Window
from harness.judge import Tally
from reference import raw28 as ref

ENTRY = ("cvsim_tpu_torch.models.raw28", "decode_lines")

# input fields fed whole that may still be buffered when the stream ends:
# a field is decoded once raw_length * (height + 30) samples are buffered
BUFFERED_FIELDS = 2

# chunks of the window whose tracker outputs are checked: the reference
# tracker is a per-sample loop, about a second a MiB
TRACKED_CHUNKS = 2


def small(spec, name: str) -> dict:
    """The CPU tests' size: a pool of 4 fields, 256 KiB reads, one field
    of warm-up, 4 sampled fields."""
    return {"capture": {"pool_fields": 4}, "chunk": 1 << 18,
            "warmup_fields": 1, "sample_fields": 4}


def control(config: dict):
    """The reference in decode_lines' place, its equalization in
    bfloat16. The step below the float64 that upstream's `double` levels
    state is float32, which changes no byte of this capture: a sample
    moves only where a quotient falls within float32's rounding of an
    integer."""
    def entry(original, raw_lines, blank_level, white_level, *, raw_len,
              width, chroma_carry=None, **flags):
        dev = raw_lines.device
        tail = (None if chroma_carry is None
                else torch.as_tensor(chroma_carry).cpu().numpy())
        luma, chroma, tail = ref.decode_lines(
            raw_lines.cpu().numpy(), blank_level, white_level, raw_len,
            width, tail, torch.bfloat16)
        return (torch.from_numpy(luma).to(dev),
                torch.from_numpy(chroma.astype(np.int32)).to(dev),
                torch.from_numpy(tail.astype(np.int32)).to(dev))

    return entry


def undecoded(original, *args, **kwargs):
    """The field comes back as zeros."""
    out, chroma, carry = original(*args, **kwargs)
    return torch.zeros_like(out), chroma, carry


def half_lines(original, *args, **kwargs):
    """The second half of the field's lines repeats the first."""
    out, chroma, carry = original(*args, **kwargs)
    out = out.clone()
    h = out.shape[0] // 2
    out[h:2 * h] = out[:h]
    return out, chroma, carry


def altered(original, *args, **kwargs):
    """One line of the field is altered where it is made (XOR 0x10)."""
    out, chroma, carry = original(*args, **kwargs)
    out = out.clone()
    out[out.shape[0] // 2] ^= 0x10
    return out, chroma, carry


FAULTS = {"undecoded": undecoded, "half_lines": half_lines,
          "altered": altered}


def run_config(config: dict, device):
    """(Raw28Args, the decoder on `device`) of the configuration's flags
    through the program's own parser, as its CLI builds them; raises
    where the settings differ from those the configuration file states."""
    args = raw28_cli.parse(config["argv"])
    dec = args.decoder(device)
    hdr = args.header()
    parsed = {
        "sample_rate": args.rate, "raw_length": dec.t.raw_length,
        "width": args.width, "height": args.height,
        "use_422_colorspace": args.use_422,
        "sync": not dec.disable_sync, "equalize": dec.equalize,
        "wp_equalize": dec.wp_equalize,
        "separate_chroma": dec.separate_chroma,
        "show_subcarrier": dec.show_subcarrier,
        "decode_color": dec.decode_color, "mark_sync": dec.mark_sync,
        "field_rate_num": hdr.fps.numerator,
        "field_rate_den": hdr.fps.denominator}
    if parsed != config["decoder"]:
        raise ValueError(f"{config['name']}: the program parses the flags "
                         f"to {parsed!r}, the configuration states "
                         f"{config['decoder']!r}")
    return args, dec


def capture_pool(seed: int, cap: dict, rl: int):
    """(uint8 samples of `pool_fields` fields, each field's end offset):
    per field `serrations` half-lines (a sync tip of `serration_pulse`
    H), then `lines` lines of rl +- U{-jitter..jitter} samples: a sync tip
    of `hsync` H, blank, a luma ramp from `luma[0]` to `luma[1]` with a
    ripple of period `ripple_period` samples and amplitude `ripple`
    whose phase steps `ripple_step` rad a line, 8 samples of blank; over
    a sine drift of `drift` levels with a period of `drift_period_fields`
    fields of lines, with gaussian noise of sigma `noise_sigma`."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x28])
    tip, blank = cap["sync_tip"], cap["blank"]
    lo, hi = cap["luma"]
    n_lines = cap["lines"]
    half = np.full(rl // 2, blank, np.uint8)
    half[:int(rl * cap["serration_pulse"])] = tip
    serr = np.tile(half, cap["serrations"])
    hsync = int(rl * cap["hsync"])
    a0 = hsync + int(rl * 0.06)
    period = rl * n_lines * float(cap["drift_period_fields"])
    t = 0
    fields = []
    for _ in range(cap["pool_fields"]):
        ll = rl + rng.integers(-cap["jitter"], cap["jitter"] + 1, n_lines)
        starts = np.concatenate([[0], np.cumsum(ll)[:-1]])
        drift = cap["drift"] * np.sin(2 * np.pi * (t + starts) / period)
        t += int(ll.sum())
        line = np.repeat(np.arange(n_lines), ll)
        x = np.arange(int(ll.sum())) - np.repeat(starts, ll)
        n = (ll - a0 - 8)[line]
        xa = (x - a0).astype(np.float32)
        ramp = (lo + (hi - lo) * xa / n
                + cap["ripple"] * np.sin(2 * np.pi * xa / cap["ripple_period"]
                                         + cap["ripple_step"] * line))
        row = np.where(x < hsync, np.float32(tip), np.float32(blank))
        row = np.where((x >= a0) & (x < a0 + n), ramp, row)
        row = (row + drift[line]
               + cap["noise_sigma"] * rng.standard_normal(len(x), np.float32))
        fields += [serr, np.clip(row, 0, 255).astype(np.uint8)]
    pool = np.concatenate(fields)
    ends = np.cumsum([len(f) for f in fields])[1::2]
    return pool, ends


class CaptureStream:
    """A read-only binary stream that cycles the pool from its start;
    `read` returns b"" once `ended()` is true."""

    def __init__(self, pool: np.ndarray, field_ends: np.ndarray):
        self.pool, self.field_ends = pool, field_ends
        self.pos = 0                # bytes served since the stream began
        self.ended = lambda: False

    def read(self, n: int) -> bytes:
        if self.ended():
            return b""
        k = self.pos % len(self.pool)
        data = self.pool[k:k + n]
        if len(data) < n:
            data = np.concatenate([data, self.pool[:n - len(data)]])
        self.pos += n
        return data.tobytes()

    def fields_fed(self) -> int:
        """Input fields served whole."""
        cycles, k = divmod(self.pos, len(self.pool))
        return (cycles * len(self.field_ends)
                + int(np.searchsorted(self.field_ends, k, side="right")))


class FrameSink:
    """A write-only binary stream for the Y4M writer: counts the frames
    and keeps the planes of the frames whose index is in `keep`."""

    def __init__(self, frame_bytes: int):
        self.record = 6 + frame_bytes
        self.header = None
        self.pos = 0
        self.keep = set()
        self.kept: dict[int, list] = {}
        self._active = None

    def write(self, b) -> int:
        if self.header is None:
            self.header = bytes(b)
            return len(b)
        if self.pos % self.record == 0:
            k = self.pos // self.record
            self._active = (self.kept.setdefault(k, []) if k in self.keep
                            else None)
        if self._active is not None:
            self._active.append(bytes(b))
        self.pos += len(b)
        return len(b)

    @property
    def frames(self) -> int:
        return self.pos // self.record

    def frame(self, k: int) -> bytes | None:
        """Frame k's planes (its FRAME marker stripped), None if it was not
        written whole."""
        data = b"".join(self.kept.get(k, []))
        if len(data) != self.record or data[:6] != b"FRAME\n":
            return None
        return data[6:]


class Driver:
    def __init__(self, cell):
        self.cell = cell
        w = cell.workload
        self.args, self.dec = run_config(cell.config, cell.device)
        self.chunk = w["chunk"]
        self.n_sample = w["sample_fields"]
        pool, ends = capture_pool(cell.seed, w["capture"],
                                  self.dec.t.raw_length)
        self.stream = CaptureStream(pool, ends)
        hdr = self.args.header()
        self.sink = FrameSink(hdr.frame_bytes())
        self.writer = y4m.Y4MWriter(self.sink, hdr)
        self.w0 = 0                 # the sink's index of the window's first
        self.drawn = {}             # reservoir slot -> (field, state)
        self.tracked = {}   # slot -> (tracker state, chunk, (raw, dc))

    def _run(self, ended):
        self.stream.ended = ended
        raw28_cli.decode_stream(self.dec, self.stream, self.writer,
                                self.chunk)

    def warm_up(self):
        n = self.cell.workload["warmup_fields"]
        self._run(lambda: self.sink.frames >= n)

    def window(self, seconds: float) -> Window:
        self.w0 = self.sink.frames
        draw = self._drawing()
        with program.patched((self.dec, "decode_field",
                              self._recorded(self.dec.decode_field, draw)),
                             (self.dec.tracker, "process",
                              self._tracked(self.dec.tracker.process))):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            self._run(lambda: time.perf_counter() >= deadline and
                      self.sink.frames - self.w0 >= self.n_sample)
            t1 = time.perf_counter()
        fields = self.sink.frames - self.w0
        return Window(fields=fields, units=fields, seconds=t1 - t0)

    def _drawing(self):
        """draw(i): the reservoir slot of the window's field i, or None;
        the first field takes its own slot, the others share n_sample - 1
        slots. Each i is drawn once, when its decode first starts."""
        rng, keep = self.cell.rng, self.n_sample - 1
        last = [None, None]

        def draw(i):
            if last[0] != i:
                j = i - 1
                slot = ("first" if i == 0 else j if j < keep
                        else int(rng.integers(0, j + 1)))
                last[:] = [i, slot if slot == "first" or slot < keep
                           else None]
            return last[1]
        return draw

    def _recorded(self, decode_field, draw):
        """decode_field, keeping the decoder's state at the start of each
        drawn field and marking its frame for the sink."""
        def recorded():
            i = self.sink.frames - self.w0
            slot = draw(i)
            if slot is not None:
                raw, dc = self.dec.buffered()
                st = self.dec.state
                state = {"raw": raw, "dc": dc, "blank": st.agc.blank_level,
                         "white": st.agc.white_level,
                         "tail": st.chroma_tail}
            out = decode_field()
            if out is not None and slot is not None:
                old = self.drawn.get(slot)
                if old is not None:
                    self.sink.keep.discard(self.w0 + old[0])
                    self.sink.kept.pop(self.w0 + old[0], None)
                self.drawn[slot] = (i, state)
                self.sink.keep.add(self.w0 + i)
            return out
        return recorded

    def _tracked(self, process):
        """The tracker's process, keeping a reservoir of TRACKED_CHUNKS
        chunks of the window (drawn as the chunks come), each with the
        tracker's state before it."""
        chunks = [0]

        def tracked(data):
            j = chunks[0]
            chunks[0] += 1
            slot = (j if j < TRACKED_CHUNKS
                    else int(self.cell.rng.integers(0, j + 1)))
            if slot >= TRACKED_CHUNKS:
                return process(data)
            state = self.dec.tracker.state()
            out = process(data)
            self.tracked[slot] = (state, data, out)
            return out
        return tracked

    @contextlib.contextmanager
    def traced(self, spans):
        dec = self.dec
        with program.patched(
                (dec, "feed", spans.wrap("feed", dec.feed)),
                (dec, "decode_field",
                 spans.wrap("decode_field", dec.decode_field)),
                (self.writer, "write", spans.wrap("write",
                                                  self.writer.write))):
            yield

    def samples(self):
        return {i: self.sink.frame(self.w0 + i)
                for i, _ in self.drawn.values()}

    def release(self):
        self.dec = None

    def check(self, kept: dict) -> Tally:
        """Each drawn field's frame against the reference's decode from the
        state kept at its start, and each drawn chunk's tracker outputs
        against the reference tracker's; drawn fields never written, and
        input fields fed whole beyond BUFFERED_FIELDS that never came out,
        are missing."""
        tally = Tally()
        a = self.args
        ysz = a.width * a.height
        for i, state in sorted(self.drawn.values(), key=lambda d: d[0]):
            tail = state["tail"]
            state = {**state, "tail": None if tail is None
                     else tail.cpu().numpy()}
            field = ref.Decoder(a.rate, a.width, a.height,
                                state).decode_field()
            want = np.frombuffer(ref.frame_bytes(field), np.uint8)
            got = kept.get(i)
            tally.add(None if got is None else (got[:ysz], got[ysz:]),
                      (want[:ysz], want[ysz:]))
        for _, (state, data, got) in sorted(self.tracked.items()):
            want = ref.Tracker(a.rate, state).process(data)
            tally.add(tuple(g.tobytes() for g in got), want)
        tally.missing += max(0, self.stream.fields_fed() - self.sink.frames
                             - BUFFERED_FIELDS)
        return tally
