"""Plain reference of the software TV set, `raw28ntsc -s ntsc28`
(ffmpeg_raw28ntsc.cpp), in numpy (torch for the equalization's float
types), written from upstream's description:

- the hsync DC tracker (:556-598): a three-pass one-pole lowpass, a sync-tip
  level that follows down fast and up slowly, and a raw delay line that
  makes up the lowpass's delay, sample by sample;
- the pulse classifier (:625-699): sync pulses by length, vsync at 0.3 H,
  hsync at 0.06 H, equalization at 0.02 H; after 9 vsync or equalization
  pulses the next hsync pulse's centre locks the field; each equalization
  pulse calibrates the black and white levels (1/8 IIR);
- the scanline pacing (:781-791), the per-line hsync re-lock (:793-833)
  and the cursor advance of 240 lines past the lock (:836-845);
- the equalization (:712-717): two float64 truncations a sample;
- the Y/C separation (:725-779): upstream's per-line loop over one
  `int_chroma[4096]` buffer that is never cleared, so the chroma stages
  that read past the line's end read what the line before (in this
  field or the last) left there.

It imports nothing of the program. Departures from upstream:

- Input. Upstream refills a ring buffer from the file as it reads
  (:263-364); a stream decoder sees what has been fed. A field is decoded
  once `raw_length * (height + 30)` samples are buffered, a pulse still
  open at the end of the buffer ends there, and a field with no line
  advances the cursor 240 lines.
- Width. Upstream's preset_NTSC sets the width to the raster's,
  (raw_length + 1) & ~1, over any `-width` (:395-396); here it is an
  argument, as the port honours `-width`.
- Scope. The configuration's flags only: sync, equalization and
  white-point equalization and chroma separation on; no `-nosig`,
  `-showsc`, `-marksig`, and no colour decode (which upstream does not
  have: its chroma is a debug view).
- Output. Upstream encodes through FFmpeg; here a field is the bytes of
  one 4:2:2 Y4M frame: the luma raster, then neutral (128) chroma.
- Precision. `eq_dtype` computes the equalization in another float type
  (the benchmark's control); upstream's is float64 (C `double`).
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

NTSC28 = 315000000.0 * 8.0 / 88.0      # 8 x fsc, samples/s (-s ntsc28)
SYNC = int(192 * 0.25 * 0.5)           # sync level of the detector signal
CHROMA_BUF = 4096                      # upstream's static int_chroma[4096]


def timing(rate: float) -> tuple[float, float, int]:
    """(samples a frame, samples a line, raw_length) of compute_NTSC
    (:249-256): 525 lines at 30000/1001 frames/s."""
    frame = rate / (30000.0 / 1001.0)
    line = frame / 525.0
    return frame, line, int(line + 0.5)


def cdiv(a, b: int):
    """C's integer division of an int array by b > 0 (toward zero)."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


# ------------------------------------------------------------ the tracker

class Tracker:
    """The hsync DC tracker, one sample at a time. `state` (filters,
    dc_level, delay: oldest sample first) starts it mid-stream; without
    it the filters are precharged with one frame of level 128 and the
    delay line holds zeros."""

    def __init__(self, rate: float, state: dict | None = None):
        frame, line, _ = timing(rate)
        cutoff = rate / (line * 0.075 * 0.75)
        dt = 1.0 / rate
        tau = 1.0 / (cutoff * 2.0 * math.pi)
        self.alpha = dt / (tau + dt)
        self.fast = 1.0 / (line * 0.07 * 0.75)
        self.slow = 1.0 / (frame * 0.6)
        n_delay = min(int((line * 0.075 * 0.75) * 0.5), CHROMA_BUF)
        if state is None:
            self.f = [0.0, 0.0, 0.0]
            for _ in range(int(frame)):
                self._lowpass(128.0)
            self.level = 128.0
            self.delay = collections.deque([0] * n_delay)
        else:
            self.f = [float(v) for v in state["filters"]]
            self.level = float(state["dc_level"])
            self.delay = collections.deque(int(v) for v in state["delay"])
            if len(self.delay) != n_delay:
                raise ValueError(f"a delay line of {len(self.delay)} "
                                 f"samples, the rate gives {n_delay}")

    def _lowpass(self, v: float) -> float:
        a, f = self.alpha, self.f
        for i in range(3):
            f[i] = v * a + (f[i] - f[i] * a)
            v = f[i]
        return v

    def process(self, samples) -> tuple[np.ndarray, np.ndarray]:
        """(raw delayed by the line, DC-normalized detector signal), uint8,
        of a chunk of samples."""
        raw = bytearray(len(samples))
        dc = bytearray(len(samples))
        delay = self.delay
        for k, x in enumerate(bytes(samples)):
            v = self._lowpass(float(x))
            r = self.fast if self.level > v else self.slow
            self.level = self.level * (1.0 - r) + v * r
            if delay:
                raw[k] = delay.popleft()
                delay.append(x)
            else:
                raw[k] = x
            dc[k] = min(255, max(0, int(v - self.level)))
        return (np.frombuffer(bytes(raw), np.uint8),
                np.frombuffer(bytes(dc), np.uint8))


# ------------------------------------------------------ sync and levels

def pulses(dc: bytes, k: int):
    """(start, end) of each run of samples below SYNC from sample k on,
    in order; a run open at the end of the buffer ends there."""
    n = len(dc)
    while True:
        while k < n and dc[k] >= SYNC:
            k += 1
        if k >= n:
            return
        s = k
        while k < n and dc[k] < SYNC:
            k += 1
        yield s, k


class Levels:
    """Black (blank) and white levels, calibrated on equalization pulses
    (:660-694)."""

    def __init__(self, blank: float = 0.0, white: float = 192.0):
        self.blank, self.white = blank, white

    def calibrate(self, raw: np.ndarray, dc: np.ndarray):
        """One pulse's window: the mean raw level in the pulse and out of
        it, in C integer division, moved in by 1/8."""
        inside = dc < SYNC
        n_in = int(inside.sum())
        n_out = int((~inside).sum())
        low = int(raw[inside].astype(np.int64).sum()) // n_in if n_in else 0
        high = (int(raw[~inside].astype(np.int64).sum()) // n_out
                if n_out else 0)
        white = int(high + (high - low) / (0.25 + 0.125))
        white = min(max(white, high + 1), 240)
        a = 1.0 / 8.0
        self.white = self.white * (1.0 - a) + white * a
        self.blank = self.blank * (1.0 - a) + high * a


def hunt(raw: np.ndarray, dc: np.ndarray, rl: int, levels: Levels):
    """The sample the field locks on (the centre of the first hsync pulse
    after 9 vsync or equalization pulses), or None."""
    vsync, hsync, eq = int(rl * 0.3), int(rl * 0.06), int(rl * 0.02)
    seen = 0
    skip = -1
    for s, e in pulses(dc.tobytes(), 0):
        if s < skip:
            continue
        length = e - s
        if length >= vsync:
            seen += 1
            skip = max(e, s + vsync)
        elif length >= hsync:
            if seen >= 9:
                return s + length // 2
        elif length >= eq:
            seen += 1
            levels.calibrate(raw[s:s + vsync], dc[s:s + vsync])
            skip = max(e, s + vsync)
    return None


def relock(dcb: bytes, p: int, rl: int) -> tuple[int, bool]:
    """The re-lock of a line due at p: from 0.1 H before it, the centre of
    the next hsync pulse, or (p, True) on 9 vsync or equalization pulses
    (the next field's), or (p, False) when none comes."""
    vsync, hsync, eq = int(rl * 0.3), int(rl * 0.06), int(rl * 0.02)
    seen = 0
    skip = -1
    for s, e in pulses(dcb, max(0, p - int(rl * 0.1))):
        if s < skip:
            continue
        length = e - s
        if length >= vsync:
            seen += 1
            skip = s + vsync
        elif length >= hsync:
            return s + length // 2, False
        elif length >= eq:
            seen += 1
            skip = s + vsync
        if seen >= 9:
            return p, True
    return p, False


def line_starts(dc: np.ndarray, n: int, lock: int, rl: int,
                height: int) -> tuple[list, int]:
    """(each line's first sample, where the scan ended): the fractional
    pacing, then each line re-locked."""
    dcb = dc.tobytes()
    width = float(rl)
    err = 0.0
    starts = []
    p = lock
    for _ in range(height):
        if p + rl * 2 >= n:
            break
        starts.append(p)
        step = int(math.floor(width))
        err += width - step
        if err >= 1.0:
            err -= 1.0
            step += 1
        p += step
        p, next_field = relock(dcb, p, rl)
        if next_field:
            break
    return starts, p


# ------------------------------------------------------------ the lines

def equalize(lines: np.ndarray, blank: float, white: float,
             eq_dtype=torch.float64) -> np.ndarray:
    """(sample - blank) truncated, times 255 over the level span,
    truncated again (:712-717), every operand and result in eq_dtype
    (torch, for its bfloat16)."""
    x = torch.from_numpy(np.ascontiguousarray(lines)).to(eq_dtype)
    b = torch.tensor(blank, dtype=eq_dtype)
    w = torch.tensor(white, dtype=eq_dtype)
    v = torch.trunc(x - b)
    v = torch.trunc((v * 255.0) / (w - b))
    return v.to(torch.int64).numpy()


class Chroma:
    """Upstream's int_chroma[4096], carried from line to line and field to
    field. `tail`: the 16 samples a previous line shifted past the line's
    end (zeros, as the C static, at the start of a stream)."""

    def __init__(self, rl: int, tail=None):
        self.rl = rl
        self.buf = np.zeros(CHROMA_BUF, np.int64)
        if tail is not None:
            self.buf[rl:rl + 16] = np.asarray(tail, np.int64)

    @property
    def tail(self) -> np.ndarray:
        return self.buf[self.rl:self.rl + 16].copy()

    def separate(self, s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(luma, chroma) of one equalized line s (rl + 4 samples). Each
        stage below is one of upstream's loops over x; a whole-line slice
        does the same where the loop reads only samples it has not yet
        written (said at each)."""
        L, c = self.rl, self.buf
        # luma estimate (s[x] + s[x+4] + 1) / 2; chroma the rest (:735-737)
        c[:L] = s[:L] - cdiv(s[:L] + s[4:L + 4] + 1, 2)
        # burst enhancement c[x] + c[x+8] - c[x+4] - c[x+12], x ascending
        # (:741-742): it reads only x+4.., not yet written; past L it
        # reads the previous line's shifted tail
        c[:L] = c[:L] + c[8:L + 8] - c[4:L + 4] - c[12:L + 12]
        # 4 denoise passes c[x] -= (c[x] + c[x+4]) / 2, x ascending
        # (:744-747)
        for _ in range(4):
            c[:L] = c[:L] - cdiv(c[:L] + c[4:L + 4], 2)
        # shift by 16 and renormalize, c[x+16] = c[x] / 4, x descending
        # (:749-751): it reads only x, not yet written; c[0:16] keep their
        # values and c[L:L+16] is the next line's tail
        c[16:L + 16] = cdiv(c[:L], 4)
        chroma = c[:L].copy()
        return s[:L] - chroma, chroma


def decode_lines(lines: np.ndarray, blank: float, white: float, rl: int,
                 width: int, tail=None, eq_dtype=torch.float64):
    """(luma uint8 [N, width], chroma int64 [N, width], the tail left for
    the next line) of N gathered lines (uint8, at least rl + 4 samples
    each), one line after the other."""
    ys = Chroma(rl, tail)
    luma, chroma = [], []
    eq = equalize(np.asarray(lines, np.uint8)[:, :rl + 4], blank, white,
                  eq_dtype)
    for line in eq:
        y, c = ys.separate(line)
        luma.append(np.clip(y[:width], 0, 255).astype(np.uint8))
        chroma.append(c[:width])
    if not luma:
        return (np.zeros((0, width), np.uint8),
                np.zeros((0, width), np.int64), ys.tail)
    return np.stack(luma), np.stack(chroma), ys.tail


# ---------------------------------------------------------- the decoder

class Decoder:
    """The stream decoder. Fresh: from the first sample of a capture, its
    tracker precharged. `state` starts it mid-stream at a field's start:
    the tracker's outputs buffered there ("raw", "dc"), the levels
    ("blank", "white"), the chroma tail ("tail") and, to be fed further,
    the tracker's registers ("tracker", as Tracker takes them)."""

    def __init__(self, rate: float, width: int, height: int,
                 state: dict | None = None, eq_dtype=torch.float64):
        _, _, self.rl = timing(rate)
        self.width, self.height = width, height
        self.eq_dtype = eq_dtype
        if state is None:
            self.tracker = Tracker(rate)
            self.raw = np.zeros(0, np.uint8)
            self.dc = np.zeros(0, np.uint8)
            self.levels = Levels()
            self.tail = None
        else:
            self.tracker = (Tracker(rate, state["tracker"])
                            if "tracker" in state else None)
            self.raw = np.asarray(state["raw"], np.uint8)
            self.dc = np.asarray(state["dc"], np.uint8)
            self.levels = Levels(state["blank"], state["white"])
            self.tail = state["tail"]

    def feed(self, data: bytes):
        raw, dc = self.tracker.process(data)
        self.raw = np.concatenate([self.raw, raw])
        self.dc = np.concatenate([self.dc, dc])

    def decode_field(self) -> np.ndarray | None:
        """The next field's luma raster uint8 [height, width], or None until
        enough samples are buffered."""
        rl, n = self.rl, len(self.raw)
        if n < rl * (self.height + 30):
            return None
        lock = hunt(self.raw, self.dc, rl, self.levels)
        lock = 0 if lock is None else lock
        starts, _ = line_starts(self.dc, n, lock, rl, self.height)
        cursor = min(n, lock + rl * 240)
        if not starts:
            self.raw, self.dc = self.raw[cursor:], self.dc[cursor:]
            return None
        lines = np.stack([self.raw[p:p + rl + 4] for p in starts])
        luma, _, self.tail = decode_lines(
            lines, self.levels.blank, self.levels.white, rl, self.width,
            self.tail, self.eq_dtype)
        self.raw, self.dc = self.raw[cursor:], self.dc[cursor:]
        field = np.zeros((self.height, self.width), np.uint8)
        field[:len(luma)] = luma
        return field


def frame_bytes(field: np.ndarray) -> bytes:
    """One 4:2:2 Y4M frame's planes: the luma raster, then two neutral
    chroma planes of half its width."""
    h, w = field.shape
    return field.tobytes() + bytes([128]) * (2 * h * (w // 2))
