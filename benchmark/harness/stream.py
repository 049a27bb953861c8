"""The render cells' input and output: an endless Y4M stream that cycles a
pool of frames and ends at a deadline, and a sink that counts the frames
written and keeps a sample of whole GOPs for the check."""

from __future__ import annotations

import time
from fractions import Fraction

import numpy as np


def y4m_header(width: int, height: int, fps: Fraction, colorspace: str,
               interlacing: str = "p") -> bytes:
    return (f"YUV4MPEG2 W{width} H{height} F{fps.numerator}:"
            f"{fps.denominator} I{interlacing} A1:1 C{colorspace}\n").encode()


class SyntheticY4M:
    """A read-only binary stream: the Y4M header, then FRAME records that
    cycle `frames` (each the bytes of one frame's planes). Once the clock
    passes `deadline` (time.perf_counter() seconds) the stream ends at the
    next frame boundary; `limit` ends it after that many frames instead."""

    def __init__(self, header: bytes, frames: list[bytes],
                 deadline: float | None = None, limit: int | None = None):
        self._records = [b"FRAME\n" + f for f in frames]
        self._cur = memoryview(header)
        self._pos = 0
        self._next = 0
        self.deadline = deadline
        self.limit = limit
        self.frames_served = 0
        self.ended = False

    def _advance(self) -> bool:
        """Move to the next record; False at the end of the stream."""
        if self.ended:
            return False
        if ((self.limit is not None and self.frames_served >= self.limit)
                or (self.deadline is not None
                    and time.perf_counter() >= self.deadline)):
            self.ended = True
            return False
        self._cur = memoryview(self._records[self._next])
        self._next = (self._next + 1) % len(self._records)
        self._pos = 0
        self.frames_served += 1
        return True

    def read(self, n: int = -1) -> bytes:
        out = []
        while n != 0:
            if self._pos >= len(self._cur) and not self._advance():
                break
            take = len(self._cur) - self._pos if n < 0 else min(
                n, len(self._cur) - self._pos)
            out.append(self._cur[self._pos:self._pos + take])
            self._pos += take
            if n > 0:
                n -= take
            if n < 0 and self.ended:
                break
        return b"".join(out)


class GopSink:
    """A write-only binary stream for a Y4M writer: counts the frames and
    keeps the frames of `keep` GOPs (`gop` frames each), drawn by
    reservoir sampling with `rng`, so that every GOP of the window,
    the last one too, is equally likely to be kept."""

    def __init__(self, frame_bytes: int, gop: int, keep: int,
                 rng: np.random.Generator):
        self.record = 6 + frame_bytes
        self.gop = gop
        self.keep = keep
        self.rng = rng
        self.header = None
        self.pos = 0
        self.kept: dict[int, list] = {}     # GOP index -> list of chunks
        self._slots: list[int | None] = [None] * keep
        self._active = None                 # chunks of the current GOP

    def write(self, b) -> int:
        if self.header is None:
            self.header = bytes(b)
            return len(b)
        frame = self.pos // self.record
        if self.pos % self.record == 0 and frame % self.gop == 0:
            self._start_gop(frame // self.gop)
        if self._active is not None:
            self._active.append(bytes(b))
        self.pos += len(b)
        return len(b)

    def _start_gop(self, g: int):
        slot = g if g < self.keep else int(self.rng.integers(0, g + 1))
        if slot >= self.keep:
            self._active = None
            return
        old = self._slots[slot]
        if old is not None:
            del self.kept[old]
        self._slots[slot] = g
        self._active = self.kept[g] = []

    @property
    def frames(self) -> int:
        return self.pos // self.record

    def kept_frames(self) -> dict[int, bytes]:
        """{frame index: the frame's planes} of the kept GOPs (the FRAME
        markers stripped)."""
        out = {}
        for g, chunks in self.kept.items():
            data = b"".join(chunks)
            for k in range(len(data) // self.record):
                rec = data[k * self.record:(k + 1) * self.record]
                if rec[:6] != b"FRAME\n":
                    raise ValueError(f"frame {g * self.gop + k}: bad marker")
                out[g * self.gop + k] = rec[6:]
        return out
