"""YUV4MPEG2 (.y4m) reader/writer.

The reference links FFmpeg for container I/O (ffmpeg_to_composite.cpp:
L2 layer, :1966-2118); this environment has no FFmpeg, so the host shim
speaks Y4M — the standard uncompressed interchange format every FFmpeg
build can produce/consume off-box — plus raw planes and image sequences.
An ffmpeg-subprocess backend (host/ffmpeg_pipe.py) activates when an
`ffmpeg` binary exists.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import BinaryIO, Iterator

import numpy as np


@dataclasses.dataclass
class Y4MHeader:
    width: int
    height: int
    fps: Fraction = Fraction(30000, 1001)
    interlacing: str = "p"          # p, t, b, m
    aspect: str = "0:0"
    colorspace: str = "420jpeg"     # 420jpeg/420mpeg2/420paldv/422/444/mono

    @property
    def chroma_shape(self) -> tuple[int, int]:
        if self.colorspace.startswith("420"):
            return self.height // 2, self.width // 2
        if self.colorspace == "422":
            return self.height, self.width // 2
        if self.colorspace == "444":
            return self.height, self.width
        if self.colorspace == "mono":
            return 0, 0
        raise ValueError(f"unsupported colorspace {self.colorspace}")

    def frame_bytes(self) -> int:
        ch, cw = self.chroma_shape
        return self.width * self.height + 2 * ch * cw

    def header_line(self) -> bytes:
        parts = [
            b"YUV4MPEG2",
            f"W{self.width}".encode(),
            f"H{self.height}".encode(),
            f"F{self.fps.numerator}:{self.fps.denominator}".encode(),
            f"I{self.interlacing}".encode(),
            f"A{self.aspect}".encode(),
            f"C{self.colorspace}".encode(),
        ]
        return b" ".join(parts) + b"\n"


def parse_header(line: bytes) -> Y4MHeader:
    parts = line.strip().split(b" ")
    if parts[0] != b"YUV4MPEG2":
        raise ValueError("not a YUV4MPEG2 stream")
    h = Y4MHeader(width=0, height=0)
    for p in parts[1:]:
        tag, val = p[:1], p[1:].decode()
        if tag == b"W":
            h.width = int(val)
        elif tag == b"H":
            h.height = int(val)
        elif tag == b"F":
            num, den = val.split(":")
            h.fps = Fraction(int(num), int(den))
        elif tag == b"I":
            h.interlacing = val
        elif tag == b"A":
            h.aspect = val
        elif tag == b"C":
            h.colorspace = val
    if not h.width or not h.height:
        raise ValueError("missing W/H in Y4M header")
    return h


class Y4MReader:
    """Iterates (y, u, v) uint8 planes per frame. u/v are None for mono."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.header = parse_header(self._read_line())
        self.frame_index = 0
        # FRAME-marker parameters of the most recently yielded frame
        # (e.g. cvsim-av decode -ts emits in-band container timestamps as
        # "Xt=<pts90k>:<dur90k>"), {} when the marker carried none
        self.frame_params: dict = {}

    def _read_line(self) -> bytes:
        buf = bytearray()
        while True:
            c = self.f.read(1)
            if not c:
                raise EOFError("EOF in y4m header")
            if c == b"\n":
                return bytes(buf)
            buf += c

    def __iter__(self) -> Iterator[tuple]:
        h = self.header
        ch, cw = h.chroma_shape
        ybytes = h.width * h.height
        cbytes = ch * cw
        while True:
            line = self.f.read(6)
            if not line:
                return
            if not line.startswith(b"FRAME"):
                raise ValueError(f"bad frame marker {line!r}")
            self.frame_params = {}
            if not line.endswith(b"\n"):
                # frame parameters present; consume to newline
                params = bytearray(line[5:])
                while True:
                    c = self.f.read(1)
                    if not c or c == b"\n":
                        break
                    params += c
                for tok in bytes(params).split():
                    k, sep, v = tok.partition(b"=")
                    if sep:
                        self.frame_params[k.decode()] = v.decode()
            data = self.f.read(ybytes + 2 * cbytes)
            if len(data) < ybytes + 2 * cbytes:
                return
            y = np.frombuffer(data, np.uint8, ybytes).reshape(h.height, h.width)
            if cbytes:
                u = np.frombuffer(data, np.uint8, cbytes, ybytes).reshape(ch, cw)
                v = np.frombuffer(data, np.uint8, cbytes, ybytes + cbytes).reshape(ch, cw)
            else:
                u = v = None
            self.frame_index += 1
            yield y, u, v


class Y4MWriter:
    def __init__(self, f: BinaryIO, header: Y4MHeader,
                 write_header: bool = True):
        # write_header=False appends to an existing stream (checkpoint
        # resume repositions f past the validated header first)
        self.f = f
        self.header = header
        self.frames_written = 0
        if write_header:
            f.write(header.header_line())

    def write(self, y: np.ndarray, u=None, v=None):
        h = self.header
        self.frames_written += 1
        self.f.write(b"FRAME\n")
        self.f.write(np.ascontiguousarray(y, np.uint8).tobytes())
        if u is not None:
            self.f.write(np.ascontiguousarray(u, np.uint8).tobytes())
            self.f.write(np.ascontiguousarray(v, np.uint8).tobytes())
        ch, cw = h.chroma_shape
        if u is None and ch:
            neutral = np.full((ch, cw), 128, np.uint8).tobytes()
            self.f.write(neutral)
            self.f.write(neutral)
