"""Checkpoint/resume for the streaming video pipelines.

Original obligation: the reference has no checkpointing (SURVEY §5 —
"`-ss/-se/-t` transcode windowing is seek-free packet filtering",
ffmpeg_to_composite.cpp:1368-1376; a crash mid-transcode restarts from
zero). This module adds a resumable host-side cursor around the GOP
pipeline:

- After a GOP's fields are durably written, the writer thread records
  `{next_field, frames_written, base_idx}` plus the carried device state
  (the black-key filter planes — the only frame-sequential carry,
  ffmpeg_to_composite.cpp:974-999) in an atomic sidecar `<out>.ckpt`.
- On restart with the same flags/input, the pipeline truncates the output
  to the recorded frame boundary, seeks the Y4M reader past the consumed
  source frames, restores the carry, and continues at `next_field`.

Correctness relies on two design facts of this framework: noise is
content-addressed per (seed, fieldno, stage) so regenerated fields are
identical regardless of where the run started (ops/noise.py), and the field
clock is a pure function of the source frame index (host/timing.py). A
config/geometry hash guards against resuming with different flags or a
different input.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

CKPT_VERSION = 1


def config_hash(*parts) -> str:
    """Stable digest over reprs of configs/headers; resume refuses on any
    mismatch (different flags => different output stream)."""
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


def save(path: str, meta: dict, arrays: dict[str, np.ndarray]) -> None:
    """Atomic checkpoint write (tmp + rename)."""
    meta = dict(meta, version=CKPT_VERSION)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), np.uint8), **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str):
    """Return (meta, arrays) or None if absent/corrupt/wrong version."""
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta.get("version") != CKPT_VERSION:
                return None
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        return meta, arrays
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None


def clear(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def skip_y4m_frames(reader, n: int) -> None:
    """Advance a Y4MReader past n frames without materializing them.
    Frame payloads are fixed-size, so each skip is a marker read plus one
    relative seek (falls back to reads on unseekable streams)."""
    if n <= 0:
        return
    f = reader.f
    payload = reader.header.frame_bytes()
    seekable = hasattr(f, "seekable") and f.seekable()
    for _ in range(n):
        line = f.read(6)
        if not line:
            raise EOFError("EOF while skipping frames for resume")
        if not line.startswith(b"FRAME"):
            raise ValueError(f"bad frame marker {line!r}")
        if not line.endswith(b"\n"):
            while True:
                c = f.read(1)
                if not c or c == b"\n":
                    break
        if seekable:
            f.seek(payload, os.SEEK_CUR)
        else:
            left = payload
            while left:
                chunk = f.read(min(left, 1 << 20))
                if not chunk:
                    raise EOFError("EOF while skipping frames for resume")
                left -= len(chunk)
    reader.frame_index += n
