"""The output side of checkpoint/resume, shared by both pipelines.

A checkpoint counts the frames written before it. It must never outlive
them: the output is flushed and fsynced before each checkpoint is saved,
and a resume first checks that the output still holds every byte the
checkpoint counts. Seeking to that offset and truncating would otherwise
pad a short file with zeros and resume after a run of black frames.
"""

from __future__ import annotations

import io
import os


def sync_output(stream) -> None:
    """Flush `stream` and fsync its file (a pipe or a stream without a
    file descriptor is only flushed)."""
    try:
        stream.flush()
        os.fsync(stream.fileno())
    except (OSError, AttributeError, ValueError, io.UnsupportedOperation):
        pass


def check_output_size(stream, need: int) -> None:
    """Raise ValueError if `stream` holds fewer than `need` bytes."""
    have = stream.seek(0, os.SEEK_END)
    if have < need:
        raise ValueError(
            f"resume: the output holds {have} bytes, but the checkpoint "
            f"counts {need}; it lost frames that the checkpoint says were "
            "written. Delete the checkpoint to start over")
