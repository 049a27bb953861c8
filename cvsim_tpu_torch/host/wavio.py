"""16-bit PCM WAV read/write (the reference outputs PCM S16LE audio,
ffmpeg_to_composite.cpp:2061)."""

from __future__ import annotations

import os
import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns ([N, C] int16, sample_rate)."""
    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2, "only 16-bit PCM supported"
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), np.int16)
        return data.reshape(-1, w.getnchannels()), w.getframerate()


def write_wav(path: str, samples: np.ndarray, rate: int):
    """samples: [N, C] int16-range. Atomic (tmp + rename): checkpoint
    resume skips the audio stage when the output WAV exists, so a file
    must never be observable half-written."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    tmp = path + ".tmp"
    with wave.open(tmp, "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.astype("<i2").tobytes())
    os.replace(tmp, path)
