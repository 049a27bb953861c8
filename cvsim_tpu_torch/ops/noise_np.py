"""Numpy mirrors of the splitmix32 noise streams (the port's copy of
cvsim_tpu/ops/noise_np.py).

The sibling pixel tools run their CLI hot path on the host (a 720x480 AND
mask or LUT is microseconds in numpy). The torch twin (ops/noise.py
`randint_stream`) and these words agree bit for bit, so the host CLI path,
the device path and the tests all see the same noise. `stream_id` takes an
int seed or raw key words (an int array, e.g. a [2] u32 PRNG key's data);
the original also unwraps typed jax keys, which the port never sees.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint32(0x9E3779B9)
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)


def mix32(x) -> np.ndarray:
    """murmur3/splitmix32 avalanche finalizer over uint32 (noise.mix32)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * _C1
        x = (x ^ (x >> np.uint32(13))) * _C2
        return x ^ (x >> np.uint32(16))


def stream_id(key) -> np.uint32:
    """Collapse a seed to one u32 stream id — twin of noise._key32.

    Accepts an int seed or a raw key array (e.g. a [2]u32 PRNG key's
    words)."""
    if isinstance(key, (int, np.integer)):
        kd = np.asarray([key], np.uint32)
    else:
        kd = np.asarray(key)
    kd = kd.astype(np.uint32).reshape(-1)
    return np.uint32(mix32(kd[0] ^ mix32(kd[-1])))


def bits(key32, idx) -> np.ndarray:
    """splitmix32 stream word `idx` of stream `key32` (noise._bits)."""
    with np.errstate(over="ignore"):
        return mix32(np.uint32(key32) + np.asarray(idx, np.uint32) * _GOLDEN)


def randint_bits(b, lo: int, hi: int) -> np.ndarray:
    """bits % span + lo (noise._randint_bits)."""
    span = np.uint32(hi - lo)
    return (np.asarray(b, np.uint32) % span).astype(np.int32) + lo


def randint_stream(key, shape, lo: int, hi: int) -> np.ndarray:
    """[shape] int32 in [lo, hi) from stream `key` (noise.randint_stream)."""
    n = int(np.prod(shape)) if shape else 1
    idx = np.arange(n, dtype=np.uint32)
    return randint_bits(bits(stream_id(key), idx), lo, hi).reshape(shape)


def field_stage_key(key, fieldno: int, stage: int) -> np.uint32:
    """Content-addressed per-field stream id (noise.field_stage_keys for a
    single scalar fieldno)."""
    with np.errstate(over="ignore"):
        base = stream_id(key) ^ mix32(
            np.uint32((stage * 0x632BE59B) & 0xFFFFFFFF))
        return np.uint32(mix32(base + np.uint32(fieldno) * _GOLDEN))
