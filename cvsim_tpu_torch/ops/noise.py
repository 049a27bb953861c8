"""Counter-based noise (twin of cvsim_tpu.ops.noise).

Every draw is a pure function of (seed, fieldno, stage, element index): a
splitmix32 counter stream (golden-ratio counter step + murmur3 avalanche).
Output is therefore invariant to GOP batching and restarts, and there is no
global RNG state. The words are bit-equal to the JAX package's.

uint32 arithmetic runs in int64 with `& 0xFFFFFFFF` after every multiply
and add (an int64 product of two u32 values wraps, and its low 32 bits are
right). Stream ids and words are int64 tensors holding u32 values.

The walk recurrence n[t] = (n[t-1] + u[t]) / 2 is a one-pole lowpass with
alpha 0.5, so it runs on the blocked-matmul IIR.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cvsim_tpu_torch.ops.iir import iir_lowpass

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3/splitmix32 avalanche finalizer over u32 (int64 tensor)."""
    x = x.to(torch.int64) & MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    """mix32 of one Python int."""
    x &= MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def key32(key_data) -> int:
    """Collapse PRNG key data (a sequence of u32 words, e.g. [hi, lo]) to
    the engine's u32 stream seed: mix32(kd[0] ^ mix32(kd[-1]))."""
    kd = [int(k) & MASK32 for k in key_data]
    return mix32_int(kd[0] ^ mix32_int(kd[-1]))


def _bits(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """splitmix32 stream: word idx of stream `keys` (broadcasting)."""
    return mix32((keys + ((idx * GOLDEN) & MASK32)) & MASK32)


def _randint_bits(bits: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """bits % span + lo (the reference's rand() % span idiom), int32."""
    return ((bits % (hi - lo)) + lo).to(torch.int32)


def stream_key32(key) -> int:
    """The u32 stream id of a tool seed (the JAX package's noise._key32 of
    it): an int seed, or a PRNG key's raw u32 words."""
    return key32([int(k) for k in np.asarray(key).reshape(-1)])


def randint_stream(key, shape, lo: int, hi: int,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """[shape] int32 in [lo, hi) from stream `key` (an int seed or raw key
    words), word i for flat element i: bit-equal to the JAX package's
    noise.randint_stream and to ops/noise_np.randint_stream."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return _randint_bits(_bits(stream_key32(key), idx), lo,
                         hi).reshape(tuple(shape))


def field_stage_keys(key: int, fieldno: torch.Tensor,
                     stage: int) -> torch.Tensor:
    """Content-addressed per-field stream ids (u32 in int64 [B]): noise for
    field N is a pure function of (seed, N, stage)."""
    base = key ^ mix32_int((stage * 0x632BE59B) & MASK32)
    f = fieldno.to(torch.int64) & MASK32
    return mix32((base + ((f * GOLDEN) & MASK32)) & MASK32)


def randint_per_field(keys: torch.Tensor, shape, lo: int,
                      hi: int) -> torch.Tensor:
    """keys: [B] stream ids. Returns [B, *shape] int32 in [lo, hi)."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    out = _randint_bits(_bits(keys[:, None], idx[None, :]), lo, hi)
    return out.reshape((keys.shape[0],) + shape)


def _shift_in_zero(post: torch.Tensor) -> torch.Tensor:
    """Pre-update walk values [0, n[0], n[1], ...] along the last axis."""
    return torch.cat([torch.zeros_like(post[..., :1]), post[..., :-1]],
                     dim=-1)


def random_walk_per_field(keys: torch.Tensor, n: int, mag: int,
                          dtype=torch.float32) -> torch.Tensor:
    """Per-field post-update walks [B, n]."""
    u = randint_per_field(keys, (n,), -mag, mag + 1)
    return iir_lowpass(u.to(dtype), 0.5, 0.0)


def _row_walks(keys: torch.Tensor, plane_offs, row0: int, l: int, w: int,
               mag: int, dtype) -> torch.Tensor:
    """Smoothed walks [B, P, l, w]: plane p's element (y, x) draws stream
    index plane_offs[p] + (row0 + y)*w + x (u32 wrap)."""
    dev = keys.device
    offs = torch.tensor(plane_offs, dtype=torch.int64, device=dev)
    rows = torch.arange(row0, row0 + l, dtype=torch.int64, device=dev)
    cols = torch.arange(w, dtype=torch.int64, device=dev)
    idx = (offs[:, None, None] + rows[:, None] * w + cols) & MASK32
    u = _randint_bits(_bits(keys[:, None, None, None], idx[None]),
                      -mag, mag + 1)
    return _shift_in_zero(iir_lowpass(u.to(dtype), 0.5, 0.0))


def smoothed_noise_walk_rows(keys: torch.Tensor, l: int, w: int, mag: int,
                             dtype=torch.float32, row0: int = 0,
                             plane_off: int = 0) -> torch.Tensor:
    """Per-scanline smoothed walks [B, l, w]: element (y, x) draws stream
    index plane_off + (row0 + y)*w + x and the walk resets to 0 at each
    line start. A row shard starting at global row row0 draws its rows of
    the whole field's walk."""
    return _row_walks(keys, [plane_off], row0, l, w, mag, dtype)[:, 0]


def chroma_noise_walk_rows(keys: torch.Tensor, l: int, w: int, mag: int,
                           dtype=torch.float32, row0: int = 0,
                           l_glob: int | None = None) -> torch.Tensor:
    """Two per-scanline smoothed walk planes [B, 2, l, w] (I/Q); plane c's
    element (y, x) draws stream index c*l_glob*w + (row0 + y)*w + x, where
    l_glob is the whole field's height (l for an unsharded field)."""
    l_glob = l if l_glob is None else l_glob
    return _row_walks(keys, [0, l_glob * w], row0, l, w, mag, dtype)


def uniform_pm1_per_field(keys: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """[-1, 1) from the top 24 bits of word 0 (exact in float32)."""
    bits = _bits(keys, torch.zeros_like(keys))
    return (bits >> 8).to(dtype) * (2.0 ** -23) - 1.0


def hiss_per_sample(key32: int, start, n: int, c: int, level: int,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Content-addressed iid audio hiss [n, c] in [-level, level]: sample
    t, channel ch draws word (start + t)*c + ch (u32 wrap) of stream
    `key32`, so chunks with a carried sample counter draw the same noise
    as one whole stream. `start`: a Python int or an int64 tensor."""
    t = torch.arange(n, dtype=torch.int64, device=device)
    idx = ((start & MASK32) + t) & MASK32
    ch = torch.arange(c, dtype=torch.int64, device=device)
    stream = ((idx[:, None] * c) & MASK32) + ch
    bits = _bits(torch.tensor(key32, dtype=torch.int64, device=device),
                 stream & MASK32)
    return _randint_bits(bits, -level, level + 1).to(dtype)
