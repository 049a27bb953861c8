"""Plain building blocks of the reference chains: C integer semantics, the
counter-based noise, the scanline phase table and the one-pole IIR in its
blocked-matmul form.

These are frozen copies of the arithmetic of the port's plain stage path
(the path its tests hold against the JAX package), kept here so that the
yardstick does not move when the program does. Nothing here imports the
program. Every chain runs whole fields (no row shards).

The float32 matrix products run in full float32 (`full_float32`). The
lower-precision control rounds both operands of every product to TF32 (10
mantissa bits, round to nearest even) inside `tf32_products()`, on any
device: what a card's tensor cores do with TF32 on.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32
MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
BLOCK = 128

# Composite virtual sample rates (ffmpeg_to_composite.cpp:377,642).
NTSC_RATE = (315000000.0 * 4) / 88
NTSC_RATE_422 = (315000000.0 * 4) / (88 * 2)

_TF32 = contextvars.ContextVar("reference_tf32_products", default=False)


@contextlib.contextmanager
def tf32_products():
    """Inside this block every matrix product of the reference rounds its
    operands to TF32 first (the lower-precision control)."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def full_float32():
    """The reference's products run in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32.get():
        return torch.matmul(_to_tf32(a), _to_tf32(b))
    return torch.matmul(a, b)


# ------------------------------------------------------------ C semantics

def c_int(x: torch.Tensor) -> torch.Tensor:
    """C double->int: truncation toward zero."""
    return torch.trunc(x)


def c_div(a: torch.Tensor, b) -> torch.Tensor:
    """C integer division: truncation toward zero."""
    return torch.div(a, b, rounding_mode="trunc")


def clampu8(x: torch.Tensor) -> torch.Tensor:
    """clampu8 (ffmpeg_to_composite.cpp:335-342)."""
    if x.is_floating_point():
        x = torch.trunc(x)
    return torch.clamp(x, 0, 255)


def iir_alpha(rate: float, cutoff_hz: float) -> float:
    """LowpassFilter::setFilter (ffmpeg_to_composite.cpp:103-111)."""
    dt = 1.0 / rate
    tau = 1.0 / (cutoff_hz * 2.0 * math.pi)
    return dt / (tau + dt)


# ------------------------------------------------------------ noise

def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3/splitmix32 avalanche over u32 held in int64."""
    x = x.to(torch.int64) & MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    x &= MASK32
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def key32_from_seed(seed: int) -> int:
    """The u32 stream seed of a `-seed` value: mix32(hi ^ mix32(lo)) of
    the key words [seed >> 32, seed & 0xFFFFFFFF]."""
    hi, lo = (seed >> 32) & MASK32, seed & MASK32
    return mix32_int(hi ^ mix32_int(lo))


def _bits(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return mix32((keys + ((idx * GOLDEN) & MASK32)) & MASK32)


def _randint_bits(bits: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return ((bits % (hi - lo)) + lo).to(I32)


def field_stage_keys(key: int, fieldno: torch.Tensor,
                     stage: int) -> torch.Tensor:
    """Per-field stream ids: a pure function of (seed, fieldno, stage)."""
    base = key ^ mix32_int((stage * 0x632BE59B) & MASK32)
    f = fieldno.to(torch.int64) & MASK32
    return mix32((base + ((f * GOLDEN) & MASK32)) & MASK32)


def randint_per_field(keys: torch.Tensor, n: int, lo: int,
                      hi: int) -> torch.Tensor:
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return _randint_bits(_bits(keys[:, None], idx[None, :]), lo, hi)


def random_walk_per_field(keys: torch.Tensor, n: int, mag: int):
    """Post-update walks n[t] = (n[t-1] + u[t]) / 2, [B, n]."""
    u = randint_per_field(keys, n, -mag, mag + 1)
    return iir_lowpass(u.to(F32), 0.5, 0.0)


def row_walks(keys: torch.Tensor, plane_offs, l: int, w: int,
              mag: int) -> torch.Tensor:
    """Smoothed per-line walks [B, P, l, w], pre-update values: plane p's
    element (y, x) draws stream index plane_offs[p] + y*w + x."""
    dev = keys.device
    offs = torch.tensor(plane_offs, dtype=torch.int64, device=dev)
    rows = torch.arange(l, dtype=torch.int64, device=dev)
    cols = torch.arange(w, dtype=torch.int64, device=dev)
    idx = (offs[:, None, None] + rows[:, None] * w + cols) & MASK32
    u = _randint_bits(_bits(keys[:, None, None, None], idx[None]),
                      -mag, mag + 1)
    post = iir_lowpass(u.to(F32), 0.5, 0.0)
    return torch.cat([torch.zeros_like(post[..., :1]), post[..., :-1]],
                     dim=-1)


def uniform_pm1_per_field(keys: torch.Tensor) -> torch.Tensor:
    """[-1, 1) from the top 24 bits of word 0."""
    bits = _bits(keys, torch.zeros_like(keys))
    return (bits >> 8).to(F32) * (2.0 ** -23) - 1.0


# ------------------------------------------------------------ phase

def scanline_phase_xi(fieldno, field_parity, num_lines: int,
                      phase_shift: int, phase_offset: int, ntsc: bool,
                      gen1: bool) -> torch.Tensor:
    """int32 [B, L] subcarrier phase index per line
    (ffmpeg_to_composite.cpp:446-459, ffmpeg_ntsc.cpp:1473-1480)."""
    fieldno = fieldno.to(I32)[:, None]
    parity = field_parity.to(I32)[:, None]
    l = torch.arange(num_lines, dtype=I32, device=fieldno.device)[None, :]
    y = parity + 2 * l
    if not ntsc and gen1:
        return (fieldno + y) & 3
    if phase_shift == 90:
        xi = (fieldno + phase_offset + (y >> 1)) & 3
    elif phase_shift == 180:
        xi = (((fieldno + y) & 2) + phase_offset) & 3
    elif phase_shift == 270:
        xi = (fieldno + phase_offset - (y >> 1)) & 3
    else:
        fill = 0 if gen1 else (phase_offset & 3)
        xi = torch.full_like(y, fill) & 3
    return xi.to(I32)


# ------------------------------------------------------------ one-pole IIR

@functools.lru_cache(maxsize=64)
def _decay_consts(alpha: float):
    """(T [K,K], d [K], pK) float32 numpy: y_block = T x_block + d*carry."""
    a = np.float64(alpha)
    one_m = 1.0 - a
    i = np.arange(BLOCK)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a * one_m ** np.maximum(expo, 0), 0.0)
    d = one_m ** (i + 1.0)
    pk = one_m ** float(BLOCK)
    return T.astype(np.float32), d.astype(np.float32), np.float32(pk)


@functools.lru_cache(maxsize=64)
def _cascade3_consts(alpha: float):
    """Three identical poles composed: (T^3, T^2 d, T d, d, last rows of
    T and T^2), float32 numpy."""
    a = np.float64(alpha)
    one_m = 1.0 - a
    i = np.arange(BLOCK)
    expo = i[:, None] - i[None, :]
    T = np.where(expo >= 0, a * one_m ** np.maximum(expo, 0), 0.0)
    d = one_m ** (i + 1.0)
    T2 = T @ T
    T3 = T2 @ T
    v12 = np.stack([T[BLOCK - 1, :], T2[BLOCK - 1, :]])
    return tuple(c.astype(np.float32)
                 for c in (T3, T2 @ d, T @ d, d, v12))


def _blocks(x: torch.Tensor):
    w = x.shape[-1]
    nb = -(-w // BLOCK)
    pad = nb * BLOCK - w
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x.reshape(x.shape[:-1] + (nb, BLOCK)), nb


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    k = odd.shape[-1]
    both = torch.stack([even[..., :k], odd], dim=-1).flatten(-2)
    return torch.cat([both, even[..., k:]], dim=-1)


def carry_scan(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of y[t] = m*y[t-1] + b[t] from y[-1] = 0 by the
    odd/even recursion of an associative scan."""
    n = b.shape[-1]
    if n < 2:
        return b
    rb = m * b[..., 0:n - 1:2] + b[..., 1::2]
    ob = carry_scan(m * m, rb)
    eb = m * (ob[..., :-1] if n % 2 == 0 else ob) + b[..., 2::2]
    return _interleave(torch.cat([b[..., :1], eb], dim=-1), ob)


def iir_lowpass(x: torch.Tensor, alpha, y0) -> torch.Tensor:
    """y[t] = alpha*x[t] + (1-alpha)*y[t-1], y[-1] = y0, along the last
    axis, 128 samples a block product."""
    dev = x.device
    w = x.shape[-1]
    T_np, d_np, pk = _decay_consts(float(alpha))
    T = torch.from_numpy(T_np).to(dev)
    d = torch.from_numpy(d_np).to(dev)
    pk_t = torch.tensor(pk, dtype=F32, device=dev)
    xb, nb = _blocks(x)
    yw = matmul(xb, T.T)
    y0 = torch.as_tensor(y0, dtype=F32, device=dev).expand(x.shape[:-1])
    last = yw[..., -1]
    if nb <= 16:
        carries = [y0]
        for b in range(nb - 1):
            carries.append(last[..., b] + pk_t * carries[-1])
        c = torch.stack(carries, dim=-1)
    else:
        post = carry_scan(torch.tensor(float(pk), dtype=F32, device=dev),
                          last)
        powers = torch.from_numpy(np.power(np.float64(pk), np.arange(nb))
                                  .astype(np.float32)).to(dev)
        prev = torch.cat([torch.zeros_like(post[..., :1]), post[..., :-1]],
                         dim=-1)
        c = prev + powers * y0[..., None]
    y = yw + d * c[..., None]
    return y.reshape(x.shape[:-1] + (nb * BLOCK,))[..., :w]


def iir_lowpass3(x: torch.Tensor, alpha, y0) -> torch.Tensor:
    """Three identical poles in series (registers reset to y0) as one
    block product; long axes (over 16 blocks) take three single poles."""
    dev = x.device
    w = x.shape[-1]
    nb = -(-w // BLOCK)
    if nb > 16:
        for _ in range(3):
            x = iir_lowpass(x, alpha, y0)
        return x
    T3, dc1, dc2, d, v12 = (torch.from_numpy(c).to(dev)
                            for c in _cascade3_consts(float(alpha)))
    dl, s2, q1 = d[-1], dc2[-1], dc1[-1]
    xb, _ = _blocks(x)
    yw3 = matmul(xb, T3.T)
    u12 = matmul(xb, v12.T)
    u1, u2, u3 = u12[..., 0], u12[..., 1], yw3[..., -1]
    c1 = c2 = c3 = torch.full(x.shape[:-1], float(y0), dtype=F32,
                              device=dev)
    c1s, c2s, c3s = [], [], []
    for b in range(nb):
        c1s.append(c1)
        c2s.append(c2)
        c3s.append(c3)
        nc1 = u1[..., b] + dl * c1
        nc2 = u2[..., b] + s2 * c1 + dl * c2
        nc3 = u3[..., b] + q1 * c1 + s2 * c2 + dl * c3
        c1, c2, c3 = nc1, nc2, nc3
    C1, C2, C3 = (torch.stack(c, dim=-1)[..., None] for c in (c1s, c2s, c3s))
    y = yw3 + dc1 * C1 + dc2 * C2 + d * C3
    return y.reshape(x.shape[:-1] + (nb * BLOCK,))[..., :w]


def cascade_plain(x, alpha, y0, passes: int):
    """`passes` identical poles in series, three at a time."""
    while passes >= 3:
        x = iir_lowpass3(x, alpha, y0)
        passes -= 3
    for _ in range(passes):
        x = iir_lowpass(x, alpha, y0)
    return x


def iir_highpass(x, alpha, y0):
    return x - iir_lowpass(x, alpha, y0)


def cascade_emph(x, alpha, y0, passes: int, gain: float):
    """cascade(x), then s += highpass(s) * gain."""
    s = cascade_plain(x, alpha, y0, passes)
    return s + iir_highpass(s, alpha, y0) * torch.tensor(gain, dtype=F32)


def cascade_unsharp(x, alpha, y0, passes: int, gain: float):
    """x + (x - cascade(x)) * gain."""
    ts = cascade_plain(x, alpha, y0, passes)
    return x + (x - ts) * torch.tensor(gain, dtype=F32)


def delay_writeback(orig, filtered, delay: int):
    """out[i] = filtered[i+delay]; the last `delay` samples keep orig."""
    if delay == 0:
        return filtered
    return torch.cat([filtered[..., delay:], orig[..., -delay:]], dim=-1)
