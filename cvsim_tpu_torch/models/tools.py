"""Device ops of the sibling pixel tools (the twin of
cvsim_tpu.models.tools).

- posterize       ffmpeg_posterize.cpp:789-813 (bitwise AND mask)
- colormap        ffmpeg_colormap.cpp:785-822 (256-entry LUT from the middle
                  scanline of a map image, indexed by the green channel)
- colorkey        ffmpeg_colorkey.cpp:832-887 (|dR|+|dG|+|dB| threshold vs a
                  key color, -inv, -noise punch-through, -xd horizontal
                  subsampled decisions, -f fade for feedback trails)
- average_delay   ffmpeg_average_delay.cpp:801-838 (temporal blend with
                  ordered dither ((x^y)+efield)&3)
- scanimate       ffmpeg_scanimate.cpp:817-985 (CRT phosphor-dot re-render
                  with 4 cycling raster-warp effects)

The first four are integer maps over int32 RGB, one frame [H, W, 3] or a
batch [B, H, W, 3], on an explicit `device` (cuda by default); they
equal the JAX package's functions and the host-numpy twins
(models/tools_np.py) bit for bit. The CLI runs those host twins, as the
JAX package's does.

The JAX package splats scanimate's dots with one-hot selection matmuls
(`_splat_matmul`, the TPU's way round its slow scatter) and keeps an
integer scatter-add (`_splat_scatter`) as its oracle; the port splats as
the oracle does, with `index_add_` into an int32 raster. Each stamp value
is truncated to int32 before any sum, so the atomics on the card are
exact in any order. Fields are batched: the dot arrays are [B, dots], one
warp effect chosen per field. While tracing is on (utils/log) a call's
warp is the span `scanimate.warp` and its splat `scanimate.splat`; the
counters `scanimate.dots` and `scanimate.stamp_cells` (the stamp cells
the splat evaluates, dots x the tight stamp's area) always count.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cvsim_tpu_torch.ops.cmath import sqrt_rn

from cvsim_tpu_torch.models.tools_np import take_colormap  # noqa: F401
from cvsim_tpu_torch.ops.cmath import c_div
from cvsim_tpu_torch.ops.noise import randint_stream
from cvsim_tpu_torch.utils import log


def _i32(x, device) -> torch.Tensor:
    """An array or tensor as int32 on `device`."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.int32)


# ------------------------------------------------------------------ posterize

def posterize(rgb, threshhold: int, device="cuda") -> torch.Tensor:
    """out = channel & ((0xFF << (8 - thr)) & 0xFF)."""
    return _i32(rgb, device) & ((0xFF << (8 - threshhold)) & 0xFF)


# ------------------------------------------------------------------- colormap

def colormap_apply(rgb, lut, device="cuda") -> torch.Tensor:
    """Map the green channel through the LUT [256, 3]
    (ffmpeg_colormap.cpp:802-822)."""
    return _i32(lut, device)[_i32(rgb, device)[..., 1].long()]


# ------------------------------------------------------------------- colorkey

def colorkey_apply(dst, src, key, *, color: tuple, threshhold: int,
                   invert: bool = False, noisekey: int = 0, fade: int = 0,
                   xdivr: int = 1, device="cuda") -> torch.Tensor:
    """One layer of retro color keying over a persistent canvas: the new
    canvas, which is also the output frame (the delay ring lives in the
    caller). `key` seeds the punch-through noise (an int or raw key
    words), drawn over the whole decision array as in the JAX package."""
    dst = _i32(dst, device)
    src = _i32(src, device)
    kc = torch.tensor(color, dtype=torch.int32, device=device)
    d = (src - kc).abs().sum(dim=-1, dtype=torch.int32)   # [..., H, W]
    w = d.shape[-1]

    if xdivr > 1:
        # the decision is made on every xdivr'th pixel and held
        held = (torch.arange(w, device=device) // xdivr) * xdivr
        d = d[..., held]

    if noisekey > 0:
        hit = randint_stream(key, d.shape, 0, 20001, device) < noisekey
        if xdivr > 1:
            # the noise overrides the HELD decision (ffmpeg_colorkey.cpp:
            # 861-864), so a hit persists to the end of its xdivr group:
            # prefix-OR within each group, as a running max
            pad = -w % xdivr
            hp = torch.nn.functional.pad(hit.to(torch.int32), (0, pad))
            hp = hp.view(*hit.shape[:-1], -1, xdivr)
            hp = torch.cummax(hp, dim=-1).values
            hit = hp.reshape(*hit.shape[:-1], w + pad)[..., :w] > 0
        d = torch.where(hit, 0xFFFF, d)

    if fade != 0:
        dst = (dst * (256 - fade)) >> 8

    keyed = (d < threshhold) if invert else (d >= threshhold)
    return torch.where(keyed[..., None], src, dst)


# -------------------------------------------------------------- average_delay

def average_delay_blend(dst, src, field, *, newlevel: int, delay: int,
                        device="cuda") -> torch.Tensor:
    """out = (src*n + dst*(256-n) + dither) >> 8 with the ordered dither
    (((x^y)+efield)&3)*255/3, a C (truncating) division
    (ffmpeg_average_delay.cpp:817-838). `field`: an int, or one per frame
    of a batch."""
    dst = _i32(dst, device)
    src = _i32(src, device)
    h, w = dst.shape[-3:-1]
    efield = torch.as_tensor(field, dtype=torch.int32,
                             device=device) // delay
    if efield.dim():
        efield = efield.view(-1, 1, 1)
    xs = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    ys = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    dither = c_div((((xs ^ ys) + efield) & 3) * 255, 3)
    acc = src * newlevel + dst * (256 - newlevel) + dither[..., None]
    return acc >> 8


# ----------------------------------------------------------------- scanimate

FIELDS_PER_EFFECT = 60 * 3   # each effect runs 3 s of 60 fields


def _effects(fieldnos) -> list[tuple[int, int]]:
    """(effect 0..3, field within it) of each field number
    (scanimate_modify_raster, ffmpeg_scanimate.cpp:859-864)."""
    out = []
    for f in fieldnos:
        idx = int(f) // FIELDS_PER_EFFECT
        out.append((idx % 4, int(f) - idx * FIELDS_PER_EFFECT))
    return out


def _scanimate_warp(sx, sy, signal, fieldnos, frame_t):
    """The 4 cycling built-in effects (scanimate_modify_raster,
    ffmpeg_scanimate.cpp:859-894), per field. sx, sy, frame_t: float32
    [n] (the field's undistorted dots), signal: float32 [B, n],
    fieldnos: B ints. Returns (sx, sy, signal), each [B, n].

    Each field's scalar factors are computed in float64 and rounded to
    float32 before they meet the float32 dots, as the JAX package's
    weakly typed scalars are. XLA compiles the JAX package's switch
    branches as one program: it contracts each a * b + c into a fused
    multiply-add (one rounding) and folds the diffuse phase's two
    constant factors into one; `_fma` repeats the one rounding (the
    float32 product is exact in float64), and the diffuse sine and cosine
    are float64's rounded to float32, so that the card and the CPU agree
    and differ from XLA's float32 sine only where that one errs."""
    b, n = signal.shape
    dev = signal.device
    out = [torch.empty((b, n), dtype=torch.float32, device=dev)
           for _ in range(3)]
    two_pi = 2.0 * math.pi
    per_effect: dict = {}
    for k, (effect, ef_field) in enumerate(_effects(fieldnos)):
        per_effect.setdefault(effect, []).append((k, ef_field))

    def column(values):
        return torch.tensor(values, dtype=torch.float64).to(
            dev, torch.float32)[:, None]

    for effect, fields in per_effect.items():
        rows = torch.tensor([k for k, _ in fields], device=dev)
        ef = [e for _, e in fields]
        m = len(fields)
        sig = signal[rows]
        if effect == 0:     # trapezoid
            ef_t = [e / (60.0 * 3.0) for e in ef]
            k = _fma((sy + 1.0) / 2.0, column([1.0 - t for t in ef_t]),
                     column(ef_t))
            new = (sx * k, sy.expand(m, n), sig * k)
        elif effect == 1:   # vrotate
            ef_t = [e / (60.0 * 3.0) for e in ef]
            new = (sx.expand(m, n), sy * column([1.0 - t * 2.0 for t in ef_t]),
                   sig * column([abs(1.0 - t * 2.0) for t in ef_t]))
        elif effect == 2:   # vstretch
            ef_t = [e / (60.0 * 3.0) for e in ef]
            new = (sx.expand(m, n), sy * column([1.0 + t * 12.0 for t in ef_t]),
                   sig)
        else:               # diffuse
            ef_t = column([math.sin(e * two_pi / 59.94) for e in ef])
            phase = (frame_t * float(np.float32(two_pi) * np.float32(6))
                     ).to(torch.float64)
            tenth = torch.tensor(0.1, dtype=torch.float32, device=dev)
            new = (_fma(torch.sin(phase).to(torch.float32) * ef_t, tenth, sx),
                   _fma(torch.cos(phase).to(torch.float32) * ef_t, tenth, sy),
                   sig)
        for o, v in zip(out, new):
            o[rows] = v
    return tuple(out)


def _fma(a, b, c):
    """a * b + c of float32 tensors with one rounding, as a fused
    multiply-add: the product is exact in float64, and the float64 sum
    is rounded once more to float32 (a second rounding that can differ
    from a true fused multiply-add only on an exact float32 tie, about
    once in 2^29)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


@functools.lru_cache(maxsize=16)
def _dot_grid(src_h: int, src_w: int, field: int, input_ntsc: bool,
              precision: int, device: torch.device):
    """The field-invariant dot arrays on `device`: (source pixel index
    [n] int64 into a [src_h * src_w] plane, sx, sy, frame_t float32 [n]),
    built in float64 on the host as the JAX package builds them."""
    ystep = 2 if input_ntsc else 1
    y0 = field if input_ntsc else 0
    ys = np.arange(y0, src_h, ystep)
    xs = np.arange(src_w << precision)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    yy = yy.reshape(-1)
    xx = xx.reshape(-1)

    sx = (xx * 2.0) / (src_w << precision) - 1.0
    sy = (yy * 2.0) / src_h - 1.0
    sy = sy + ((xx * float(ystep)) / (src_w << precision)) / src_h  # CRT slant
    frame_t = (yy * src_w * (1 << precision) + xx).astype(np.float64) / (
        src_w * src_h * (1 << precision))
    pix = yy * src_w + (xx >> precision)
    as_f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (torch.from_numpy(pix.astype(np.int64)).to(device), as_f32(sx),
            as_f32(sy), as_f32(frame_t))


def stamp_radius(dst_h: int, src_h: int, input_ntsc: bool):
    """(dot radius, float32; r_int): the cone's radius and the half-width
    of the tight stamp (offsets -(r_int-1)..r_int on each axis)."""
    dot_radius = (dst_h * (2.05 if input_ntsc else 1.05)) / src_h
    radius = np.maximum(np.float32(dot_radius), np.float32(1.2))
    r_int = int(np.ceil(float(dot_radius if dot_radius > 1.2 else 1.2)))
    return radius, r_int


def scanimate_field(src_rgb, dst_h: int, dst_w: int, field: int, fieldnos,
                    input_ntsc: bool = False, precision: int = 1):
    """Re-render source frames as CRT phosphor dots at warped positions
    (composite_layer, ffmpeg_scanimate.cpp:894-985), on src_rgb's device.

    src_rgb: integer [B, src_h, src_w, 3]; fieldnos: B field numbers.
    Returns grayscale int32 [B, dst_h, dst_w] rasters (>>precision,
    clamped at 255 by the caller's RGB packing)."""
    b, src_h, src_w = src_rgb.shape[:3]
    if len(fieldnos) != b:
        raise ValueError(f"{len(fieldnos)} field numbers for {b} frames")
    dev = src_rgb.device
    pix, sx, sy, frame_t = _dot_grid(src_h, src_w, field, input_ntsc,
                                     precision, dev)
    radius_f, r_int = stamp_radius(dst_h, src_h, input_ntsc)
    # 0-d device tensors: a Python divisor is a reciprocal multiply on the
    # card, a tensor one a true division, as in the JAX package
    radius = torch.tensor(radius_f, device=dev)
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)

    log.count("scanimate.dots", b * pix.numel())
    with log.span("scanimate.warp"):
        green = src_rgb[..., 1].reshape(b, src_h * src_w)
        g = green[:, pix].to(torch.float32) / c255
        sigscal = (dst_w / src_w) * (dst_h / src_h) * 0.9
        sxw, syw, sig = _scanimate_warp(sx, sy, g, fieldnos, frame_t)
        sig = torch.clamp(sig * sigscal, 0.0, 32.0) / radius

        # screen coords
        px = (sxw + 1.0) * dst_w / 2.0
        py = (syw + 1.0) * dst_h / 2.0
    with log.span("scanimate.splat"):
        return splat(px, py, sig, radius, r_int, dst_h, dst_w) >> precision


def splat(px, py, sig, radius, r_int: int, dst_h: int, dst_w: int):
    """Phosphor splat of B fields' dots (px, py, sig: float32 [B, n]) into
    int32 [B, dst_h, dst_w] rasters: each dot adds trunc(255 * sig *
    (radius - dist) / radius) at every pixel of its stamp where that cone
    is positive (cvsim_tpu/models/tools._splat_scatter :223, additive).

    The JAX oracle visits offsets -r_int..r_int+1 on each axis; offset d
    reaches |d - frac(center)| < radius only for d in -(r_int-1)..r_int,
    so the outer ring adds nothing and the stamp here is the tight
    2 * r_int square. One scatter-add pass per stamp offset covers all B
    fields; the per-axis distances, bounds and row bases are computed
    once per offset. A stamp cell outside the cone or the raster adds 0
    at its pixel clamped into the raster, near the dot: zeros sent to
    one address would serialize the card's atomics there (most of a
    stamp's cells lie outside its cone). The distance is cmath.sqrt_rn's
    correctly rounded root, as XLA's is: torch.sqrt on the card is one
    ULP off for some distances, and moved a pixel at 1080p."""
    b, n = px.shape
    dev = px.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    offs = range(-(r_int - 1), r_int + 1)
    base_x = torch.floor(px).to(torch.int32)
    base_y = torch.floor(py).to(torch.int32)
    field0 = (torch.arange(b, device=dev, dtype=torch.int64)
              * (dst_h * dst_w))[:, None]
    cols = []
    for dx in offs:
        ix = base_x + dx
        ddx = ix.to(torch.float32) - px
        cols.append((ddx * ddx, (ix >= 0) & (ix < dst_w),
                     ix.clamp(0, dst_w - 1)))
    rows = []
    for dy in offs:
        iy = base_y + dy
        ddy = iy.to(torch.float32) - py
        rows.append((ddy * ddy, (iy >= 0) & (iy < dst_h),
                     field0 + iy.clamp(0, dst_h - 1).to(torch.int64) * dst_w))
    log.count("scanimate.stamp_cells", b * n * len(offs) ** 2)
    raster = torch.zeros(b * dst_h * dst_w, dtype=torch.int32, device=dev)
    for ddy2, oky, row in rows:
        for ddx2, okx, ix in cols:
            fv = sig * ((radius - sqrt_rn(ddx2 + ddy2)) / radius)
            val = (fv * 255.0).to(torch.int32)
            ok = (fv > 0) & okx & oky
            raster.index_add_(0, (row + ix).reshape(-1),
                              torch.where(ok, val, 0).reshape(-1))
    return raster.reshape(b, dst_h, dst_w)


def scanimate_pack(raster):
    """Clamp the accumulated raster and expand to gray RGB
    (ffmpeg_scanimate.cpp:966-973)."""
    v = torch.clamp(raster, 0, 255).to(torch.int32)
    return torch.stack([v, v, v], dim=-1)
