"""Plain reference of `scanimate` (ffmpeg_scanimate.cpp), the CRT phosphor
re-render, in plain torch on any device (float32, TF32 off), written
from upstream's description:

- composite_layer (:894-985): each source pixel of the field's rows (all
  rows, or with -inntsc those of the field's parity) is 1 << precision
  dots across. Dot (x, y) sits at sx = 2x / (W << p) - 1 and sy = 2y / H
  - 1 plus the CRT slant, ystep * x / (W << p) / H, and carries the
  source's green / 255;
- scanimate_modify_raster (:859-894): effect (field / 180) mod 4, at
  t = (field mod 180) / 180: trapezoid (sx and the signal scaled by
  k = (sy + 1) / 2 * (1 - t) + t), v-rotate (sy by 1 - 2t, the signal by
  |1 - 2t|), v-stretch (sy by 1 + 12t), sine diffuse (sx and sy moved
  by 0.1 * sin(2 pi * (field mod 180) / 59.94) times the sine and the
  cosine of 12 pi * frame_t, frame_t the dot's index over the dots of
  the whole frame);
- the beam: x = (sx + 1) * W_out / 2, y = (sy + 1) * H_out / 2; the
  signal, scaled by (W_out / W) * (H_out / H) * 0.9, clamped to 0..32
  and divided by the dot radius (H_out * 2.05 / H with -inntsc, else
  1.05, at least 1.2);
- phosphor_dot (:817): at every pixel of the stamp, offsets -r..r+1 on
  each axis from the dot's floor (r = ceil(radius)), the cone
  trunc(255 * sig * (radius - dist) / radius) is added where it is
  positive and the pixel lies on the raster;
- the raster shifted right by the precision, clamped to 0..255, gray;
  the copy to the screen starts at row `field` (:965-973), so on a
  field of parity 1 output row 0 keeps what the field before left;
- the output frame: BT.601 RGB -> YUV, chroma taken at even columns
  (and, at 4:2:0, even rows).

It visits upstream's whole stamp, not the tight one the program splats
(offsets -(r-1)..r, where the outer ring adds nothing). It imports
nothing of the program. Where it follows the program's arithmetic
rather than upstream's C:

- The effects' factors (1 - t, |1 - 2t|, 1 + 12t, the diffuse sine) are
  computed in float64 and rounded to float32 before they meet the
  float32 dots, and the diffuse phase is frame_t times float32(2 pi) * 6
  in float32, its sine and cosine float64's rounded to float32: the JAX
  package's weakly typed scalars, which the port holds bit for bit.
- The trapezoid's k and the diffuse moves are multiply-adds rounded
  once (a float64 sum of the exact product, rounded to float32), as
  XLA contracts them.
- The distance is the correctly rounded float32 root (the float64 root
  rounded to float32), as XLA's and the CPU's are.
- Upstream works in double per dot; the dots here are float32, as the
  JAX package's are.

`dtype` computes the dot positions and the cone in another float type
(the benchmark's control: bfloat16, the step below the float32 stated).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import host

F32 = torch.float32
F64 = torch.float64
FIELDS_PER_EFFECT = 180
BLOCK = 1 << 17             # dots a splat step


def parity_of(fieldno: int) -> int:
    return (fieldno & 1) ^ 1


def radius(dst_h: int, src_h: int, inntsc: bool) -> tuple:
    """(the dot radius as float32, r): r = ceil(radius)."""
    r = dst_h * (2.05 if inntsc else 1.05) / src_h
    return max(np.float32(r), np.float32(1.2)), math.ceil(max(r, 1.2))


def dots(src_h: int, src_w: int, parity: int, inntsc: bool,
         precision: int):
    """A field's dots: (the source pixel's row and column, int64 numpy;
    sx, sy, frame_t, float32 numpy), from float64."""
    ystep = 2 if inntsc else 1
    across = src_w << precision
    ys = np.arange(parity if inntsc else 0, src_h, ystep)
    y = np.repeat(ys, across)
    x = np.tile(np.arange(across), len(ys))
    sx = (x * 2.0) / across - 1.0
    sy = (y * 2.0) / src_h - 1.0 + ((x * float(ystep)) / across) / src_h
    frame_t = (y * across + x).astype(np.float64) / (src_h * across)
    f32 = np.float32
    return y, x >> precision, sx.astype(f32), sy.astype(f32), \
        frame_t.astype(f32)


def _f32(v: float, dev) -> torch.Tensor:
    """A float64 scalar rounded to float32, on `dev`."""
    return torch.tensor(v, dtype=F64).to(dev, F32)


def _madd(a, b, c):
    """a * b + c of float32 values, rounded once."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(F32)


def warp(sx, sy, sig, frame_t, fieldno: int):
    """The field's effect on its dots (float32 tensors)."""
    dev = sx.device
    effect = (fieldno // FIELDS_PER_EFFECT) % 4
    within = fieldno % FIELDS_PER_EFFECT
    t = within / (60.0 * 3.0)
    if effect == 0:         # trapezoid
        k = _madd((sy + 1.0) / 2.0, _f32(1.0 - t, dev), _f32(t, dev))
        return sx * k, sy, sig * k
    if effect == 1:         # v-rotate
        return sx, sy * _f32(1.0 - t * 2.0, dev), \
            sig * _f32(abs(1.0 - t * 2.0), dev)
    if effect == 2:         # v-stretch
        return sx, sy * _f32(1.0 + t * 12.0, dev), sig
    amp = _f32(math.sin(within * 2.0 * math.pi / 59.94), dev)   # diffuse
    phase = (frame_t * float(np.float32(2.0 * math.pi) * np.float32(6))
             ).to(F64)
    tenth = _f32(0.1, dev)
    return (_madd(torch.sin(phase).to(F32) * amp, tenth, sx),
            _madd(torch.cos(phase).to(F32) * amp, tenth, sy), sig)


def splat(px, py, sig, rad, r: int, dst_h: int, dst_w: int,
          dtype=F32) -> torch.Tensor:
    """int32 [dst_h * dst_w] raster of the dots' cones over the whole
    stamp, offsets -r..r+1, in blocks of BLOCK dots."""
    dev = px.device
    raster = torch.zeros(dst_h * dst_w, dtype=torch.int32, device=dev)
    offs = torch.arange(-r, r + 2, device=dev)
    rad_t = torch.tensor(rad, dtype=F32, device=dev).to(dtype)
    for k in range(0, px.numel(), BLOCK):
        bx, by, bs = (a[k:k + BLOCK].to(dtype) for a in (px, py, sig))
        ix = torch.floor(px[k:k + BLOCK]).long()[:, None] + offs   # [m, S]
        iy = torch.floor(py[k:k + BLOCK]).long()[:, None] + offs
        dx = ix.to(dtype) - bx[:, None]
        dy = iy.to(dtype) - by[:, None]
        d2 = (dy * dy)[:, :, None] + (dx * dx)[:, None, :]         # [m, S, S]
        dist = (torch.sqrt(d2.to(F64)).to(F32) if dtype == F32
                else torch.sqrt(d2))
        cone = bs[:, None, None] * ((rad_t - dist) / rad_t)
        val = (cone * 255.0).to(torch.int32)
        on = ((cone > 0) & (ix >= 0)[:, None, :] & (ix < dst_w)[:, None, :]
              & (iy >= 0)[:, :, None] & (iy < dst_h)[:, :, None])
        pix = iy[:, :, None] * dst_w + ix[:, None, :]
        raster.index_add_(0, pix[on], val[on])
    return raster


def field_raster(src_rgb: torch.Tensor, fieldno: int, dst_h: int,
                 dst_w: int, inntsc: bool, precision: int = 1,
                 dtype=F32) -> torch.Tensor:
    """One field's raster, int32 [dst_h, dst_w] after the shift and before
    the clamp, from its source frame (uint8 RGB [H, W, 3] at the raster
    it was scaled to), on the source's device."""
    dev = src_rgb.device
    src_h, src_w = src_rgb.shape[:2]
    y, x, sx, sy, frame_t = dots(src_h, src_w, parity_of(fieldno), inntsc,
                                 precision)
    on = lambda a: torch.from_numpy(a).to(dev)
    green = src_rgb[..., 1][on(y), on(x)].to(F32) / torch.tensor(
        255.0, device=dev)
    sx, sy, sig = warp(on(sx), on(sy), green, on(frame_t), fieldno)
    rad, r = radius(dst_h, src_h, inntsc)
    scale = (dst_w / src_w) * (dst_h / src_h) * 0.9
    sig = torch.clamp(sig * scale, 0.0, 32.0) / torch.tensor(
        rad, dtype=F32, device=dev)
    px = (sx + 1.0) * dst_w / 2.0
    py = (sy + 1.0) * dst_h / 2.0
    out = splat(px, py, sig, rad, r, dst_h, dst_w, dtype)
    return (out >> precision).reshape(dst_h, dst_w)


def output_frame(gray: np.ndarray, fieldno: int, prev_row0, use_422: bool):
    """(the field's Y, U, V planes as uint8, its output row 0): `gray`
    clamped to 0..255, row 0 from the field before (`prev_row0`, None
    for the first) on a field of parity 1."""
    g = np.clip(np.asarray(gray), 0, 255).astype(np.int32)
    if parity_of(fieldno) == 1 and prev_row0 is not None:
        g[0] = prev_row0
    y, u, v = host.rgb_to_yuv601(g, g, g)
    rows = slice(None) if use_422 else slice(0, None, 2)
    planes = (y, u[rows, 0::2], v[rows, 0::2])
    return tuple(p.astype(np.uint8) for p in planes), g[0].copy()


def render(sources, fieldnos, dst_h: int, dst_w: int, inntsc: bool,
           use_422: bool, prev=None, precision: int = 1, dtype=F32,
           device="cpu"):
    """The output frames (Y, U, V uint8 planes) of consecutive fields
    `fieldnos`, field k from `sources[k]` (uint8 RGB [H, W, 3] numpy at
    the raster); `prev`: the field before them as (source, fieldno), or
    None where they are the stream's first. The field before must be of
    parity 0 (its row 0 is its own)."""
    row0 = None
    if prev is not None:
        src, f = prev
        if parity_of(f) != 0:
            raise ValueError(f"the field before, {f}, is of parity 1")
        g = field_raster(torch.from_numpy(src).to(device), f, dst_h, dst_w,
                         inntsc, precision, dtype)
        row0 = np.clip(g[0].cpu().numpy(), 0, 255)
    out = []
    for src, f in zip(sources, fieldnos):
        g = field_raster(torch.from_numpy(src).to(device), f, dst_h, dst_w,
                         inntsc, precision, dtype)
        planes, row0 = output_frame(g.cpu().numpy(), f, row0, use_422)
        out.append(planes)
    return out
