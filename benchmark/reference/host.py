"""Plain reference of the gen-2 render's host side, in numpy: the field
clock, the source frame to fields (BT.601 YUV->RGB and the frame scale),
and the output frames (the bob, RGB->YUV, the 4:2:0 packing). Each output
frame comes back as its Y, U and V planes, as a Y4M stream carries
them."""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def frame_pts_to_field(frame_index: int, fps: Fraction,
                       field_rate: Fraction) -> int:
    """A frame's first field: frame_index * field_rate / fps, rounded half
    away from zero (av_rescale's AV_ROUND_NEAR_INF)."""
    q = Fraction(frame_index) * field_rate / fps
    n, d = q.numerator, q.denominator
    return (2 * n + d) // (2 * d) if n >= 0 else -((2 * -n + d) // (2 * d))


def field_frames(n_fields: int, fps: Fraction, field_rate: Fraction):
    """The source frame of each output field 0 .. n_fields-1 of a
    constant-rate source: the last frame whose first field has come."""
    out, frame = [], 0
    nxt = frame_pts_to_field(1, fps, field_rate)
    for n in range(n_fields):
        while n >= nxt:
            frame += 1
            nxt = frame_pts_to_field(frame + 1, fps, field_rate)
        out.append(frame)
    return out


def parity_of(field: int) -> int:
    """Bottom field first: field k's parity is (k & 1) ^ 1."""
    return (field & 1) ^ 1


# ------------------------------------------------------------ colour

def _round_clip(x):
    return np.clip(np.round(x), 0, 255).astype(np.int32)


def yuv_to_rgb601(y, u, v):
    yf = (y.astype(np.float32) - 16.0) * np.float32(255.0 / 219.0)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    r = yf + np.float32(1.402 * (255.0 / 224.0)) * vf
    g = (yf - np.float32(0.344136 * (255.0 / 224.0)) * uf
         - np.float32(0.714136 * (255.0 / 224.0)) * vf)
    b = yf + np.float32(1.772 * (255.0 / 224.0)) * uf
    return _round_clip(r), _round_clip(g), _round_clip(b)


def rgb_to_yuv601(r, g, b):
    rf, gf, bf = (c.astype(np.float32) for c in (r, g, b))
    yl = (np.float32(0.299) * rf + np.float32(0.587) * gf
          + np.float32(0.114) * bf)
    y = yl * np.float32(219.0 / 255.0) + 16.0
    u = (bf - yl) / np.float32(1.772) * np.float32(224.0 / 255.0) + 128.0
    v = (rf - yl) / np.float32(1.402) * np.float32(224.0 / 255.0) + 128.0
    return _round_clip(y), _round_clip(u), _round_clip(v)


def hscale_consts(src_w: int, dst_w: int):
    """Bilinear index/weight constants along one axis; None when equal."""
    if src_w == dst_w:
        return None
    xs = (np.arange(dst_w) + 0.5) * src_w / dst_w - 0.5
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, src_w - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    return x0, x1, (xs - x0).astype(np.float32)


def hscale(plane, dst_w: int):
    """Bilinear resize of [..., W] along the last axis: float32 lerp,
    round half to even, clamp to 0..255."""
    c = hscale_consts(plane.shape[-1], dst_w)
    if c is None:
        return np.asarray(plane, np.int32)
    x0, x1, f = c
    p = np.asarray(plane).astype(np.float32)
    return _round_clip(p[..., x0] + (p[..., x1] - p[..., x0]) * f)


def frame_to_rgb(y, u, v, width: int, height: int):
    """A source frame as RGB [H, W, 3] at the output raster: chroma
    repeated to luma resolution, BT.601 to RGB, then scaled horizontally
    and vertically (frame_copy_scale, ffmpeg_ntsc.cpp:544-607)."""
    yh, yw = y.shape
    u = np.repeat(np.repeat(u, yh // u.shape[0], 0), yw // u.shape[1], 1)
    v = np.repeat(np.repeat(v, yh // v.shape[0], 0), yw // v.shape[1], 1)
    rgb = np.stack(yuv_to_rgb601(y, u, v), axis=-1)
    rgb = np.moveaxis(hscale(np.moveaxis(rgb, -1, 0), width), 0, -1)
    rgbt = np.swapaxes(rgb, 0, 1)
    rgbt = np.moveaxis(hscale(np.moveaxis(rgbt, -1, 0), height), 0, -1)
    return np.swapaxes(rgbt, 0, 1)


def gen2_field(frame_rgb, field: int):
    """The field of output field number `field`: the frame's lines of its
    parity."""
    return frame_rgb[parity_of(field)::2]


def gen2_output(field_rgb, height: int):
    """A processed field as the output frame's Y, U, V (4:2:0): bobbed by
    repeating each line, BT.601 RGB->YUV, chroma taken at even rows and
    columns (YIQPipeline's emit)."""
    frame = np.repeat(field_rgb, 2, axis=0)[:height].astype(np.int32)
    y, u, v = rgb_to_yuv601(frame[..., 0], frame[..., 1], frame[..., 2])
    return (y.astype(np.uint8), u[0::2, 0::2].astype(np.uint8),
            v[0::2, 0::2].astype(np.uint8))
