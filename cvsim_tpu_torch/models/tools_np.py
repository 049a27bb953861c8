"""Host-numpy implementations of the sibling pixel tools (the port's copy
of cvsim_tpu/models/tools_np.py).

The reference's sibling tools (ffmpeg_posterize.cpp:789-813,
ffmpeg_colormap.cpp:785-822, ffmpeg_colorkey.cpp:832-887,
ffmpeg_average_delay.cpp:801-838, frameblend.cpp:1032-1081,
filmac.cpp:880-1010, ffmpeg_vhsled.cpp:838-977) are single-pass pixel maps
that run at decode speed on a CPU, so the CLI hot path is plain numpy, as
in the JAX package. Every function is the bit-exact twin of its
models/tools.py / models/restore.py namesake (all-integer math; noise
comes from the shared splitmix32 streams); those torch twins are the
batch path on a device.
"""

from __future__ import annotations

import numpy as np

from cvsim_tpu_torch.ops import noise_np


# ------------------------------------------------------------------ posterize

def posterize(rgb: np.ndarray, threshhold: int) -> np.ndarray:
    """out = channel & ((0xFF << (8 - thr)) & 0xFF) (tools.posterize)."""
    mask = (0xFF << (8 - threshhold)) & 0xFF
    return np.asarray(rgb, np.int32) & mask


# ------------------------------------------------------------------- colormap

def take_colormap(map_rgb) -> np.ndarray:
    """Build the 256-entry LUT from the middle scanline of a map image
    (take_colormap, ffmpeg_colormap.cpp:785-799)."""
    map_rgb = np.asarray(map_rgb)
    h, w, _ = map_rgb.shape
    row = map_rgb[h // 2]
    idx = (np.arange(256) * w) // 256
    return row[idx].astype(np.int32)  # [256, 3]


def colormap_apply(rgb: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Green channel through the 256-entry LUT (tools.colormap_apply)."""
    g = np.asarray(rgb, np.int32)[..., 1]
    return np.asarray(lut, np.int32)[g]


# ------------------------------------------------------------------- colorkey

def colorkey_apply(dst, src, key, *, color: tuple, threshhold: int,
                   invert: bool = False, noisekey: int = 0, fade: int = 0,
                   xdivr: int = 1) -> np.ndarray:
    """One keying layer over a persistent canvas (tools.colorkey_apply)."""
    dst = np.asarray(dst, np.int32)
    src = np.asarray(src, np.int32)
    kc = np.asarray(color, np.int32)
    d = np.abs(src - kc).sum(axis=-1)          # [H, W]

    if xdivr > 1:
        w = d.shape[-1]
        d = d[..., (np.arange(w) // xdivr) * xdivr]

    if noisekey > 0:
        r = noise_np.randint_stream(key, d.shape, 0, 20001)
        hit = r < noisekey
        if xdivr > 1:
            # punch-through persists to the end of its xdivr group
            # (ffmpeg_colorkey.cpp:861-864): prefix-OR within each group
            w = d.shape[-1]
            pad = -w % xdivr
            hp = (np.concatenate(
                [hit, np.zeros(hit.shape[:-1] + (pad,), bool)], axis=-1)
                if pad else hit)
            hp = np.maximum.accumulate(
                hp.reshape(hit.shape[:-1] + (-1, xdivr)), axis=-1)
            hit = hp.reshape(hit.shape[:-1] + (w + pad,))[..., :w]
        d = np.where(hit, 0xFFFF, d)

    if fade != 0:
        dst = (dst * (256 - fade)) >> 8

    keyed = (d < threshhold) if invert else (d >= threshhold)
    return np.where(keyed[..., None], src, dst)


# -------------------------------------------------------------- average_delay

def average_delay_blend(dst, src, field: int, *, newlevel: int,
                        delay: int) -> np.ndarray:
    """(src*n + dst*(256-n) + dither) >> 8 (tools.average_delay_blend)."""
    dst = np.asarray(dst, np.int32)
    src = np.asarray(src, np.int32)
    h, w = dst.shape[:2]
    efield = field // delay
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    # c_div: C truncation-toward-zero; operands here are >= 0 so // matches
    dither = ((((xs ^ ys) + efield) & 3) * 255) // 3
    acc = src * newlevel + dst * (256 - newlevel) + dither[..., None]
    return acc >> 8


# ------------------------------------------------------------------ frameblend

def frameblend_mix(frames, w16, gamma_dec=None, gamma_enc=None) -> np.ndarray:
    """Blend stacked RGB frames by 16.16 weights (restore.frameblend_mix)."""
    fr = np.asarray(frames, np.int64)
    w = np.asarray([wv for _, wv in w16], np.int64)
    if gamma_dec is not None:
        fr = np.asarray(gamma_dec)[fr]
    acc = np.tensordot(w, fr, axes=(0, 0)) >> 16
    if gamma_enc is not None:
        acc = np.asarray(gamma_enc)[np.clip(acc, 0, 8192)]
    return np.clip(acc, 0, 255).astype(np.int32)


# --------------------------------------------------------------------- filmac

def filmac_measure(rgb, gamma_dec=None):
    """Block min/max levels in 16.16 (restore.filmac_measure)."""
    f = np.asarray(rgb, np.int64)
    if gamma_dec is not None:
        f = np.asarray(gamma_dec)[f]
        scaleto = 0x10000 * 8192
    else:
        scaleto = 0x10000 * 256
    lf = f << 16
    h, w = lf.shape[:2]
    minx, maxx = (w * 15) // 100, (w * 90) // 100
    minv = scaleto * 6 // 10
    maxv = scaleto * 4 // 10

    pix_min = lf.min(axis=-1)
    pix_max = lf.max(axis=-1)
    blw = blh = 128
    xe = min(w, minx + (-(-(maxx - minx) // blw)) * blw)
    maxv = max(maxv, int(pix_max[:, minx:xe].max()))

    block_mins = []
    for y0 in range(0, h, blh):
        for x0 in range(minx, maxx, blw):
            blk = pix_min[y0:min(y0 + blh, h), x0:min(x0 + blw, w)]
            grd = blk.size
            block_mins.append((int(blk.sum()) + grd // 2) // grd)
    if block_mins:
        minv = min(minv, min(block_mins))
    if minv == maxv:
        maxv += 1
    return minv, maxv, scaleto


def filmac_rescale(rgb, state, scaleto: int,
                   gamma_dec=None, gamma_enc=None) -> np.ndarray:
    """Linear level rescale (restore.filmac_rescale)."""
    f = np.asarray(rgb, np.int64)
    if gamma_dec is not None:
        f = np.asarray(gamma_dec)[f]
    lf = f << 16
    span = max(1, state.maxv - state.minv)
    v = (lf - state.minv) * scaleto // span
    v = np.clip(v, -0x7FFFFFFF, 0x7FFFFFFF)
    v = np.maximum(v >> 16, 0)
    if gamma_enc is not None:
        v = np.asarray(gamma_enc)[np.clip(v, 0, 8192)]
    return np.clip(v, 0, 255).astype(np.int32)


# --------------------------------------------------------------------- vhsled

def vhsled_dejitter(rgb) -> np.ndarray:
    """Left-edge de-jitter of one RGB frame (restore.vhsled_dejitter,
    ffmpeg_vhsled.cpp:866-928 incl. the blue-channel `blackish` quirk)."""
    f = np.asarray(rgb, np.int32)
    h, w = f.shape[:2]
    ref_blue = f[:, 0:1, 2]
    nb = np.any((f - ref_blue[..., None]) >= 16, axis=-1)

    runs = nb
    for k in range(1, 9):
        shifted = np.pad(nb[:, k:], ((0, 0), (0, k)))
        runs = runs & shifted
    any_run = runs.any(axis=1)
    start = runs.argmax(axis=1)
    adj = np.where(any_run, start, w) << 16

    window = sum(np.roll(adj, -k) for k in range(-4, 5))
    sm = (window + 5) // 9
    ys = np.arange(h)
    adj2 = np.where((ys >= 4) & (ys < h - 4), sm, adj)

    x = np.maximum((adj2 + 0x8000) >> 16, 0)
    shift = np.where(x >= w // 2, 0, x)

    xs = np.arange(w)[None, :]
    idx = (xs + shift[:, None]) % w            # roll left by shift per row
    rolled = f[np.arange(h)[:, None], idx]
    keep_tail = xs >= (w - shift[:, None])
    return np.where(keep_tail[..., None], f, rolled)
