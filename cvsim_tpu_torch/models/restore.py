"""Restoration/conversion tools: frameblend, filmac, vhsled (the port's
twin of cvsim_tpu/models/restore.py).

- frameblend   frame-rate conversion by weighted temporal cross-blend
               (frameblend.cpp:929-1081): per output frame, source frames
               overlapping the output interval contribute their overlap as a
               16.16 fixed-point weight; optional near-rate squelch and
               gamma-linear blending via the reference's 256->8192 LUTs.
- filmac       film auto-contrast/AGC (filmac.cpp:880-1010): per-frame
               128x128 block scan over the [15%,90%) x [0,100%) window for
               block-mean min-channel and global max-channel, asymmetric
               temporal IIR of the levels, linear rescale in 16.16.
- vhsled       VHS capture de-jitter (ffmpeg_vhsled.cpp:838-977): per line,
               find the first run of 9 consecutive "non-blackish" pixels
               (vs the line's first pixel), 9-line box smoothing of the
               measured margins, shift each line left by the rounded margin.

The host half (the gamma tables, the weights, the level IIR) is numpy,
copied from the JAX package. The pixel maps are plain torch on an
explicit `device` (cuda by default), int64 throughout as the JAX
package's are, over one frame [H, W, 3] or a batch [B, H, W, 3] (the
blend's K frames are its batch). They equal the JAX functions and the
host-numpy twins (models/tools_np.py) bit for bit.
"""

from __future__ import annotations

import numpy as np

# torch imports live inside the device functions: the restore tools' CLI
# paths run on host-numpy twins (models/tools_np.py) and never import it


# ------------------------------------------------------------------ gamma LUTs

def gamma_tables(gamma: float):
    """The reference's 8-bit -> 13-bit linearization tables
    (frameblend.cpp:697-732)."""
    dec = (np.power(np.arange(256) / 255.0, gamma) * 8192).astype(np.int64)
    enc = (np.power(np.arange(8193) / 8192.0, 1.0 / gamma) * 255).astype(np.int64)
    return dec, enc


# ------------------------------------------------------------------ frameblend

def frameblend_weights(frame_t, current: float, framealt: int = 1,
                       fullframealt: bool = False, squelch: bool = False):
    """Weight list for output interval [current, current+1) —
    frameblend.cpp:929-1023. Host-side (tiny)."""
    weights = []
    cutoff = 0
    n = len(frame_t)
    span = framealt if fullframealt else 1
    if n > 1:
        if framealt > 1:
            i = int(current % framealt)
            while (i + framealt) < n:
                bt, et = frame_t[i], frame_t[i + framealt]
                if i != 0 and (et + 2.0) < current:
                    cutoff = i - (i % framealt)
                bt = min(max(bt, current), current + span)
                et = min(max(et, current), current + span)
                if bt < et:
                    weights.append((i, (et - bt) / span))
                i += framealt
        else:
            for i in range(n - 1):
                bt, et = frame_t[i], frame_t[i + 1]
                if i != 0 and (et + 2.0) < current:
                    cutoff = i
                bt = min(max(bt, current), current + 1)
                et = min(max(et, current), current + 1)
                if bt < et:
                    weights.append((i, et - bt))
    if not weights and n > cutoff:
        weights.append((cutoff, 1.0))

    if squelch and len(weights) in (2, 3):
        bt = frame_t[weights[0][0]]
        et = frame_t[weights[1][0]]
        sq = abs((et - bt) - 1.0) / 0.01
        if sq < 1.0:
            sq = sq ** 2
            w0 = weights[0][1]
            if sq > 0.01:
                w0 = min(w0, sq) / sq
                weights[0] = (weights[0][0], w0)
                weights[1] = (weights[1][0], 1.0 - w0)
            else:
                weights[0] = (weights[0][0], 1.0)
                weights[1] = (weights[1][0], 0.0)
            if len(weights) > 2:
                weights[2] = (weights[2][0], 0.0)
    w16 = [(i, int(np.floor(w * 0x10000 + 0.5))) for i, w in weights]
    return w16, cutoff


def _table(t, device):
    """A gamma table (numpy or tensor) as an int64 tensor on `device`."""
    import torch

    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t,
                           dtype=torch.int64, device=device)


def _frames(rgb, device):
    """A frame, a batch or a list of frames as one int64 tensor."""
    import torch

    if isinstance(rgb, (list, tuple)):
        rgb = torch.stack([torch.as_tensor(np.asarray(f)
                                           if not torch.is_tensor(f) else f)
                           for f in rgb])
    elif not torch.is_tensor(rgb):
        rgb = torch.from_numpy(np.asarray(rgb))
    return rgb.to(device=device, dtype=torch.int64)


def frameblend_mix(frames, w16, gamma_dec=None, gamma_enc=None,
                   device="cuda"):
    """Blend stacked RGB frames [K, H, W, 3] (or a list of K frames) by
    16.16 weights (frameblend.cpp:1032-1081). The JAX package's tensordot
    over K is an int64 weighted sum here: the CUDA backend has no int64
    matrix product, and the sum is exact in any order."""
    import torch

    fr = _frames(frames, device)
    w = torch.tensor([wv for _, wv in w16], dtype=torch.int64,
                     device=device)
    if gamma_dec is not None:
        fr = _table(gamma_dec, device)[fr]
    acc = (fr * w.view(-1, *([1] * (fr.dim() - 1)))).sum(dim=0) >> 16
    if gamma_enc is not None:
        acc = _table(gamma_enc, device)[acc.clamp(0, 8192)]
    return acc.clamp(0, 255).to(torch.int32)


# --------------------------------------------------------------------- filmac

class FilmacState:
    def __init__(self):
        self.init = False
        self.minv = 0
        self.maxv = 0


def filmac_measure(rgb, gamma_dec=None, device="cuda"):
    """Block min/max levels in 16.16 (filmac.cpp:886-923) of one frame
    [H, W, 3] -> (minv, maxv, scaleto), or of a batch [B, H, W, 3] -> a
    list of them. The JAX package fetches each 128x128 block's sum as a
    Python int; here every block's sum comes from one reduction over the
    zero-padded block grid, and the block sums and the region maximum
    cross to the host in one copy a call. The rounding
    (s + grd//2)//grd is the original's."""
    import torch

    f = _frames(rgb, device)
    if gamma_dec is not None:
        f = _table(gamma_dec, device)[f]
        scaleto = 0x10000 * 8192
    else:
        scaleto = 0x10000 * 256
    lf = f << 16
    single = lf.dim() == 3
    if single:
        lf = lf[None]
    h, w = lf.shape[1:3]
    minx, maxx = (w * 15) // 100, (w * 90) // 100
    blw = blh = 128
    # blocks start at minx + k*128 while < maxx and each spans to x0+128,
    # clipped only by the frame width (filmac.cpp:904): the per-pixel max
    # and the block mins both see columns past maxx up to the last block's
    # end
    nbx = -(-(maxx - minx) // blw)
    nby = -(-h // blh)
    xe = min(w, minx + nbx * blw)
    pix_min = lf.amin(dim=-1)[:, :, minx:xe]
    region_max = lf.amax(dim=-1)[:, :, minx:xe].amax(dim=(1, 2))
    grid = torch.nn.functional.pad(
        pix_min, (0, minx + nbx * blw - xe, 0, nby * blh - h))
    sums = grid.view(-1, nby, blh, nbx, blw).sum(dim=(2, 4))
    host = torch.cat([sums.reshape(len(lf), -1), region_max[:, None]],
                     dim=1).tolist()
    rows = np.minimum(np.arange(nby) * blh + blh, h) - np.arange(nby) * blh
    x0s = minx + np.arange(nbx) * blw
    cols = np.minimum(x0s + blw, w) - x0s
    grd = (rows[:, None] * cols[None, :]).reshape(-1).tolist()
    out = []
    for vals in host:
        minv = scaleto * 6 // 10
        maxv = max(scaleto * 4 // 10, int(vals[-1]))
        block_mins = [(s + g // 2) // g for s, g in zip(vals[:-1], grd)]
        if block_mins:
            minv = min(minv, min(block_mins))
        if minv == maxv:
            maxv += 1
        out.append((minv, maxv, scaleto))
    return out[0] if single else out


def filmac_update_levels(state: FilmacState, minv: int, maxv: int):
    """Asymmetric temporal smoothing (filmac.cpp:927-942): max rises fast
    (avg/2) and falls slow (4:1); min falls fast and rises slow."""
    if not state.init:
        state.init = True
        state.minv, state.maxv = minv, maxv
    else:
        if state.maxv < maxv:
            state.maxv = (state.maxv + maxv) // 2
        else:
            state.maxv = (state.maxv * 4 + maxv) // 5
        if state.minv > minv:
            state.minv = (state.minv + minv) // 2
        else:
            state.minv = (state.minv * 4 + minv) // 5
    return state


def filmac_rescale(rgb, state: FilmacState, scaleto: int,
                   gamma_dec=None, gamma_enc=None, device="cuda"):
    """Linear level rescale (filmac.cpp:946-954, output at :980-1009)."""
    import torch

    f = _frames(rgb, device)
    if gamma_dec is not None:
        f = _table(gamma_dec, device)[f]
    lf = f << 16
    span = max(1, state.maxv - state.minv)
    v = torch.div((lf - state.minv) * scaleto, span, rounding_mode="floor")
    v = v.clamp(-0x7FFFFFFF, 0x7FFFFFFF)
    v = (v >> 16).clamp(min=0)
    if gamma_enc is not None:
        v = _table(gamma_enc, device)[v.clamp(0, 8192)]
    return v.clamp(0, 255).to(torch.int32)


# --------------------------------------------------------------------- vhsled

def vhsled_dejitter(rgb, device="cuda"):
    """Left-edge de-jitter of RGB frames [..., H, W, 3]
    (ffmpeg_vhsled.cpp:866-928).

    blackish(p, ref) keeps the reference's quirk of comparing every
    channel of p against the *blue* channel of the line's first pixel
    (the `c >>= 8` typo at :686 shifts the diff, not ref). Each row's
    left shift is a gather at (x + shift) % w, where the JAX package
    rolls rows with its barrel shifter."""
    import torch

    f = _frames(rgb, device).to(torch.int32)
    h, w = f.shape[-3:-1]
    ref_blue = f[..., 0:1, 2]          # ARGB blue = lowest byte = our [...,2]
    # blackish: all three channels have (chan - ref_blue) < 16
    nb = ((f - ref_blue[..., None]) >= 16).any(dim=-1)   # non-blackish

    # first run of 9 consecutive non-blackish pixels per row
    runs = nb
    for k in range(1, 9):
        runs = runs & torch.nn.functional.pad(nb[..., k:], (0, k))
    any_run = runs.any(dim=-1)
    start = runs.to(torch.uint8).argmax(dim=-1)
    adj = torch.where(any_run, start, w) << 16     # adj[y] = x << 16

    # 9-line box smoothing for y in [4, h-4)
    window = sum(torch.roll(adj, -k, dims=-1) for k in range(-4, 5))
    sm = torch.div(window + 5, 9, rounding_mode="floor")
    ys = torch.arange(h, device=device)
    adj2 = torch.where((ys >= 4) & (ys < h - 4), sm, adj)

    x = ((adj2 + 0x8000) >> 16).clamp(min=0)
    shift = torch.where(x >= w // 2, 0, x)

    # shift left by x: out[0..w-x) = in[x..w); the tail keeps the original
    xs = torch.arange(w, device=device)
    idx = (xs + shift[..., None]) % w
    rolled = torch.gather(f, -2, idx[..., None].expand(f.shape))
    keep_tail = xs >= (w - shift[..., None])
    return torch.where(keep_tail[..., None], f, rolled)
