"""Gen-2 composite engine, stage by stage (twin of cvsim_tpu.models.yiq).

True signed-int planar YIQ (ffmpeg_ntsc.cpp) on a batch of fields: int32
planes [B, L, W] plus per-field metadata. Each stage is a plain PyTorch
function; together they are the port's CPU path and the plain version that
the CUDA kernel of models/fused_yiq.py is held against.

The per-line streams (phase xi, noise stream ids, chroma-phase sin/cos,
dropout keep mask, head-switch shifts) are computed once by
`field_streams` and passed to `composite_layer`, so the kernel and this
path consume identical inputs.

Reference functions and where each is reimplemented here:
- RGB_to_YIQ / YIQ_to_RGB          ffmpeg_ntsc.cpp:1375-1396
- composite_lowpass(_tv)           ffmpeg_ntsc.cpp:1399-1458
- chroma_into_luma                 ffmpeg_ntsc.cpp:1460-1495
- chroma_from_luma                 ffmpeg_ntsc.cpp:1497-1567
- composite_layer (orchestrator)   ffmpeg_ntsc.cpp:1570-1921
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu_torch.ops.cmath import c_div, c_int
from cvsim_tpu_torch.ops.iir import (
    cascade_emph,
    cascade_plain,
    cascade_unsharp,
    delay_writeback,
)
from cvsim_tpu_torch.ops.noise import (
    chroma_noise_walk_rows,
    field_stage_keys,
    randint_per_field,
    random_walk_per_field,
    smoothed_noise_walk_rows,
    uniform_pm1_per_field,
)
from cvsim_tpu_torch.ops.phase import scanline_phase_xi
from cvsim_tpu_torch.utils import log

F32 = torch.float32
_UMULT_NP = np.array([1, 0, -1, 0], np.int32)
_VMULT_NP = np.array([0, 1, 0, -1], np.int32)
# shift-decay steps tabulated by head_switch_shifts: |ishif| <= twidth/2
# decays to 0 in < 64 steps of the 7/8 truncating decay, and a visible row
# sits at most l - l_start < l + 23 steps past the switch line
_HS_KMAX = 128


def _qam_mult_tables(w: int, device):
    """[4, W] subcarrier multiplier rows: row k is Umult[(k+x)&3]."""
    x = np.arange(w)
    um = np.stack([_UMULT_NP[(k + x) & 3] for k in range(4)])
    vm = np.stack([_VMULT_NP[(k + x) & 3] for k in range(4)])
    return (torch.from_numpy(um).to(device), torch.from_numpy(vm).to(device))


def _flip_table(w: int, device, guard_x3: bool = True):
    """[4, W] sign-flip mask rows of the Y/C decode: chroma[x+2],
    chroma[x+3] flip for x from ((4-xi)&3) step 4 (ffmpeg_ntsc.cpp:
    1539-1542). guard_x3 is gen-2's loop bound x+3 < w; gen-1 flips the
    in-range samples only."""
    p = np.arange(w)
    rows = []
    for k in range(4):
        x0 = (4 - k) & 3
        r = (p - x0) & 3
        base = p - r
        mask = (r >= 2) & (base >= x0)
        if guard_x3:
            mask &= (base + 3) < w
        rows.append(mask)
    return torch.from_numpy(np.stack(rows)).to(device)


def _demux_valid_table(w: int, device):
    """[4, W] validity of the even-sample demux read ((x + xi + 1) < w)."""
    x = np.arange(w)
    rows = [((x + k + 1) < w) for k in range(4)]
    return torch.from_numpy(np.stack(rows)).to(device)


def _by_phase(xi: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[xi] -> [..., W] (row lookup by scanline phase)."""
    return table[xi.long()]


def roll_rows(a: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """out[..., x] = a[..., (x + shift) mod W] with a per-row shift."""
    w = a.shape[-1]
    x = torch.arange(w, device=a.device)
    idx = torch.remainder(x + shift.long()[..., None], w)
    return torch.gather(a, -1, idx)


# ---------------------------------------------------------------- colorspace

def rgb_to_yiq(r, g, b):
    """ffmpeg_ntsc.cpp:1375-1383. int32 Y,I,Q scaled by 256."""
    r, g, b = r.to(F32), g.to(F32), b.to(F32)
    dy = 0.30 * r + 0.59 * g + 0.11 * b
    y = c_int(256.0 * dy)
    i = c_int(256.0 * ((-0.27 * (b - dy)) + (0.74 * (r - dy))))
    q = c_int(256.0 * ((0.41 * (b - dy)) + (0.48 * (r - dy))))
    return y.to(torch.int32), i.to(torch.int32), q.to(torch.int32)


def yiq_to_rgb(y, i, q):
    """ffmpeg_ntsc.cpp:1385-1396. int32 YIQ -> uint8-range int32 RGB."""
    y, i, q = y.to(F32), i.to(F32), q.to(F32)
    r = c_int((1.000 * y + 0.956 * i + 0.621 * q) / 256.0)
    g = c_int((1.000 * y - 0.272 * i - 0.647 * q) / 256.0)
    b = c_int((1.000 * y - 1.106 * i + 1.703 * q) / 256.0)

    def clip(v):
        return torch.clamp(v, 0, 255).to(torch.int32)

    return clip(r), clip(g), clip(b)


# ------------------------------------------------------------- chroma filter

def _lowpass_plane(p, cutoff, delay, passes):
    """3-pass lowpass + delayed writeback on an int32 plane
    (ffmpeg_ntsc.cpp:1445-1454)."""
    alpha = iir_alpha(NTSC_RATE, cutoff)
    s = cascade_plain(p.to(F32), alpha, 0.0, passes)
    return delay_writeback(p, c_int(s).to(torch.int32), delay)


def composite_lowpass(i, q):
    """I 1.3MHz (delay 2), Q 0.6MHz (delay 4) (ffmpeg_ntsc.cpp:1429-1458)."""
    return (_lowpass_plane(i, 1300000.0, 2, 3),
            _lowpass_plane(q, 600000.0, 4, 3))


def composite_lowpass_tv(i, q):
    """CRT-style 2.6MHz/delay-1 filter (ffmpeg_ntsc.cpp:1399-1427)."""
    return (_lowpass_plane(i, 2600000.0, 1, 3),
            _lowpass_plane(q, 2600000.0, 1, 3))


# ----------------------------------------------------------------- QAM stage

def chroma_into_luma(y, i, q, xi, subcarrier_amplitude: int):
    """QAM-encode chroma onto luma (ffmpeg_ntsc.cpp:1460-1495).
    Returns (y', 0, 0)."""
    um_t, vm_t = _qam_mult_tables(y.shape[-1], y.device)
    um = _by_phase(xi, um_t)
    vm = _by_phase(xi, vm_t)
    chroma = i * subcarrier_amplitude * um + q * subcarrier_amplitude * vm
    y = y + c_div(chroma, 50)
    zeros = torch.zeros_like(i)
    return y, zeros, zeros


def _yc_separate(y):
    """4-tap box blur with 2-pixel precharge (ffmpeg_ntsc.cpp:1506-1525):
    new_y[x] = trunc((y[x-1] + y[x] + y[x+1] + y[x+2]) / 4), zero-padded;
    chroma[x] = y[x+2] - new_y[x]."""
    w = y.shape[-1]
    yp = torch.nn.functional.pad(y, (1, 2))
    total = yp[..., 0:w] + yp[..., 1:w + 1] + yp[..., 2:w + 2] + yp[..., 3:]
    new_y = c_div(total, 4)
    return new_y, yp[..., 3:] - new_y


def chroma_from_luma(y, xi, subcarrier_amplitude_back: int):
    """Y/C separation + QAM decode (ffmpeg_ntsc.cpp:1497-1567).
    Returns (y, i, q)."""
    w = y.shape[-1]
    dev = y.device
    new_y, chroma = _yc_separate(y)
    flip = _by_phase(xi, _flip_table(w, dev))
    chroma = torch.where(flip, -chroma, chroma)
    chroma = c_div(chroma * 50, subcarrier_amplitude_back)

    # demux even samples: I[x] = -chroma[x+xi], Q[x] = -chroma[x+xi+1]
    # while x+xi+1 < w; later even samples are zero
    xe = torch.arange(w, device=dev)
    is_even = (xe & 1) == 0
    r0 = roll_rows(chroma, xi)
    gi = -r0
    gq = -torch.roll(r0, -1, dims=-1)
    valid = _by_phase(xi, _demux_valid_table(w, dev))
    i_even = torch.where(is_even & valid, gi, 0)
    q_even = torch.where(is_even & valid, gq, 0)

    # odd samples: I[x] = (I[x-1] + I[x+1]) >> 1; the tail from the first
    # even x with x+2 >= w is zeroed (ffmpeg_ntsc.cpp:1557-1564)
    tail_start = w - 2 if w % 2 == 0 else w - 1

    def interp(p):
        odd = (torch.roll(p, 1, dims=-1) + torch.roll(p, -1, dims=-1)) >> 1
        out = torch.where(is_even, p, odd)
        return torch.where(xe >= tail_start, 0, out)

    return new_y, interp(i_even), interp(q_even)


# --------------------------------------------------------------- distortions

def composite_preemphasis_stage(y, pre_scale: float, pre_cut: float):
    """Per-scanline 1-pole highpass emphasis (ffmpeg_ntsc.cpp:1613-1629)."""
    alpha = iir_alpha(NTSC_RATE, pre_cut)
    s = cascade_emph(y.to(F32), alpha, 16.0, 0, pre_scale)
    return c_int(s).to(torch.int32)


def video_noise_stage(y, keys, mag: int, row0: int = 0):
    """Smoothed random-walk luma noise, reset per scanline
    (ffmpeg_ntsc.cpp:1631-1644). keys: [B] per-field stream ids; row0: the
    global index of y's first row (non-zero on a row shard)."""
    _, l, w = y.shape
    walk = smoothed_noise_walk_rows(keys, l, w, mag, row0=row0)
    return y + c_int(walk).to(torch.int32)


def chroma_noise_stage(i, q, keys, mag: int, row0: int = 0,
                       l_glob: int | None = None):
    """Independent per-scanline walks on I and Q (ffmpeg_ntsc.cpp:1718-1735).
    A row shard passes its first row's global index and the field height."""
    _, l, w = i.shape
    wk = c_int(chroma_noise_walk_rows(keys, l, w, mag, row0=row0,
                                      l_glob=l_glob)).to(torch.int32)
    return i + wk[:, 0], q + wk[:, 1]


def chroma_phase_angles(keys, l: int, mag: int):
    """Per-scanline chroma phase as [B, L, 2] (sin, cos): a random walk
    in units of pi/100 (ffmpeg_ntsc.cpp:1736-1764)."""
    walk = random_walk_per_field(keys, l, mag)          # post-update
    return phase_sincos(c_int(walk))


def phase_sincos(k: torch.Tensor) -> torch.Tensor:
    """(sin, cos) of the chroma phase k in units of pi/100 (float32),
    stacked on a new last axis."""
    ang = k * torch.tensor(math.pi / 100.0, dtype=F32)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)


def chroma_phase_noise_stage(i, q, sincos, gen1_bug: bool = False):
    """Rotate (I, Q) per scanline by the angle whose (sin, cos) is given.
    gen1_bug reproduces ffmpeg_to_composite.cpp:772's rotation typo."""
    s = sincos[..., 0:1]
    c = sincos[..., 1:2]
    u = i.to(F32)
    v = q.to(F32)
    if gen1_bug:
        u_ = u * c - u * s
        v_ = v * c + v * s
    else:
        u_ = u * c - v * s
        v_ = u * s + v * c
    return c_int(u_).to(torch.int32), c_int(v_).to(torch.int32)


def _head_switch_geometry(field_parity, keys, *, point, phase, phase_noise,
                          twidth: int, ntsc: bool):
    """(ishif, l_start) per field, with the C semantics of the reference's
    fmod/unsigned-cast geometry: sign-preserving fmod, truncation toward
    zero, then a wrap mod 2^32 (ffmpeg_ntsc.cpp:1666-1670). Float math in
    float32, as in the JAX package."""
    tlines = 262.5 if ntsc else 312.5
    t = torch.tensor(twidth * tlines, dtype=F32)
    b = field_parity.shape[0]
    dev = field_parity.device
    if phase_noise != 0:
        noise = (uniform_pm1_per_field(keys)
                 * torch.tensor(phase_noise, dtype=F32))
    else:
        noise = torch.zeros((b,), dtype=F32, device=dev)

    def c_wrap_u32(v):
        f = v - torch.trunc(v)
        return torch.trunc(f * t).to(torch.int32).to(torch.int64) & 0xFFFFFFFF

    p_y = c_wrap_u32(torch.tensor(point, dtype=F32) + noise)
    p_x = c_wrap_u32(torch.tensor(phase, dtype=F32) + noise)
    vis_off = (262 - 240) * 2 if ntsc else (312 - 288) * 2
    parity = field_parity.to(torch.int64)
    y_start = (p_y // twidth) * 2 + parity - vis_off
    x_pos = p_x % twidth
    ishif = torch.where(x_pos >= twidth // 2, x_pos - twidth, x_pos)
    l_start = torch.div(y_start - parity, 2, rounding_mode="floor")
    return ishif, l_start


def head_switch_shifts(l: int, field_parity, keys, *, point, phase,
                       phase_noise, twidth: int, ntsc: bool):
    """Full per-row head-switch shift table, int32 [B, L].

    Row l sits k = l - l_start scanline steps past the switch line; the C
    loop applies its shift before decaying it (ffmpeg_ntsc.cpp:1683-1712):
    applied(0) = 0, applied(1) = ishif, applied(k) = trunc(applied(k-1)*7/8).
    """
    ishif, l_start = _head_switch_geometry(
        field_parity, keys, point=point, phase=phase,
        phase_noise=phase_noise, twidth=twidth, ntsc=ntsc)
    applied = [torch.zeros_like(ishif), ishif]
    for _ in range(2, _HS_KMAX):
        applied.append(c_div(applied[-1] * 7, 8))
    applied = torch.stack(applied, dim=-1)                  # [B, KMAX]
    idx = (torch.arange(l, device=ishif.device)[None, :]
           - l_start[:, None])                              # [B, L]
    safe = torch.clamp(idx, 0, _HS_KMAX - 1)
    shifts = torch.where((idx >= 0) & (idx < _HS_KMAX),
                         torch.gather(applied, 1, safe), 0)
    return shifts.to(torch.int32)


def head_switching_stage(y, shifts, fill: int = 0):
    """VHS head-switching bar (ffmpeg_ntsc.cpp:1646-1713): each row rotates
    by its shift within a virtual raster of width twidth = W + W/10 whose
    samples past W hold `fill`; rows with shift 0 are unchanged."""
    _, _, w = y.shape
    twidth = w + w // 10
    padded = torch.nn.functional.pad(y, (0, twidth - w), value=fill)
    rotated = roll_rows(padded, shifts)[..., :w]
    return torch.where(shifts[..., None] != 0, rotated, y)


def chroma_dropout_stage(i, q, keep):
    """Per-scanline chroma wipe (ffmpeg_ntsc.cpp:1891-1901); keep: [B, L]
    float 0/1 mask."""
    wipe = (keep == 0)[..., None]
    return torch.where(wipe, 0, i), torch.where(wipe, 0, q)


# ------------------------------------------------------------------ VHS block

def vhs_luma_lowpass(y, luma_cut: float):
    """3-pass lowpass + same-cutoff highpass emphasis x1.6
    (ffmpeg_ntsc.cpp:1793-1812)."""
    alpha = iir_alpha(NTSC_RATE, luma_cut)
    return c_int(cascade_emph(y.to(F32), alpha, 16.0, 3, 1.6)).to(torch.int32)


def vhs_chroma_lowpass(i, q, chroma_cut: float, chroma_delay: int):
    """ffmpeg_ntsc.cpp:1814-1836 — gen-2 runs chroma at the full luma rate."""
    alpha = iir_alpha(NTSC_RATE, chroma_cut)
    si = cascade_plain(i.to(F32), alpha, 0.0, 3)
    sq = cascade_plain(q.to(F32), alpha, 0.0, 3)
    return (delay_writeback(i, c_int(si).to(torch.int32), chroma_delay),
            delay_writeback(q, c_int(sq).to(torch.int32), chroma_delay))


def vhs_chroma_vert_blend(i, q):
    """2-line chroma average over field lines (ffmpeg_ntsc.cpp:1838-1863):
    line 0 is untouched, line 1 blends with 0 (not with line 0 — a quirk
    of the reference kept here), line l>=2 with the original line l-1."""
    def blend(p):
        prev = torch.cat([torch.zeros_like(p[:, :1]), p[:, 1:-1]], dim=1)
        return torch.cat([p[:, :1], (prev + p[:, 1:] + 1) >> 1], dim=1)
    return blend(i), blend(q)


def vhs_sharpen(y, luma_cut: float, sharpen: float):
    """Gen-2 unsharp mask via 3-pass lowpass: cutoff x4, gain x2, reset 0
    (ffmpeg_ntsc.cpp:1865-1883)."""
    alpha = iir_alpha(NTSC_RATE, luma_cut * 4.0)
    out = cascade_unsharp(y.to(F32), alpha, 0.0, 3, sharpen * 2.0)
    return c_int(out).to(torch.int32)


# ------------------------------------------------------------ per-line inputs

class FieldStreams(NamedTuple):
    """Per-field/per-line inputs of one chain call (all on one device)."""
    xi: torch.Tensor        # int32 [B, L] scanline phase
    keys_ab: torch.Tensor   # int64 [B, 2] u32 stream ids: luma, chroma noise
    sincos: torch.Tensor    # f32 [B, L, 2] chroma phase (sin, cos)
    keep: torch.Tensor      # f32 [B, L] 1 = keep chroma, 0 = dropout
    shifts: torch.Tensor    # int32 [B, L] head-switch shift per row


def field_streams(cfg: CompositeConfig, fieldno, field_parity, l: int,
                  w: int, key: int, gen1: bool = False) -> FieldStreams:
    """Every stochastic and per-line input of the chain, from the per-field
    stage keys (field_stage_keys stages 0-4, the JAX package's order).
    w is the luma width. gen1 selects the gen-1 engine's xi table and its
    head switch, which takes both raster axes from the switch point
    (ffmpeg_to_composite.cpp:687-689); the chroma-noise stream id is the
    same, and the gen-1 chain indexes it at half width."""
    dev = fieldno.device
    b = fieldno.shape[0]
    xi = scanline_phase_xi(
        fieldno, field_parity, l, cfg.video_scanline_phase_shift,
        cfg.video_scanline_phase_shift_offset, cfg.ntsc, gen1=gen1)
    keys = [field_stage_keys(key, fieldno, sid) for sid in range(5)]
    keys_ab = torch.stack([keys[0], keys[2]], dim=-1)
    if cfg.video_chroma_phase_noise != 0:
        sincos = chroma_phase_angles(keys[3], l, cfg.video_chroma_phase_noise)
    else:
        zeros = torch.zeros((b, l), dtype=F32, device=dev)
        sincos = torch.stack([zeros, zeros + 1.0], dim=-1)
    if cfg.video_chroma_loss != 0:
        rr = randint_per_field(keys[4], (l,), 0, 100000)
        keep = (rr >= cfg.video_chroma_loss).to(F32)
    else:
        keep = torch.ones((b, l), dtype=F32, device=dev)
    if cfg.vhs_head_switching:
        shifts = head_switch_shifts(
            l, field_parity, keys[1], point=cfg.vhs_head_switching_point,
            phase=(cfg.vhs_head_switching_point if gen1
                   else cfg.vhs_head_switching_phase),
            phase_noise=cfg.vhs_head_switching_phase_noise,
            twidth=w + w // 10, ntsc=cfg.ntsc)
    else:
        shifts = torch.zeros((b, l), dtype=torch.int32, device=dev)
    return FieldStreams(xi, keys_ab, sincos, keep, shifts)


# ---------------------------------------------------------------- full chain

def composite_front_a(y, i, q, *, cfg: CompositeConfig,
                      streams: FieldStreams, row0: int = 0):
    """Stage group A (ffmpeg_ntsc.cpp:1570-1644): input chroma lowpass, QAM
    encode, preemphasis, luma noise. Returns the encoded luma. row0 is the
    global index of the planes' first row (non-zero on a row shard)."""
    xi = streams.xi
    if cfg.composite_in_chroma_lowpass:
        i, q = composite_lowpass(i, q)

    y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)

    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        y = composite_preemphasis_stage(
            y, cfg.composite_preemphasis, cfg.composite_preemphasis_cut)

    if cfg.video_noise != 0:
        y = video_noise_stage(y, streams.keys_ab[:, 0], cfg.video_noise,
                              row0=row0)
    return y


def composite_front_b1(y, *, cfg: CompositeConfig, streams: FieldStreams,
                       row0: int = 0, l_glob: int | None = None):
    """Stage group B1 (ffmpeg_ntsc.cpp:1714-1836), after the head switch:
    Y/C separation and QAM decode, chroma noise, chroma phase noise, the VHS
    luma and chroma bandlimit. l_glob: the whole field's height (the Q
    noise plane sits at stream offset l_glob*w)."""
    xi = streams.xi
    if not cfg.nocolor_subcarrier:
        y, i, q = chroma_from_luma(y, xi, cfg.subcarrier_amplitude_back)
    else:
        i = q = torch.zeros_like(y)

    if cfg.video_chroma_noise != 0:
        i, q = chroma_noise_stage(i, q, streams.keys_ab[:, 1],
                                  cfg.video_chroma_noise, row0=row0,
                                  l_glob=l_glob)

    if cfg.video_chroma_phase_noise != 0:
        i, q = chroma_phase_noise_stage(
            i, q, streams.sincos, gen1_bug=cfg.chroma_phase_noise_gen1_bug)

    if cfg.emulating_vhs:
        speed = cfg.vhs_tape_speed
        y = vhs_luma_lowpass(y, speed.luma_cut)
        i, q = vhs_chroma_lowpass(i, q, speed.chroma_cut,
                                  speed.chroma_delay_gen2)
    return y, i, q


def composite_back_b2(y, i, q, *, cfg: CompositeConfig,
                      streams: FieldStreams):
    """Stage group B2 (ffmpeg_ntsc.cpp:1865-1921), after the vertical
    blend: VHS sharpen and re-encode/decode, chroma dropout, Y/C
    recombine, output chroma lowpass."""
    xi = streams.xi
    if cfg.emulating_vhs:
        y = vhs_sharpen(y, cfg.vhs_tape_speed.luma_cut, cfg.vhs_out_sharpen)
        if not cfg.vhs_svideo_out:
            y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
            y, i, q = chroma_from_luma(y, xi, cfg.subcarrier_amplitude)

    if cfg.video_chroma_loss != 0:
        i, q = chroma_dropout_stage(i, q, streams.keep)

    for _ in range(cfg.video_yc_recombine):
        y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
        y, i, q = chroma_from_luma(y, xi, cfg.subcarrier_amplitude)

    if cfg.composite_out_chroma_lowpass:
        if cfg.composite_out_chroma_lowpass_lite:
            i, q = composite_lowpass_tv(i, q)
        else:
            i, q = composite_lowpass(i, q)
    return y, i, q


def do_vert_blend(cfg: CompositeConfig) -> bool:
    """Whether the chain runs the 2-line chroma vertical blend."""
    return cfg.emulating_vhs and cfg.vhs_chroma_vert_blend and cfg.ntsc


def composite_layer(y, i, q, *, cfg: CompositeConfig, streams: FieldStreams):
    """Full gen-2 emulation chain on a batch of fields
    (ffmpeg_ntsc.cpp:1570-1921, stage order preserved). y,i,q: int32
    [B, L, W] YIQ planes (Y scaled by 256). The three stage groups are
    row-local; the head switch and the vertical blend sit between them."""
    y = composite_front_a(y, i, q, cfg=cfg, streams=streams)
    if cfg.vhs_head_switching:
        y = head_switching_stage(y, streams.shifts, fill=0)
    y, i, q = composite_front_b1(y, cfg=cfg, streams=streams)
    if do_vert_blend(cfg):
        i, q = vhs_chroma_vert_blend(i, q)
    return composite_back_b2(y, i, q, cfg=cfg, streams=streams)


def composite_layer_rgb_streams(rgb, streams: FieldStreams, *,
                                cfg: CompositeConfig):
    """uint8/int [B, L, W, 3] RGB fields through the chain with the given
    per-line inputs; uint8 [B, L, W, 3] out."""
    rgb = rgb.to(torch.int32)
    y, i, q = rgb_to_yiq(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    y, i, q = composite_layer(y, i, q, cfg=cfg, streams=streams)
    r, g, b = yiq_to_rgb(y, i, q)
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)


def composite_layer_rgb(rgb, fieldno, field_parity, key: int, *,
                        cfg: CompositeConfig):
    """RGB field batch in, RGB field batch out (full chain). key: the u32
    stream seed (interop.key32_from_seed)."""
    _, l, w, _ = rgb.shape
    streams = field_streams(cfg, fieldno, field_parity, l, w, key)
    return composite_layer_rgb_streams(rgb, streams, cfg=cfg)


def composite_layer_rgb_auto(rgb, fieldno, field_parity, key: int, *,
                             cfg: CompositeConfig):
    """The main path, dispatched on rgb's device: fused_yiq.prepare, then
    the CUDA kernel for a CUDA tensor or fused_yiq.chain_reference for a
    CPU tensor (composite_layer_rgb_fused decides; it never falls back)."""
    from cvsim_tpu_torch.models import fused_yiq

    with log.span("gen2.call", entry=True):
        prep = fused_yiq.prepare(cfg, rgb, fieldno, field_parity, key)
        with log.span("gen2.launch"):
            return fused_yiq.composite_layer_rgb_fused(rgb, prep, cfg=cfg)
