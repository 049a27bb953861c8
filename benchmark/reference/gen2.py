"""Plain reference of the gen-2 (`ntsc`, ffmpeg_ntsc.cpp:1375-1921) chain:
uint8 RGB fields in, uint8 RGB fields out, in signed-int planar YIQ.

It derives every per-line input itself (scanline phase, noise stream ids,
chroma-phase sin/cos, dropout mask, head-switch shifts) from the field
numbers, parities, the `-seed` and the configuration, as the program's
`prepare` does, and takes nothing the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.common import (full_float32, F32, I32, NTSC_RATE, c_div, c_int,
                              cascade_emph, cascade_plain, cascade_unsharp,
                              delay_writeback, field_stage_keys, iir_alpha,
                              key32_from_seed, randint_per_field,
                              random_walk_per_field, row_walks,
                              scanline_phase_xi, uniform_pm1_per_field)

_UMULT = np.array([1, 0, -1, 0], np.int32)
_VMULT = np.array([0, 1, 0, -1], np.int32)
_HS_KMAX = 128


def qam_tables(w: int, device):
    """[4, W] multiplier rows: row k is Umult[(k+x)&3], Vmult[(k+x)&3]."""
    x = np.arange(w)
    um = np.stack([_UMULT[(k + x) & 3] for k in range(4)])
    vm = np.stack([_VMULT[(k + x) & 3] for k in range(4)])
    return torch.from_numpy(um).to(device), torch.from_numpy(vm).to(device)


def flip_table(w: int, device, guard_x3: bool):
    """[4, W] sign flips of the Y/C decode (ffmpeg_ntsc.cpp:1539-1542);
    gen-2 bounds the loop by x+3 < w, gen-1 flips in-range samples."""
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


def by_phase(xi, table):
    return table[xi.long()]


def roll_rows(a, shift):
    """out[..., x] = a[..., (x + shift) mod W], a shift per row."""
    w = a.shape[-1]
    x = torch.arange(w, device=a.device)
    return torch.gather(a, -1, torch.remainder(x + shift.long()[..., None], w))


def rgb_to_yiq(r, g, b):
    """ffmpeg_ntsc.cpp:1375-1383: int32 Y, I, Q scaled by 256."""
    r, g, b = r.to(F32), g.to(F32), b.to(F32)
    dy = 0.30 * r + 0.59 * g + 0.11 * b
    y = c_int(256.0 * dy)
    i = c_int(256.0 * ((-0.27 * (b - dy)) + (0.74 * (r - dy))))
    q = c_int(256.0 * ((0.41 * (b - dy)) + (0.48 * (r - dy))))
    return y.to(I32), i.to(I32), q.to(I32)


def yiq_to_rgb(y, i, q):
    """ffmpeg_ntsc.cpp:1385-1396."""
    y, i, q = y.to(F32), i.to(F32), q.to(F32)
    r = c_int((1.000 * y + 0.956 * i + 0.621 * q) / 256.0)
    g = c_int((1.000 * y - 0.272 * i - 0.647 * q) / 256.0)
    b = c_int((1.000 * y - 1.106 * i + 1.703 * q) / 256.0)
    return tuple(torch.clamp(c, 0, 255).to(I32) for c in (r, g, b))


def lowpass_plane(p, cutoff, delay):
    s = cascade_plain(p.to(F32), iir_alpha(NTSC_RATE, cutoff), 0.0, 3)
    return delay_writeback(p, c_int(s).to(I32), delay)


def chroma_into_luma(y, i, q, xi, amp: int):
    """QAM encode (ffmpeg_ntsc.cpp:1460-1495); I and Q become 0."""
    um_t, vm_t = qam_tables(y.shape[-1], y.device)
    chroma = i * amp * by_phase(xi, um_t) + q * amp * by_phase(xi, vm_t)
    zeros = torch.zeros_like(i)
    return y + c_div(chroma, 50), zeros, zeros


def chroma_from_luma(y, xi, amp_back: int):
    """Y/C separation and QAM decode (ffmpeg_ntsc.cpp:1497-1567)."""
    w = y.shape[-1]
    dev = y.device
    yp = torch.nn.functional.pad(y, (1, 2))
    total = yp[..., 0:w] + yp[..., 1:w + 1] + yp[..., 2:w + 2] + yp[..., 3:]
    new_y = c_div(total, 4)
    chroma = yp[..., 3:] - new_y
    chroma = torch.where(by_phase(xi, flip_table(w, dev, True)), -chroma,
                         chroma)
    chroma = c_div(chroma * 50, amp_back)
    xe = torch.arange(w, device=dev)
    is_even = (xe & 1) == 0
    r0 = roll_rows(chroma, xi)
    valid = by_phase(xi, torch.from_numpy(np.stack(
        [(np.arange(w) + k + 1) < w for k in range(4)])).to(dev))
    i_even = torch.where(is_even & valid, -r0, 0)
    q_even = torch.where(is_even & valid, -torch.roll(r0, -1, dims=-1), 0)
    tail_start = w - 2 if w % 2 == 0 else w - 1

    def interp(p):
        odd = (torch.roll(p, 1, dims=-1) + torch.roll(p, -1, dims=-1)) >> 1
        return torch.where(xe >= tail_start, 0, torch.where(is_even, p, odd))

    return new_y, interp(i_even), interp(q_even)


def head_switch_shifts(l: int, field_parity, keys, *, point, phase,
                       phase_noise, twidth: int, ntsc: bool):
    """int32 [B, L] head-switch shift per row (ffmpeg_ntsc.cpp:1646-1713):
    the switch line from the C fmod/unsigned-cast geometry, then
    applied(0) = 0, applied(1) = ishif, applied(k) = trunc(applied(k-1)*7/8)."""
    tlines = 262.5 if ntsc else 312.5
    t = torch.tensor(twidth * tlines, dtype=F32)
    if phase_noise != 0:
        noise = uniform_pm1_per_field(keys) * torch.tensor(phase_noise,
                                                           dtype=F32)
    else:
        noise = torch.zeros(field_parity.shape, dtype=F32,
                            device=field_parity.device)

    def c_wrap_u32(v):
        f = v - torch.trunc(v)
        return torch.trunc(f * t).to(I32).to(torch.int64) & 0xFFFFFFFF

    p_y = c_wrap_u32(torch.tensor(point, dtype=F32) + noise)
    p_x = c_wrap_u32(torch.tensor(phase, dtype=F32) + noise)
    vis_off = (262 - 240) * 2 if ntsc else (312 - 288) * 2
    parity = field_parity.to(torch.int64)
    y_start = (p_y // twidth) * 2 + parity - vis_off
    x_pos = p_x % twidth
    ishif = torch.where(x_pos >= twidth // 2, x_pos - twidth, x_pos)
    l_start = torch.div(y_start - parity, 2, rounding_mode="floor")
    applied = [torch.zeros_like(ishif), ishif]
    for _ in range(2, _HS_KMAX):
        applied.append(c_div(applied[-1] * 7, 8))
    applied = torch.stack(applied, dim=-1)
    idx = torch.arange(l, device=ishif.device)[None, :] - l_start[:, None]
    safe = torch.clamp(idx, 0, _HS_KMAX - 1)
    shifts = torch.where((idx >= 0) & (idx < _HS_KMAX),
                         torch.gather(applied, 1, safe), 0)
    return shifts.to(I32)


def head_switching(y, shifts, fill: int):
    """Each row rotates by its shift in a raster W + W/10 wide whose
    samples past W hold `fill`; rows with shift 0 are unchanged."""
    w = y.shape[-1]
    padded = torch.nn.functional.pad(y, (0, w // 10), value=fill)
    rotated = roll_rows(padded, shifts)[..., :w]
    return torch.where(shifts[..., None] != 0, rotated, y)


def field_inputs(cfg, fieldno, field_parity, l: int, w: int, key: int,
                 gen1: bool):
    """(xi, luma noise ids, chroma noise ids, sincos, keep, shifts): every
    per-field and per-line input, from stage keys 0-4 of each field."""
    b = fieldno.shape[0]
    dev = fieldno.device
    xi = scanline_phase_xi(fieldno, field_parity, l,
                           cfg.video_scanline_phase_shift,
                           cfg.video_scanline_phase_shift_offset, cfg.ntsc,
                           gen1)
    keys = [field_stage_keys(key, fieldno, s) for s in range(5)]
    if cfg.video_chroma_phase_noise != 0:
        walk = random_walk_per_field(keys[3], l, cfg.video_chroma_phase_noise)
        ang = c_int(walk) * torch.tensor(math.pi / 100.0, dtype=F32)
        sincos = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    else:
        zeros = torch.zeros((b, l), dtype=F32, device=dev)
        sincos = torch.stack([zeros, zeros + 1.0], dim=-1)
    if cfg.video_chroma_loss != 0:
        rr = randint_per_field(keys[4], l, 0, 100000)
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
        shifts = torch.zeros((b, l), dtype=I32, device=dev)
    return xi, keys[0], keys[2], sincos, keep, shifts


def chain(rgb: torch.Tensor, fieldno: torch.Tensor, parity: torch.Tensor,
          cfg, seed: int) -> torch.Tensor:
    """uint8 [B, L, W, 3] fields through the whole gen-2 chain (stage
    order of ffmpeg_ntsc.cpp:1570-1921); uint8 out."""
    _, l, w, _ = rgb.shape
    dev = rgb.device
    full_float32()
    fieldno, parity = fieldno.to(dev), parity.to(dev)
    xi, k_luma, k_chroma, sincos, keep, shifts = field_inputs(
        cfg, fieldno, parity, l, w, key32_from_seed(seed), gen1=False)
    c = rgb.to(I32)
    y, i, q = rgb_to_yiq(c[..., 0], c[..., 1], c[..., 2])

    if cfg.composite_in_chroma_lowpass:
        i, q = lowpass_plane(i, 1300000.0, 2), lowpass_plane(q, 600000.0, 4)
    y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        a = iir_alpha(NTSC_RATE, cfg.composite_preemphasis_cut)
        y = c_int(cascade_emph(y.to(F32), a, 16.0, 0,
                               cfg.composite_preemphasis)).to(I32)
    if cfg.video_noise != 0:
        walk = row_walks(k_luma, [0], l, w, cfg.video_noise)[:, 0]
        y = y + c_int(walk).to(I32)

    if cfg.vhs_head_switching:
        y = head_switching(y, shifts, fill=0)

    if not cfg.nocolor_subcarrier:
        y, i, q = chroma_from_luma(y, xi, cfg.subcarrier_amplitude_back)
    else:
        i = q = torch.zeros_like(y)
    if cfg.video_chroma_noise != 0:
        wk = c_int(row_walks(k_chroma, [0, l * w], l, w,
                             cfg.video_chroma_noise)).to(I32)
        i, q = i + wk[:, 0], q + wk[:, 1]
    if cfg.video_chroma_phase_noise != 0:
        s, co = sincos[..., 0:1], sincos[..., 1:2]
        u, v = i.to(F32), q.to(F32)
        if cfg.chroma_phase_noise_gen1_bug:
            u_, v_ = u * co - u * s, v * co + v * s
        else:
            u_, v_ = u * co - v * s, u * s + v * co
        i, q = c_int(u_).to(I32), c_int(v_).to(I32)
    if cfg.emulating_vhs:
        a = iir_alpha(NTSC_RATE, cfg.luma_cut)
        y = c_int(cascade_emph(y.to(F32), a, 16.0, 3, 1.6)).to(I32)
        a = iir_alpha(NTSC_RATE, cfg.chroma_cut)
        i, q = (delay_writeback(p, c_int(cascade_plain(p.to(F32), a, 0.0, 3))
                                .to(I32), cfg.chroma_delay_gen2)
                for p in (i, q))

    if cfg.emulating_vhs and cfg.vhs_chroma_vert_blend and cfg.ntsc:
        def blend(p):
            prev = torch.cat([torch.zeros_like(p[:, :1]), p[:, 1:-1]], dim=1)
            return torch.cat([p[:, :1], (prev + p[:, 1:] + 1) >> 1], dim=1)
        i, q = blend(i), blend(q)

    if cfg.emulating_vhs:
        a = iir_alpha(NTSC_RATE, cfg.luma_cut * 4.0)
        y = c_int(cascade_unsharp(y.to(F32), a, 0.0, 3,
                                  cfg.vhs_out_sharpen * 2.0)).to(I32)
        if not cfg.vhs_svideo_out:
            y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
            y, i, q = chroma_from_luma(y, xi, cfg.subcarrier_amplitude)
    if cfg.video_chroma_loss != 0:
        wipe = (keep == 0)[..., None]
        i, q = torch.where(wipe, 0, i), torch.where(wipe, 0, q)
    for _ in range(cfg.video_yc_recombine):
        y, i, q = chroma_into_luma(y, i, q, xi, cfg.subcarrier_amplitude)
        y, i, q = chroma_from_luma(y, xi, cfg.subcarrier_amplitude)
    if cfg.composite_out_chroma_lowpass:
        if cfg.composite_out_chroma_lowpass_lite:
            i, q = lowpass_plane(i, 2600000.0, 1), lowpass_plane(q, 2600000.0, 1)
        else:
            i, q = (lowpass_plane(i, 1300000.0, 2),
                    lowpass_plane(q, 600000.0, 4))
    r, g, b = yiq_to_rgb(y, i, q)
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)
