"""Plain reference of the gen-1 (`to-composite`, ffmpeg_to_composite.cpp:
353-952) chain: uint8 Y [B, L, W] and 4:2:2 U, V [B, L, W/2] fields in
and out, re-quantized through clampu8 wherever the reference writes back
to its 8-bit planes. Its per-line inputs come from reference.gen2's
`field_inputs` with the gen-1 phase table and head switch."""

from __future__ import annotations

import torch

from reference.common import (full_float32, F32, I32, NTSC_RATE, NTSC_RATE_422, c_div,
                              c_int, cascade_emph, cascade_plain,
                              cascade_unsharp, clampu8, delay_writeback,
                              iir_alpha, iir_highpass, key32_from_seed,
                              row_walks)
from reference.gen2 import (by_phase, field_inputs, flip_table,
                            head_switching, qam_tables)


def _u8(s):
    return clampu8(s).to(I32)


def chroma_lowpass(u, v, ntsc: bool):
    """:353-393: a half-cut highpass "ringing" (s += hp(s)), then three
    lowpasses, delayed clampu8 writeback."""
    def one(p, cutoff, delay):
        s = p.to(F32)
        s = s + iir_highpass(s, iir_alpha(NTSC_RATE_422, cutoff / 2), 128.0)
        s = cascade_plain(s, iir_alpha(NTSC_RATE_422, cutoff), 128.0, 3)
        return delay_writeback(p, _u8(s), delay)

    return (one(u, 1300000.0, 2),
            one(v, 600000.0 if ntsc else 1300000.0, 4 if ntsc else 2))


def chroma_lowpass_lite(u, v):
    """:395-431: three lowpasses at rate/4, delay 1."""
    a = iir_alpha(NTSC_RATE_422, NTSC_RATE_422 / 4)
    return tuple(delay_writeback(p, _u8(cascade_plain(p.to(F32), a, 128.0, 3)),
                                 1) for p in (u, v))


def yuv_to_ntsc(y, u, v, xi, amp: int, nocolor: bool = False):
    """QAM-encode 4:2:2 chroma into luma (:434-477)."""
    um_t, vm_t = qam_tables(y.shape[-1], y.device)
    u2 = torch.repeat_interleave(u, 2, dim=-1) - 128
    v2 = torch.repeat_interleave(v, 2, dim=-1) - 128
    chroma = u2 * amp * by_phase(xi, um_t) + v2 * amp * by_phase(xi, vm_t)
    y = _u8(y + c_div(chroma, 50))
    if nocolor:
        u, v = torch.full_like(u, 128), torch.full_like(v, 128)
    return y, u, v


def ntsc_to_yuv(y, u, v, xi, amp_back: int, after_yc_sep: bool = False):
    """Y/C separation and QAM decode (:480-553)."""
    w = y.shape[-1]
    yp = torch.nn.functional.pad(y, (1, 2), value=16)
    new_y = (yp[..., 0:w] + yp[..., 1:w + 1] + yp[..., 2:w + 2]
             + yp[..., 3:]) // 4
    chroma = _u8(yp[..., 3:] + 128 - new_y)
    if after_yc_sep:
        return chroma, torch.full_like(u, 128), torch.full_like(v, 128)
    chroma = torch.where(by_phase(xi, flip_table(w, y.device, False)),
                         255 - chroma, chroma)
    chroma = _u8(c_div((chroma - 128) * 50, amp_back) + 128)
    ce, co = chroma[..., 0::2], chroma[..., 1::2]
    odd_phase = (xi[..., None] & 1) == 1
    return (new_y, torch.where(odd_phase, 255 - co, 255 - ce),
            torch.where(odd_phase, 255 - ce, 255 - co))


def chain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
          fieldno: torch.Tensor, parity: torch.Tensor, cfg, seed: int):
    """uint8 planes through the whole gen-1 chain (composite_video_process,
    :629-952, stage order kept); uint8 planes out."""
    _, l, w = y.shape
    dev = y.device
    full_float32()
    fieldno, parity = fieldno.to(dev), parity.to(dev)
    xi, k_luma, k_chroma, sincos, keep, shifts = field_inputs(
        cfg, fieldno, parity, l, w, key32_from_seed(seed), gen1=True)
    y, u, v = (p.to(I32) for p in (y, u, v))

    if cfg.composite_in_chroma_lowpass:
        u, v = chroma_lowpass(u, v, cfg.ntsc)
    y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude,
                          cfg.nocolor_subcarrier)
    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        a = iir_alpha(NTSC_RATE, cfg.composite_preemphasis_cut)
        y = _u8(cascade_emph(y.to(F32), a, 16.0, 0, cfg.composite_preemphasis))
    if cfg.video_noise != 0:
        walk = row_walks(k_luma, [0], l, w, cfg.video_noise)[:, 0]
        y = _u8(y + c_int(walk).to(I32))

    if cfg.vhs_head_switching:
        y = head_switching(y, shifts, fill=16)

    if not cfg.nocolor_subcarrier:
        y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude_back,
                              cfg.nocolor_subcarrier_after_yc_sep)
    w2 = u.shape[-1]
    if cfg.video_chroma_noise != 0:
        wk = c_int(row_walks(k_chroma, [0, l * w2], l, w2,
                             cfg.video_chroma_noise)).to(I32)
        u, v = _u8(u + wk[:, 0]), _u8(v + wk[:, 1])
    if cfg.video_chroma_phase_noise != 0:
        s, co = sincos[..., 0:1], sincos[..., 1:2]
        uu, vv = (u - 128).to(F32), (v - 128).to(F32)
        u, v = _u8(uu * co - uu * s + 128), _u8(vv * co + vv * s + 128)
    if cfg.emulating_vhs:
        y = _u8(cascade_emph(y.to(F32), iir_alpha(NTSC_RATE, cfg.luma_cut),
                             16.0, 3, 1.6))
        a = iir_alpha(NTSC_RATE_422, cfg.chroma_cut)
        u, v = (delay_writeback(p, _u8(cascade_plain(p.to(F32), a, 128.0, 3)),
                                cfg.chroma_delay_gen1) for p in (u, v))

    if cfg.emulating_vhs and cfg.vhs_chroma_vert_blend and cfg.ntsc:
        def blend(p):
            prev = torch.cat([torch.full_like(p[:, :1], 128), p[:, 1:-1]],
                             dim=1)
            return torch.cat([p[:, :1], (prev + p[:, 1:] + 1) >> 1], dim=1)
        u, v = blend(u), blend(v)

    if cfg.emulating_vhs:
        y = _u8(cascade_unsharp(y.to(F32),
                                iir_alpha(NTSC_RATE, cfg.luma_cut * 2), 16.0,
                                3, cfg.vhs_out_sharpen))
        a = iir_alpha(NTSC_RATE_422, cfg.chroma_cut * 2)
        u, v = (_u8(cascade_unsharp(p.to(F32), a, 128.0, 3,
                                    cfg.vhs_out_sharpen_chroma))
                for p in (u, v))
        if not cfg.vhs_svideo_out:
            y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude)
            y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude)
    if cfg.video_chroma_loss != 0:
        wipe = (keep == 0)[..., None]
        u, v = torch.where(wipe, 128, u), torch.where(wipe, 128, v)
    for _ in range(cfg.video_yc_recombine):
        y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude)
        y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude)
    # gen-1 precedence: the full lowpass wins whenever it is on
    if cfg.composite_out_chroma_lowpass:
        u, v = chroma_lowpass(u, v, cfg.ntsc)
    elif cfg.composite_out_chroma_lowpass_lite:
        u, v = chroma_lowpass_lite(u, v)
    return tuple(p.to(torch.uint8) for p in (y, u, v))
