"""Gen-1 composite engine, stage by stage (twin of cvsim_tpu.models.yuv422).

8-bit YUV 4:2:2 "fake YIQ" (ffmpeg_to_composite.cpp) on a batch of fields:
int32 planes y [B, L, W] and u, v [B, L, W//2] holding uint8-range values.
Every stage re-quantizes through clampu8 exactly where the reference
writes back to its u8 planes. Together the stages are the port's CPU path
and the plain version that the CUDA kernel of models/fused_yuv.py is held
against.

The per-line inputs (phase xi, noise stream ids, chroma-phase sin/cos,
dropout keep mask, head-switch shifts) come from yiq.field_streams with
gen1=True, so the kernel and this path consume identical inputs.

The chain splits where the JAX package's split program splits it
(kernels A, B1, B2 of cvsim_tpu/models/fused_yuv.py):
`composite_front_a`, the head switch, `composite_front_b1`, the vertical
blend, `composite_back_b2`. The stage functions that run pole cascades
take them as a `cascades` argument (ops/iir.Cascades): the plain T^3
cascades by default, kernel #9's (ops/fused_iir.CASCADES) on the
debug-tap route.

Reference functions reimplemented here:
- composite_video_chroma_lowpass[_lite]  ffmpeg_to_composite.cpp:353-431
- composite_video_yuv_to_ntsc            ffmpeg_to_composite.cpp:434-477
- composite_ntsc_to_yuv                  ffmpeg_to_composite.cpp:480-553
- composite_video_process (orchestrator) ffmpeg_to_composite.cpp:629-952
- black_key_feedback                     ffmpeg_to_composite.cpp:954-999
"""

from __future__ import annotations

import torch

from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, NTSC_RATE_422, iir_alpha
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.models.yiq import FieldStreams, _by_phase, _flip_table
from cvsim_tpu_torch.ops.cmath import c_div, c_int, clampu8
from cvsim_tpu_torch.ops.iir import PLAIN, Cascades, delay_writeback, iir_highpass
from cvsim_tpu_torch.ops.noise import (
    chroma_noise_walk_rows,
    smoothed_noise_walk_rows,
)
from cvsim_tpu_torch.utils import log

F32 = torch.float32
I32 = torch.int32


def _u8(s: torch.Tensor) -> torch.Tensor:
    return clampu8(s).to(I32)


# ------------------------------------------------------------ chroma lowpass

def chroma_lowpass(u, v, *, ntsc: bool = True, cascades: Cascades = PLAIN):
    """composite_video_chroma_lowpass (ffmpeg_to_composite.cpp:353-393):
    per chroma plane, a half-cutoff highpass "ringing" stage (s += hp(s))
    followed by 3 cascaded lowpasses, with delayed clampu8 writeback."""

    def one(p, cutoff, delay):
        alpha_hp = iir_alpha(NTSC_RATE_422, cutoff / 2)
        alpha_lp = iir_alpha(NTSC_RATE_422, cutoff)
        s = p.to(F32)
        s = s + iir_highpass(s, alpha_hp, 128.0)
        s = cascades.plain(s, alpha_lp, 128.0, 3)
        return delay_writeback(p, _u8(s), delay)

    u = one(u, 1300000.0, 2)
    v = one(v, 600000.0 if ntsc else 1300000.0, 4 if ntsc else 2)
    return u, v


def chroma_lowpass_lite(u, v, cascades: Cascades = PLAIN):
    """_lite variant (ffmpeg_to_composite.cpp:395-431): 3 lowpasses at
    rate/4 cutoff, delay 1, no highpass stage."""

    def one(p):
        alpha = iir_alpha(NTSC_RATE_422, NTSC_RATE_422 / 4)
        s = cascades.plain(p.to(F32), alpha, 128.0, 3)
        return delay_writeback(p, _u8(s), 1)

    return one(u), one(v)


# ----------------------------------------------------------------- QAM stage

def yuv_to_ntsc(y, u, v, xi, subcarrier_amplitude: int,
                nocolor_subcarrier: bool = False):
    """QAM-encode 4:2:2 chroma into luma (ffmpeg_to_composite.cpp:434-477)."""
    um_t, vm_t = yiq._qam_mult_tables(y.shape[-1], y.device)
    um = _by_phase(xi, um_t)
    vm = _by_phase(xi, vm_t)
    u2 = torch.repeat_interleave(u, 2, dim=-1) - 128
    v2 = torch.repeat_interleave(v, 2, dim=-1) - 128
    chroma = u2 * subcarrier_amplitude * um + v2 * subcarrier_amplitude * vm
    y = _u8(y + c_div(chroma, 50))
    if nocolor_subcarrier:
        u = torch.full_like(u, 128)
        v = torch.full_like(v, 128)
    return y, u, v


def ntsc_to_yuv(y, u, v, xi, subcarrier_amplitude_back: int,
                nocolor_subcarrier_after_yc_sep: bool = False):
    """Y/C separation + QAM decode (ffmpeg_to_composite.cpp:480-553).

    Box blur with 16-precharge: new_y[x] = (y[x-1]+y[x]+y[x+1]+y[x+2])/4
    (u8 sums, floor), pad value 16; chroma[x] = clampu8(y_pad[x+2]+128-new_y[x]).
    """
    w = y.shape[-1]
    yp = torch.nn.functional.pad(y, (1, 2), value=16)
    new_y = (yp[..., 0:w] + yp[..., 1:w + 1] + yp[..., 2:w + 2]
             + yp[..., 3:]) // 4                     # all positive: floor==trunc
    chroma = _u8(yp[..., 3:] + 128 - new_y)

    if nocolor_subcarrier_after_yc_sep:
        # debug tap: show separated chroma as luma (:504-509)
        return chroma, torch.full_like(u, 128), torch.full_like(v, 128)

    # sign flip (255 - c) on the negative half-cycles (:529-532); the loop
    # guard is x < w, so only in-range samples flip
    flip = _by_phase(xi, _flip_table(w, y.device, guard_x3=False))
    chroma = torch.where(flip, 255 - chroma, chroma)

    # rescale by 50/amp_back around the 128 bias (:534-536)
    chroma = _u8(c_div((chroma - 128) * 50, subcarrier_amplitude_back) + 128)

    # demux alternate samples into U,V with phase-dependent swap (:539-550)
    ce = chroma[..., 0::2]
    co = chroma[..., 1::2]
    odd_phase = (xi[..., None] & 1) == 1
    new_u = torch.where(odd_phase, 255 - co, 255 - ce)
    new_v = torch.where(odd_phase, 255 - ce, 255 - co)
    return new_y, new_u, new_v


# --------------------------------------------------------------- distortions

def composite_preemphasis_stage(y, pre_scale: float, pre_cut: float,
                                cascades: Cascades = PLAIN):
    """ffmpeg_to_composite.cpp:636-650."""
    alpha = iir_alpha(NTSC_RATE, pre_cut)
    return _u8(cascades.emph(y.to(F32), alpha, 16.0, 0, pre_scale))


def video_noise_stage(y, keys, mag: int):
    """ffmpeg_to_composite.cpp:653-665 (clampu8 at every sample); the walk
    resets per scanline. keys: [B] per-field stream ids."""
    _, l, w = y.shape
    walk = smoothed_noise_walk_rows(keys, l, w, mag)
    return _u8(y + c_int(walk).to(I32))


def chroma_noise_stage(u, v, keys, mag: int):
    """ffmpeg_to_composite.cpp:738-754: independent per-scanline walks on
    the two half-width planes; plane c's sample (y, x) draws stream index
    c*l*w2 + y*w2 + x. keys: [B] per-field stream ids."""
    _, l, w2 = u.shape
    wk = c_int(chroma_noise_walk_rows(keys, l, w2, mag)).to(I32)
    return _u8(u + wk[:, 0]), _u8(v + wk[:, 1])


def chroma_phase_noise_stage(u, v, sincos):
    """ffmpeg_to_composite.cpp:755-780, keeping the reference's rotation-
    matrix bug (u' = u*cos - u*sin, v' = v*cos + v*sin). sincos: [B, L, 2]."""
    s = sincos[..., 0:1]
    c = sincos[..., 1:2]
    uu = (u - 128).to(F32)
    vv = (v - 128).to(F32)
    return _u8(uu * c - uu * s + 128), _u8(vv * c + vv * s + 128)


def chroma_dropout_stage(u, v, keep):
    """ffmpeg_to_composite.cpp:931-941: wiped lines go to neutral 128.
    keep: [B, L] float 0/1 mask."""
    wipe = (keep == 0)[..., None]
    return torch.where(wipe, 128, u), torch.where(wipe, 128, v)


# ------------------------------------------------------------------ VHS block

def vhs_luma_lowpass(y, luma_cut: float, cascades: Cascades = PLAIN):
    """ffmpeg_to_composite.cpp:809-828."""
    alpha = iir_alpha(NTSC_RATE, luma_cut)
    return _u8(cascades.emph(y.to(F32), alpha, 16.0, 3, 1.6))


def vhs_chroma_lowpass(u, v, chroma_cut: float, chroma_delay: int,
                       cascades: Cascades = PLAIN):
    """ffmpeg_to_composite.cpp:830-852 (4:2:2 rate, 128 reset)."""
    alpha = iir_alpha(NTSC_RATE_422, chroma_cut)

    def one(p):
        s = cascades.plain(p.to(F32), alpha, 128.0, 3)
        return delay_writeback(p, _u8(s), chroma_delay)

    return one(u), one(v)


def vhs_chroma_vert_blend(u, v, init: int = 128):
    """2-line average over field lines (ffmpeg_to_composite.cpp:859-879).

    The reference's delay line starts at `init` and the loop begins at the
    second field line, so line 0 is untouched, line 1 blends with `init`
    (not with line 0: a quirk kept here), and line l>=2 blends with the
    original line l-1."""

    def blend(p):
        prev = torch.cat([torch.full_like(p[:, :1], init), p[:, 1:-1]], dim=1)
        return torch.cat([p[:, :1], (prev + p[:, 1:] + 1) >> 1], dim=1)

    return blend(u), blend(v)


def vhs_sharpen_luma(y, luma_cut: float, sharpen: float,
                     cascades: Cascades = PLAIN):
    """ffmpeg_to_composite.cpp:882-898: unsharp vs 3-pass lowpass at 2x cut."""
    alpha = iir_alpha(NTSC_RATE, luma_cut * 2)
    return _u8(cascades.unsharp(y.to(F32), alpha, 16.0, 3, sharpen))


def vhs_sharpen_chroma(u, v, chroma_cut: float, sharpen: float,
                       cascades: Cascades = PLAIN):
    """ffmpeg_to_composite.cpp:900-923."""
    alpha = iir_alpha(NTSC_RATE_422, chroma_cut * 2)

    def one(p):
        return _u8(cascades.unsharp(p.to(F32), alpha, 128.0, 3, sharpen))

    return one(u), one(v)


# ---------------------------------------------------------------- full chain

def composite_front_a(y, u, v, *, cfg: CompositeConfig, streams: FieldStreams,
                      cascades: Cascades = PLAIN):
    """The chain up to the head switch (kernel A's _a_math): input chroma
    lowpass, QAM encode, preemphasis, luma noise. int32 planes in;
    returns (encoded y, u, v): u and v are read further on only by the
    debug taps."""
    if cfg.composite_in_chroma_lowpass:
        u, v = chroma_lowpass(u, v, ntsc=cfg.ntsc, cascades=cascades)
    y, u, v = yuv_to_ntsc(y, u, v, streams.xi, cfg.subcarrier_amplitude,
                          cfg.nocolor_subcarrier)
    if cfg.composite_preemphasis != 0 and cfg.composite_preemphasis_cut > 0:
        y = composite_preemphasis_stage(
            y, cfg.composite_preemphasis, cfg.composite_preemphasis_cut,
            cascades)
    if cfg.video_noise != 0:
        y = video_noise_stage(y, streams.keys_ab[:, 0], cfg.video_noise)
    return y, u, v


def composite_front_b1(y, u, v, *, cfg: CompositeConfig,
                       streams: FieldStreams, cascades: Cascades = PLAIN):
    """The head-switched luma to the vertical blend (kernel B1's
    _b_front): Y/C separation and QAM decode, chroma noise, chroma phase
    noise, the VHS bandlimit. u, v: composite_front_a's chroma, read only
    by the debug taps (None without them)."""
    if not cfg.nocolor_subcarrier:
        y, u, v = ntsc_to_yuv(y, u, v, streams.xi,
                              cfg.subcarrier_amplitude_back,
                              cfg.nocolor_subcarrier_after_yc_sep)
    if cfg.video_chroma_noise != 0:
        u, v = chroma_noise_stage(u, v, streams.keys_ab[:, 1],
                                  cfg.video_chroma_noise)
    if cfg.video_chroma_phase_noise != 0:
        u, v = chroma_phase_noise_stage(u, v, streams.sincos)
    if cfg.emulating_vhs:
        speed = cfg.vhs_tape_speed
        y = vhs_luma_lowpass(y, speed.luma_cut, cascades)
        u, v = vhs_chroma_lowpass(u, v, speed.chroma_cut,
                                  speed.chroma_delay_gen1, cascades)
    return y, u, v


def composite_back_b2(y, u, v, *, cfg: CompositeConfig, streams: FieldStreams,
                      cascades: Cascades = PLAIN):
    """The blended planes to the chain's output (kernel B2's _b_back):
    luma and chroma sharpen with the re-encode/decode, dropout, Y/C
    recombine, output lowpass."""
    xi = streams.xi
    if cfg.emulating_vhs:
        speed = cfg.vhs_tape_speed
        y = vhs_sharpen_luma(y, speed.luma_cut, cfg.vhs_out_sharpen, cascades)
        u, v = vhs_sharpen_chroma(u, v, speed.chroma_cut,
                                  cfg.vhs_out_sharpen_chroma, cascades)
        if not cfg.vhs_svideo_out:
            y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude)
            y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude)

    if cfg.video_chroma_loss != 0:
        u, v = chroma_dropout_stage(u, v, streams.keep)

    for _ in range(cfg.video_yc_recombine):
        y, u, v = yuv_to_ntsc(y, u, v, xi, cfg.subcarrier_amplitude)
        y, u, v = ntsc_to_yuv(y, u, v, xi, cfg.subcarrier_amplitude)

    # gen-1 precedence: the full lowpass wins whenever it is on
    if cfg.composite_out_chroma_lowpass:
        u, v = chroma_lowpass(u, v, ntsc=cfg.ntsc, cascades=cascades)
    elif cfg.composite_out_chroma_lowpass_lite:
        u, v = chroma_lowpass_lite(u, v, cascades)
    return y, u, v


def does_vblend(cfg: CompositeConfig) -> bool:
    """Whether the chain runs the 2-line chroma blend between B1 and B2."""
    return cfg.emulating_vhs and cfg.vhs_chroma_vert_blend and cfg.ntsc


def composite_video_process_streams(y, u, v, *, cfg: CompositeConfig,
                                    streams: FieldStreams,
                                    cascades: Cascades = PLAIN):
    """Full gen-1 chain on a batch of fields with the given per-line inputs
    (composite_video_process, ffmpeg_to_composite.cpp:629-952, stage order
    kept). y, u, v: int32 planes; int32 out, uint8-valued."""
    y, u, v = composite_front_a(y, u, v, cfg=cfg, streams=streams,
                                cascades=cascades)
    if cfg.vhs_head_switching:
        # luma pad is black (16)
        y = yiq.head_switching_stage(y, streams.shifts, fill=16)
    y, u, v = composite_front_b1(y, u, v, cfg=cfg, streams=streams,
                                 cascades=cascades)
    if does_vblend(cfg):
        u, v = vhs_chroma_vert_blend(u, v)
    return composite_back_b2(y, u, v, cfg=cfg, streams=streams,
                             cascades=cascades)


def composite_video_process(y, u, v, fieldno, field_parity, key: int, *,
                            cfg: CompositeConfig,
                            cascades: Cascades = PLAIN):
    """Full gen-1 chain (stage path). key: the u32 stream seed
    (interop.key32_from_seed). int32 planes in and out."""
    _, l, w = y.shape
    streams = yiq.field_streams(cfg, fieldno, field_parity, l, w, key,
                                gen1=True)
    return composite_video_process_streams(
        y.to(I32), u.to(I32), v.to(I32), cfg=cfg, streams=streams,
        cascades=cascades)


def composite_video_process_auto(y, u, v, fieldno, field_parity, key: int, *,
                                 cfg: CompositeConfig):
    """The main path, dispatched on y's device: fused_yuv.prepare, then
    fused_yuv.composite_video_process_fused (kernel #5, or #6-#8 on
    rasters above the reference's single-tile budget; their plain
    versions on a CPU tensor; it never falls back). The debug taps
    (-nocolor-subcarrier[-after-yc-sep]), which those kernels do not
    carry, take the stage path with its pole cascades on kernel #9
    (ops/fused_iir.CASCADES: the kernel on a CUDA tensor, its plain
    version on a CPU one), as the JAX package's CVSIM_PALLAS=1 setting
    does. uint8 planes out."""
    with log.span("gen1.call", entry=True):
        if cfg.nocolor_subcarrier or cfg.nocolor_subcarrier_after_yc_sep:
            from cvsim_tpu_torch.ops import fused_iir

            out = composite_video_process(
                y, u, v, log.to_device(fieldno, y.device),
                log.to_device(field_parity, y.device), key,
                cfg=cfg, cascades=fused_iir.CASCADES)
            return tuple(p.to(torch.uint8) for p in out)
        from cvsim_tpu_torch.models import fused_yuv

        y, u, v = (p.to(torch.uint8) for p in (y, u, v))
        prep = fused_yuv.prepare(cfg, y, fieldno, field_parity, key)
        with log.span("gen1.launch"):
            return fused_yuv.composite_video_process_fused(y, u, v, prep,
                                                           cfg=cfg)


# ---------------------------------------------------------- black key stage

def black_key_feedback(y, u, v, fy, fu, fv, level: int):
    """Hall-of-mirrors keying vs a persistent filter frame
    (ffmpeg_to_composite.cpp:954-999). Keys where
    (Y - 16 - level) + (|U+V-256| - level) <= 0. The even sample of each
    4:2:2 pair is keyed against the pair's original chroma and, when keyed,
    replaces that chroma with the filter frame's (:959-964); the odd
    sample's decision then reads the possibly-replaced chroma (the in-place
    sequential order at :989-990). Returns (out planes, new filter planes),
    which are the same planes."""
    y_even = y[..., 0::2]
    y_odd = y[..., 1::2]
    keyed_even = ((y_even - (16 + level))
                  + ((u + v - 256).abs() - level)) <= 0
    out_u = torch.where(keyed_even, fu, u)
    out_v = torch.where(keyed_even, fv, v)
    keyed_odd = ((y_odd - (16 + level))
                 + ((out_u + out_v - 256).abs() - level)) <= 0
    out_even = torch.where(keyed_even, fy[..., 0::2], y_even)
    out_odd = torch.where(keyed_odd, fy[..., 1::2], y_odd)
    out_y = torch.stack([out_even, out_odd], dim=-1).reshape(y.shape)
    return (out_y, out_u, out_v), (out_y, out_u, out_v)
