"""The whole gen-1 chain as one hand-written CUDA kernel pair (twin of
cvsim_tpu.models.fused_yuv).

Three parts, as in models/fused_yiq.py:

- `prepare`: every per-field and per-line input of the chain (phase xi,
  the two in-kernel noise stream ids, chroma-phase sin/cos, dropout keep
  mask, the full per-row head-switch shift table) plus the 11 stacked IIR
  constant tables of the gen-1 chain.
- `chain_reference`: the plain PyTorch version of the kernel, built from
  the stage functions of models/yuv422.py, with the kernel's signature.
- `composite_video_process_fused`: the wrapper of csrc/yuv_chain.cu. On a
  CPU tensor it runs `chain_reference`; on a CUDA tensor it launches the
  kernel or raises.

Planes are uint8 in and out: y [B, L, W], u and v [B, L, W//2]. The TPU
path's line tiling, 8-aligned head-switch window and stride-2 pick
matrices exist for Mosaic's layout rules and have no counterpart here.
yuv422.composite_video_process_auto is the entry point of the main path.
"""

from __future__ import annotations

import ctypes

import torch

from cvsim_tpu.config import CompositeConfig, NTSC_RATE, NTSC_RATE_422, iir_alpha
from cvsim_tpu_torch.models import yiq, yuv422
from cvsim_tpu_torch.models.fused_yiq import (Prepared, _check,
                                              _stack_alpha_consts, _u32_as_i32)
from cvsim_tpu_torch.ops.blocked_iir import BLOCK

# count of kernel launches (one per composite_video_process_fused call on a
# CUDA tensor); read by tests and chip_smoke.py to prove the path ran
KERNEL_LAUNCHES = 0
N_TABLES = 11


# ------------------------------------------------------------ IIR tables

def _alpha_consts_gen1(cfg: CompositeConfig):
    """Stacked decay constants (fused_yiq._stack_alpha_consts); rows are
    0: in/out U cut (1.3MHz @422)      1: U cut/2 highpass
    2: in/out V cut (0.6/1.3MHz @422)  3: V cut/2 highpass
    4: preemphasis cut (@4fsc)         5: VHS luma cut (@4fsc)
    6: VHS chroma cut (@422)           7: sharpen luma 2x cut (@4fsc)
    8: sharpen chroma 2x cut (@422)    9: out-lite rate/4 (@422)
    10: the alpha-0.5 noise walk."""
    u_cut = 1300000.0
    v_cut = 600000.0 if cfg.ntsc else 1300000.0
    speed = cfg.vhs_tape_speed
    # the stage path gates preemphasis on cut > 0, so <= 0 only fills an
    # unused row (a 1.0 dummy keeps iir_alpha finite)
    pre_cut = (cfg.composite_preemphasis_cut
               if cfg.composite_preemphasis_cut > 0 else 1.0)
    specs = [
        (NTSC_RATE_422, u_cut), (NTSC_RATE_422, u_cut / 2),
        (NTSC_RATE_422, v_cut), (NTSC_RATE_422, v_cut / 2),
        (NTSC_RATE, pre_cut),
        (NTSC_RATE, speed.luma_cut),
        (NTSC_RATE_422, speed.chroma_cut),
        (NTSC_RATE, speed.luma_cut * 2),
        (NTSC_RATE_422, speed.chroma_cut * 2),
        (NTSC_RATE_422, NTSC_RATE_422 / 4),
    ]
    alphas = [float(iir_alpha(rate, cut)) for rate, cut in specs] + [0.5]
    return _stack_alpha_consts(alphas)


# ------------------------------------------------------------ inputs

def prepare(cfg: CompositeConfig, y: torch.Tensor, fieldno: torch.Tensor,
            field_parity: torch.Tensor, key: int) -> Prepared:
    """Everything the chain needs besides the planes, on y's device.
    key: the u32 stream seed (interop.key32_from_seed)."""
    _, l, w = y.shape
    dev = y.device
    s = yiq.field_streams(cfg, fieldno.to(dev), field_parity.to(dev), l, w,
                          key, gen1=True)
    tables = tuple(torch.from_numpy(t).to(dev)
                   for t in _alpha_consts_gen1(cfg))
    return Prepared(s.xi, s.keys_ab, s.sincos, s.keep, s.shifts, tables)


# ------------------------------------------------------------ plain version

def chain_reference(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    prep: Prepared, *, cfg: CompositeConfig):
    """Plain PyTorch version of the kernel: uint8 planes in and out, the
    stage path of models/yuv422.py on `prep`'s per-line inputs. The stage
    functions derive the same IIR tables from cfg that `prep` carries."""
    if y.is_cuda:
        # the blocked IIR's integer exactness needs full float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    streams = yiq.FieldStreams(prep.xi, prep.keys_ab, prep.sincos,
                               prep.keep, prep.shifts)
    out = yuv422.composite_video_process_streams(
        y.to(torch.int32), u.to(torch.int32), v.to(torch.int32), cfg=cfg,
        streams=streams)
    return tuple(p.to(torch.uint8) for p in out)


# ------------------------------------------------------------ the kernel

class _YuvParams(ctypes.Structure):
    """Mirror of `gen1::Params` in csrc/yuv_chain.cu (field order matters)."""
    _fields_ = [(name, ctypes.c_float if name.endswith("_gain")
                 else ctypes.c_int) for name in (
        "b", "l", "w", "wp", "w2", "wp2", "amp", "amp_back", "in_lowpass",
        "v_delay", "preemph", "pre_gain", "video_noise", "chroma_noise",
        "phase_noise", "vhs", "chroma_delay", "vblend", "sharpen_gain",
        "sharpen_chroma_gain", "svideo", "chroma_loss", "yc_recombine",
        "out_lowpass")]


def _yuv_params(cfg: CompositeConfig, b: int, l: int, w: int, wp: int,
                w2: int, wp2: int) -> _YuvParams:
    do_pre = (cfg.composite_preemphasis != 0
              and cfg.composite_preemphasis_cut > 0)
    # gen-1 precedence: the full lowpass wins whenever it is on
    if cfg.composite_out_chroma_lowpass:
        out_lowpass = 2
    elif cfg.composite_out_chroma_lowpass_lite:
        out_lowpass = 1
    else:
        out_lowpass = 0
    return _YuvParams(
        b=b, l=l, w=w, wp=wp, w2=w2, wp2=wp2,
        amp=cfg.subcarrier_amplitude,
        amp_back=cfg.subcarrier_amplitude_back,
        in_lowpass=int(cfg.composite_in_chroma_lowpass),
        v_delay=4 if cfg.ntsc else 2,
        preemph=int(do_pre),
        pre_gain=float(cfg.composite_preemphasis),
        video_noise=cfg.video_noise,
        chroma_noise=cfg.video_chroma_noise,
        phase_noise=int(cfg.video_chroma_phase_noise != 0),
        vhs=int(cfg.emulating_vhs),
        chroma_delay=cfg.vhs_tape_speed.chroma_delay_gen1,
        vblend=int(cfg.emulating_vhs and cfg.vhs_chroma_vert_blend
                   and cfg.ntsc),
        sharpen_gain=float(cfg.vhs_out_sharpen),
        sharpen_chroma_gain=float(cfg.vhs_out_sharpen_chroma),
        svideo=int(cfg.vhs_svideo_out),
        chroma_loss=int(cfg.video_chroma_loss != 0),
        yc_recombine=cfg.video_yc_recombine,
        out_lowpass=out_lowpass)


def composite_video_process_fused(y: torch.Tensor, u: torch.Tensor,
                                  v: torch.Tensor, prep: Prepared, *,
                                  cfg: CompositeConfig):
    """The gen-1 chain on uint8 planes y [B, L, W], u, v [B, L, W//2];
    uint8 out. The debug taps (-nocolor-subcarrier[-after-yc-sep]) are
    not carried (yuv422.composite_video_process_auto routes them).

    A CPU tensor runs chain_reference. A CUDA tensor launches the kernel
    of csrc/yuv_chain.cu (built at first use) or raises; there is no
    fallback."""
    global KERNEL_LAUNCHES
    if cfg.nocolor_subcarrier or cfg.nocolor_subcarrier_after_yc_sep:
        raise ValueError("the gen-1 kernel does not carry the debug taps")
    if y.device.type == "cpu":
        return chain_reference(y, u, v, prep, cfg=cfg)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    from cvsim_tpu_torch import kernels

    dev = y.device
    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, W], got {tuple(y.shape)}")
    b, l, w = y.shape
    w2 = w // 2
    wp = -(-w // BLOCK) * BLOCK
    wp2 = -(-w2 // BLOCK) * BLOCK
    _check("y", y, torch.uint8, (b, l, w), dev)
    _check("u", u, torch.uint8, (b, l, w2), dev)
    _check("v", v, torch.uint8, (b, l, w2), dev)
    _check("xi", prep.xi, torch.int32, (b, l), dev)
    _check("keys_ab", prep.keys_ab, torch.int64, (b, 2), dev)
    _check("sincos", prep.sincos, torch.float32, (b, l, 2), dev)
    _check("keep", prep.keep, torch.float32, (b, l), dev)
    _check("shifts", prep.shifts, torch.int32, (b, l), dev)
    table_shapes = ((N_TABLES, BLOCK, BLOCK), (N_TABLES, BLOCK),
                    (N_TABLES, BLOCK, BLOCK), (N_TABLES, 8, BLOCK),
                    (N_TABLES, BLOCK, 8))
    for k, (t, shape) in enumerate(zip(prep.tables, table_shapes)):
        _check(f"tables[{k}]", t, torch.float32, shape, dev)

    keys = _u32_as_i32(prep.keys_ab)
    scratch = torch.empty(b * l * (w + 2 * w2), dtype=torch.uint8, device=dev)
    y_out = torch.empty_like(y)
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    params = _yuv_params(cfg, b, l, w, wp, w2, wp2)
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cvsim_yuv_chain(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), prep.xi.data_ptr(),
            keys.data_ptr(), prep.sincos.data_ptr(), prep.keep.data_ptr(),
            prep.shifts.data_ptr(), *(t.data_ptr() for t in prep.tables),
            scratch.data_ptr(), y_out.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), ctypes.addressof(params), stream)
    if rc != 0:
        raise RuntimeError(f"yuv_chain launch failed: {kernels.error_string(rc)}")
    KERNEL_LAUNCHES += 1
    return y_out, u_out, v_out
