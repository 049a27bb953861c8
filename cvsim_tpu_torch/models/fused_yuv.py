"""The gen-1 chain as hand-written CUDA kernels (twin of
cvsim_tpu.models.fused_yuv).

- `prepare`: models/chain_prep.prepare with the 11 stacked IIR
  constant tables of the gen-1 chain (`_alpha_consts_gen1`).
- Kernel #5, the whole chain: `composite_video_process_merged` wraps
  csrc/yuv_chain.cu's `cvsim_yuv_chain`; `chain_reference` is its plain
  PyTorch version, built from the stage functions of models/yuv422.py.
- Kernels #6-#8, the JAX package's split program (its kernels A, B1,
  B2): `stage_a`, `stage_b1`, `stage_b2` wrap `cvsim_yuv_a/_b1/_b2`;
  `stage_*_reference` are their plain versions (yuv422.composite_front_a,
  _front_b1, composite_back_b2). Between them run the seams
  `head_switch_rows` and `vblend_rows` in plain PyTorch, as the JAX
  package runs them in XLA; `composite_video_process_split` chains them.
- `composite_video_process_fused` takes the route the JAX dispatcher
  takes (`takes_split`): #5 while a field fits the reference's
  single-tile budget, #6-#8 above it (576i PAL, 1080i).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel through kernels.launch or raises (kernels.device_of).
Planes are uint8 in and out: y [B, L, W], u and v [B, L, W//2], and so
are the planes between #6, #7 and #8 (every value there is clamped to
[0, 255] or is the floor of a mean of such values). The TPU path's line
tiling, 8-aligned head-switch window and stride-2 pick matrices exist for
Mosaic's layout rules and have no counterpart here.
yuv422.composite_video_process_auto is the entry point of the main path.
"""

from __future__ import annotations

import ctypes

import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, NTSC_RATE_422, iir_alpha
from cvsim_tpu_torch.models import chain_prep, yiq, yuv422
from cvsim_tpu_torch.models.chain_prep import (Prepared, check,
                                               check_prepared, streams,
                                               u32_as_i32)
from cvsim_tpu_torch.ops.blocked_iir import BLOCK, full_float32
from cvsim_tpu_torch.utils import log

N_TABLES = 11

# The JAX dispatcher's route (cvsim_tpu/models/fused_yuv.py:57-59,
# 493-503): its merged kernel while a field of L lines fits
# L * wp_ref <= min(single-tile budget, 2 * tile budget), its split
# program above. These are the reference's VMEM budgets, copied so that
# the port runs the reference's program at every raster; the card has no
# such limit.
REF_SINGLE_TILE_BUDGET = 200_000
REF_TILE_BUDGET = 130_000


# ------------------------------------------------------------ IIR tables

def _alpha_consts_gen1(cfg: CompositeConfig):
    """Stacked decay constants (chain_prep.stack_alpha_consts); rows are
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
    return chain_prep.stack_alpha_consts(alphas)


# ------------------------------------------------------------ inputs

def prepare(cfg: CompositeConfig, y: torch.Tensor, fieldno: torch.Tensor,
            field_parity: torch.Tensor, key: int) -> Prepared:
    """chain_prep.prepare of uint8 luma planes y [B, L, W], under
    `gen1.prepare`."""
    return chain_prep.prepare("gen1", _alpha_consts_gen1, cfg, y, fieldno,
                              field_parity, key, gen1=True)


def takes_split(l: int, w: int) -> bool:
    """Whether the JAX dispatcher runs a field of l lines and w samples
    through its split program: l * wp_ref above the single-tile budget,
    with wp_ref = 2 * (w/2 padded to 128), the padded width of its
    stride-2 selection (not the port's: 2048 vs 1920 at w = 1888)."""
    wp_ref = 2 * (-(-(w // 2) // BLOCK) * BLOCK)
    return l * wp_ref > min(REF_SINGLE_TILE_BUDGET, 2 * REF_TILE_BUDGET)


# ------------------------------------------------------------ plain versions

def _u8(planes):
    return tuple(p.to(torch.uint8) for p in planes)


def _i32(planes):
    return tuple(p.to(torch.int32) for p in planes)


def chain_reference(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    prep: Prepared, *, cfg: CompositeConfig):
    """Plain PyTorch version of kernel #5: uint8 planes in and out, the
    stage path of models/yuv422.py on `prep`'s per-line inputs. The stage
    functions derive the same IIR tables from cfg that `prep` carries."""
    full_float32(y)
    out = yuv422.composite_video_process_streams(
        *_i32((y, u, v)), cfg=cfg, streams=streams(prep))
    return _u8(out)


def stage_a_reference(y, u, v, prep: Prepared, *, cfg: CompositeConfig):
    """Plain version of kernel #6: uint8 planes -> the encoded luma, uint8
    [B, L, W], before the head switch."""
    full_float32(y)
    y_enc, _, _ = yuv422.composite_front_a(*_i32((y, u, v)), cfg=cfg,
                                           streams=streams(prep))
    return y_enc.to(torch.uint8)


def stage_b1_reference(y, prep: Prepared, *, cfg: CompositeConfig):
    """Plain version of kernel #7: the head-switched luma, uint8 [B, L, W]
    -> y, u, v uint8, before the vertical blend."""
    full_float32(y)
    out = yuv422.composite_front_b1(y.to(torch.int32), None, None, cfg=cfg,
                                    streams=streams(prep))
    return _u8(out)


def stage_b2_reference(y, u, v, prep: Prepared, *, cfg: CompositeConfig):
    """Plain version of kernel #8: the blended y, u, v uint8 -> the chain's
    output, uint8."""
    full_float32(y)
    out = yuv422.composite_back_b2(*_i32((y, u, v)), cfg=cfg,
                                   streams=streams(prep))
    return _u8(out)


# ------------------------------------------------------------ the seams

def head_switch_rows(y: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """The VHS head switch between #6 and #7 on the uint8 luma [B, L, W]:
    each row rotates by its shift within the row padded with luma black
    (16) (yiq.head_switching_stage; gen-1 takes the switch point for both
    axes, so the one shift table serves)."""
    return yiq.head_switching_stage(y, shifts, fill=16)


def vblend_rows(u: torch.Tensor, v: torch.Tensor):
    """The 2-line chroma blend between #7 and #8 on uint8 chroma
    [B, L, W//2]: line 0 kept, line 1 blended with 128, line l with line
    l-1 (yuv422.vhs_chroma_vert_blend)."""
    return _u8(yuv422.vhs_chroma_vert_blend(*_i32((u, v))))


# ------------------------------------------------------------ the kernels

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


def _no_taps(cfg: CompositeConfig):
    if cfg.nocolor_subcarrier or cfg.nocolor_subcarrier_after_yc_sep:
        raise ValueError("the gen-1 kernels do not carry the debug taps "
                         "(yuv422.composite_video_process_auto routes them)")


def _launch_params(cfg: CompositeConfig, prep: Prepared, y: torch.Tensor,
                   dev: torch.device, planes: dict) -> _YuvParams:
    """Checks the uint8 planes ({name: (tensor, "luma" | "chroma")}) and
    the per-line inputs against y's [B, L, W]; the launch arguments."""
    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, W], got {tuple(y.shape)}")
    b, l, w = y.shape
    w2 = w // 2
    for name, (t, kind) in planes.items():
        check(name, t, torch.uint8, (b, l, w if kind == "luma" else w2), dev)
    check_prepared(prep, b, l, dev, N_TABLES)
    wp = -(-w // BLOCK) * BLOCK
    wp2 = -(-w2 // BLOCK) * BLOCK
    return _yuv_params(cfg, b, l, w, wp, w2, wp2)


def composite_video_process_merged(y: torch.Tensor, u: torch.Tensor,
                                   v: torch.Tensor, prep: Prepared, *,
                                   cfg: CompositeConfig):
    """Kernel #5 (yuv_chain): the whole gen-1 chain on uint8 planes y
    [B, L, W], u, v [B, L, W//2]; uint8 out. A CPU tensor runs
    chain_reference; a CUDA tensor launches the kernel of
    csrc/yuv_chain.cu (built at first use) or raises."""
    _no_taps(cfg)
    dev = kernels.device_of(y, "yuv_chain")
    if dev is None:
        return chain_reference(y, u, v, prep, cfg=cfg)
    params = _launch_params(cfg, prep, y, dev, {
        "y": (y, "luma"), "u": (u, "chroma"), "v": (v, "chroma")})
    b, l, w = y.shape
    keys = u32_as_i32(prep.keys_ab)
    scratch = torch.empty(b * l * (w + 2 * (w // 2)), dtype=torch.uint8,
                          device=dev)
    y_out, u_out, v_out = (torch.empty_like(p) for p in (y, u, v))
    kernels.launch("yuv_chain", y, u, v, prep.xi, keys, prep.sincos,
                   prep.keep, prep.shifts, *prep.tables, scratch, y_out,
                   u_out, v_out, params, device=dev)
    return y_out, u_out, v_out


def stage_a(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            prep: Prepared, *, cfg: CompositeConfig) -> torch.Tensor:
    """Kernel #6 (yuv_a): uint8 planes -> the encoded luma, uint8
    [B, L, W]. CPU tensor: stage_a_reference; CUDA tensor: the kernel or
    raise."""
    _no_taps(cfg)
    dev = kernels.device_of(y, "yuv_a")
    if dev is None:
        return stage_a_reference(y, u, v, prep, cfg=cfg)
    params = _launch_params(cfg, prep, y, dev, {
        "y": (y, "luma"), "u": (u, "chroma"), "v": (v, "chroma")})
    keys = u32_as_i32(prep.keys_ab)
    y_out = torch.empty_like(y)
    kernels.launch("yuv_a", y, u, v, prep.xi, keys, *prep.tables, y_out,
                   params, device=dev)
    return y_out


def stage_b1(y: torch.Tensor, prep: Prepared, *, cfg: CompositeConfig):
    """Kernel #7 (yuv_b1): the head-switched uint8 luma [B, L, W] -> y, u,
    v uint8. CPU tensor: stage_b1_reference; CUDA tensor: the kernel or
    raise."""
    _no_taps(cfg)
    dev = kernels.device_of(y, "yuv_b1")
    if dev is None:
        return stage_b1_reference(y, prep, cfg=cfg)
    params = _launch_params(cfg, prep, y, dev, {"y": (y, "luma")})
    b, l, w = y.shape
    keys = u32_as_i32(prep.keys_ab)
    y_out = torch.empty_like(y)
    u_out = torch.empty((b, l, w // 2), dtype=torch.uint8, device=dev)
    v_out = torch.empty_like(u_out)
    kernels.launch("yuv_b1", y, prep.xi, keys, prep.sincos, *prep.tables,
                   y_out, u_out, v_out, params, device=dev)
    return y_out, u_out, v_out


def stage_b2(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             prep: Prepared, *, cfg: CompositeConfig):
    """Kernel #8 (yuv_b2): the blended uint8 y, u, v -> the chain's output,
    uint8. CPU tensor: stage_b2_reference; CUDA tensor: the kernel or
    raise."""
    _no_taps(cfg)
    dev = kernels.device_of(y, "yuv_b2")
    if dev is None:
        return stage_b2_reference(y, u, v, prep, cfg=cfg)
    params = _launch_params(cfg, prep, y, dev, {
        "y": (y, "luma"), "u": (u, "chroma"), "v": (v, "chroma")})
    y_out, u_out, v_out = (torch.empty_like(p) for p in (y, u, v))
    kernels.launch("yuv_b2", y, u, v, prep.xi, prep.keep, *prep.tables,
                   y_out, u_out, v_out, params, device=dev)
    return y_out, u_out, v_out


def composite_video_process_split(y: torch.Tensor, u: torch.Tensor,
                                  v: torch.Tensor, prep: Prepared, *,
                                  cfg: CompositeConfig):
    """The JAX package's split program: #6, the head switch, #7, the
    blend, #8, on uint8 planes; uint8 out. Each step is a span
    `gen1.split.a`, `.switch`, `.b1`, `.blend`, `.b2`."""
    with log.span("gen1.split.a"):
        y_enc = stage_a(y, u, v, prep, cfg=cfg)
    if cfg.vhs_head_switching:
        with log.span("gen1.split.switch"):
            y_enc = head_switch_rows(y_enc, prep.shifts)
    with log.span("gen1.split.b1"):
        y1, u1, v1 = stage_b1(y_enc, prep, cfg=cfg)
    if yuv422.does_vblend(cfg):
        with log.span("gen1.split.blend"):
            u1, v1 = vblend_rows(u1, v1)
    with log.span("gen1.split.b2"):
        return stage_b2(y1, u1, v1, prep, cfg=cfg)


def composite_video_process_fused(y: torch.Tensor, u: torch.Tensor,
                                  v: torch.Tensor, prep: Prepared, *,
                                  cfg: CompositeConfig):
    """The gen-1 chain on uint8 planes y [B, L, W], u, v [B, L, W//2];
    uint8 out, by the JAX dispatcher's route: kernel #5 while the field
    fits the reference's single-tile budget, #6-#8 above it
    (takes_split). The debug taps (-nocolor-subcarrier[-after-yc-sep])
    are not carried (yuv422.composite_video_process_auto routes them)."""
    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, W], got {tuple(y.shape)}")
    if takes_split(y.shape[1], y.shape[2]):
        return composite_video_process_split(y, u, v, prep, cfg=cfg)
    return composite_video_process_merged(y, u, v, prep, cfg=cfg)
