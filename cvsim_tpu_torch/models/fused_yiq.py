"""The whole gen-2 chain as one hand-written CUDA kernel pair (twin of
cvsim_tpu.models.fused_yiq).

Three parts:

- `prepare`: every per-field and per-line input of the chain (phase xi,
  the two in-kernel noise stream ids, chroma-phase sin/cos, dropout keep
  mask, the full per-row head-switch shift table) plus the stacked IIR
  constant tables. The TPU path's tiling, padding and 8-aligned
  head-switch window exist for Mosaic's layout rules and have no
  counterpart here.
- `chain_reference`: the plain PyTorch version of the kernel, built from
  the stage functions of models/yiq.py, with the kernel's signature.
- `composite_layer_rgb_fused`: the wrapper of csrc/yiq_chain.cu. On a CPU
  tensor it runs `chain_reference`; on a CUDA tensor it launches the
  kernel or raises.

yiq.composite_layer_rgb_auto is the entry point of the main path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from cvsim_tpu.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.ops.blocked_iir import BLOCK, _cascade3_consts, _decay_consts

# count of kernel launches (one per composite_layer_rgb_fused call on a
# CUDA tensor); read by tests and chip_smoke.py to prove the path ran
KERNEL_LAUNCHES = 0


# ------------------------------------------------------------ IIR tables

def _alpha_consts(cfg: CompositeConfig):
    """Stacked decay constants: rows are
    0: in/out I 1.3MHz, 1: in/out Q 0.6MHz, 2: preemphasis cut,
    3: VHS luma cut, 4: VHS chroma cut, 5: VHS sharpen (4x luma cut),
    6: out 'tv' 2.6MHz, 7: the alpha-0.5 noise walk."""
    speed = cfg.vhs_tape_speed
    # the stage path gates preemphasis on cut > 0, so <= 0 only fills an
    # unused row (a 1.0 dummy keeps iir_alpha finite)
    pre_cut = (cfg.composite_preemphasis_cut
               if cfg.composite_preemphasis_cut > 0 else 1.0)
    cuts = [1300000.0, 600000.0, pre_cut,
            speed.luma_cut, speed.chroma_cut, speed.luma_cut * 4.0,
            2600000.0]
    alphas = [float(iir_alpha(NTSC_RATE, c)) for c in cuts] + [0.5]
    return _stack_alpha_consts(alphas)


def _stack_alpha_consts(alphas):
    """(tt, d, tt3, d3, vt) numpy stacks for a list of alphas: the single-
    pole constants plus the composed 3-pole-cascade constants (T^3, its
    carry vectors, the last rows of T/T^2), pre-transposed so that the
    kernel reads column t of row j at [j, t]."""
    tts, ds, tt3s, d3s, vts = [], [], [], [], []
    for a in alphas:
        T, d, _pk = _decay_consts(a, BLOCK, "float32")
        T3, dc1, dc2, _d, v12 = _cascade3_consts(a, BLOCK, "float32")
        tts.append(T.T.copy())
        ds.append(d)
        tt3s.append(T3.T.copy())
        d3 = np.zeros((8, BLOCK), np.float32)
        d3[0] = dc1
        d3[1] = dc2
        d3s.append(d3)
        vt = np.zeros((BLOCK, 8), np.float32)
        vt[:, 0] = v12[0]
        vt[:, 1] = v12[1]
        vts.append(vt)
    return tuple(np.stack(x) for x in (tts, ds, tt3s, d3s, vts))


# ------------------------------------------------------------ inputs

class Prepared(NamedTuple):
    """Inputs of one chain call, all on the device of the fields (shared
    with the gen-1 chain of models/fused_yuv.py)."""
    xi: torch.Tensor        # int32 [B, L]
    keys_ab: torch.Tensor   # int64 [B, 2] u32 stream ids (luma, chroma noise)
    sincos: torch.Tensor    # f32 [B, L, 2]
    keep: torch.Tensor      # f32 [B, L]
    shifts: torch.Tensor    # int32 [B, L]
    tables: tuple           # f32 tt [N,128,128], d [N,128], tt3 [N,128,128],
                            #     d3 [N,8,128], vt [N,128,8]; N = 8 rows
                            #     for gen-2, 11 for gen-1


def prepare(cfg: CompositeConfig, rgb: torch.Tensor, fieldno: torch.Tensor,
            field_parity: torch.Tensor, key: int) -> Prepared:
    """Everything the chain needs besides the RGB planes, on rgb's device.
    key: the u32 stream seed (interop.key32_from_seed)."""
    _, l, w, _ = rgb.shape
    dev = rgb.device
    s = yiq.field_streams(cfg, fieldno.to(dev), field_parity.to(dev),
                          l, w, key)
    tables = tuple(torch.from_numpy(t).to(dev) for t in _alpha_consts(cfg))
    return Prepared(s.xi, s.keys_ab, s.sincos, s.keep, s.shifts, tables)


# ------------------------------------------------------------ plain version

def chain_reference(rgb: torch.Tensor, prep: Prepared, *,
                    cfg: CompositeConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [B, L, W, 3] in and out,
    the stage path of models/yiq.py on `prep`'s per-line inputs. The
    stage functions derive the same IIR tables from cfg that `prep`
    carries (both come from _decay_consts/_cascade3_consts on the same
    alphas)."""
    if rgb.is_cuda:
        # the blocked IIR's integer exactness needs full float32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    streams = yiq.FieldStreams(prep.xi, prep.keys_ab, prep.sincos,
                               prep.keep, prep.shifts)
    return yiq.composite_layer_rgb_streams(rgb, streams, cfg=cfg)


# ------------------------------------------------------------ the kernel

class _ChainParams(ctypes.Structure):
    """Mirror of `ChainParams` in csrc/yiq_chain.cu (field order matters)."""
    _fields_ = [(name, ctypes.c_float if name.endswith("_gain")
                 else ctypes.c_int) for name in (
        "b", "l", "w", "wp", "amp", "amp_back", "in_lowpass", "preemph",
        "pre_gain", "video_noise", "nocolor", "chroma_noise",
        "phase_noise", "gen1_bug", "vhs", "chroma_delay", "vblend",
        "sharpen_gain", "svideo", "chroma_loss", "yc_recombine",
        "out_lowpass")]


def _chain_params(cfg: CompositeConfig, b: int, l: int, w: int,
                  wp: int) -> _ChainParams:
    do_pre = (cfg.composite_preemphasis != 0
              and cfg.composite_preemphasis_cut > 0)
    if not cfg.composite_out_chroma_lowpass:
        out_lowpass = 0
    elif cfg.composite_out_chroma_lowpass_lite:
        out_lowpass = 1
    else:
        out_lowpass = 2
    return _ChainParams(
        b=b, l=l, w=w, wp=wp,
        amp=cfg.subcarrier_amplitude,
        amp_back=cfg.subcarrier_amplitude_back,
        in_lowpass=int(cfg.composite_in_chroma_lowpass),
        preemph=int(do_pre),
        pre_gain=float(cfg.composite_preemphasis),
        video_noise=cfg.video_noise,
        nocolor=int(cfg.nocolor_subcarrier),
        chroma_noise=cfg.video_chroma_noise,
        phase_noise=int(cfg.video_chroma_phase_noise != 0),
        gen1_bug=int(cfg.chroma_phase_noise_gen1_bug),
        vhs=int(cfg.emulating_vhs),
        chroma_delay=cfg.vhs_tape_speed.chroma_delay_gen2,
        vblend=int(cfg.emulating_vhs and cfg.vhs_chroma_vert_blend
                   and cfg.ntsc),
        sharpen_gain=float(cfg.vhs_out_sharpen * 2.0),
        svideo=int(cfg.vhs_svideo_out),
        chroma_loss=int(cfg.video_chroma_loss != 0),
        yc_recombine=cfg.video_yc_recombine,
        out_lowpass=out_lowpass)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _u32_as_i32(keys: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bits as int32."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)


def composite_layer_rgb_fused(rgb: torch.Tensor, prep: Prepared, *,
                              cfg: CompositeConfig) -> torch.Tensor:
    """The gen-2 chain on uint8 [B, L, W, 3] fields; uint8 out.

    A CPU tensor runs chain_reference. A CUDA tensor launches the kernel
    of csrc/yiq_chain.cu (built at first use) or raises; there is no
    fallback."""
    global KERNEL_LAUNCHES
    if rgb.device.type == "cpu":
        return chain_reference(rgb, prep, cfg=cfg)
    if rgb.device.type != "cuda":
        raise ValueError(f"no kernel for device {rgb.device}")
    from cvsim_tpu_torch import kernels

    dev = rgb.device
    if rgb.ndim != 4:
        raise ValueError(f"rgb: expected [B, L, W, 3], got {tuple(rgb.shape)}")
    b, l, w, _ = rgb.shape
    wp = -(-w // BLOCK) * BLOCK
    _check("rgb", rgb, torch.uint8, (b, l, w, 3), dev)
    _check("xi", prep.xi, torch.int32, (b, l), dev)
    _check("keys_ab", prep.keys_ab, torch.int64, (b, 2), dev)
    _check("sincos", prep.sincos, torch.float32, (b, l, 2), dev)
    _check("keep", prep.keep, torch.float32, (b, l), dev)
    _check("shifts", prep.shifts, torch.int32, (b, l), dev)
    table_shapes = ((8, BLOCK, BLOCK), (8, BLOCK), (8, BLOCK, BLOCK),
                    (8, 8, BLOCK), (8, BLOCK, 8))
    for k, (t, shape) in enumerate(zip(prep.tables, table_shapes)):
        _check(f"tables[{k}]", t, torch.float32, shape, dev)

    keys = _u32_as_i32(prep.keys_ab)
    scratch = torch.empty((3, b, l, wp), dtype=torch.float32, device=dev)
    out = torch.empty_like(rgb)
    params = _chain_params(cfg, b, l, w, wp)
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cvsim_yiq_chain(
            rgb.data_ptr(), prep.xi.data_ptr(), keys.data_ptr(),
            prep.sincos.data_ptr(), prep.keep.data_ptr(),
            prep.shifts.data_ptr(),
            *(t.data_ptr() for t in prep.tables),
            scratch.data_ptr(), out.data_ptr(),
            ctypes.addressof(params), stream)
    if rc != 0:
        raise RuntimeError(f"yiq_chain launch failed: {kernels.error_string(rc)}")
    KERNEL_LAUNCHES += 1
    return out

