"""The gen-2 chain as hand-written CUDA kernels (twin of
cvsim_tpu.models.fused_yiq).

- `prepare`: models/chain_prep.prepare with the gen-2 IIR tables
  (`_alpha_consts`), for a whole field or for a row shard of one. The TPU
  path's tiling, padding and 8-aligned head-switch window exist for
  Mosaic's layout rules and have no counterpart here.
- Kernel #1, the whole chain: `composite_layer_rgb_fused` wraps
  csrc/yiq_chain.cu's `cvsim_yiq_chain`; `chain_reference` is its plain
  PyTorch version, built from the stage functions of models/yiq.py.
- Kernels #2-#4, the chain's three row-local stage groups for a row
  shard: `stage_a`, `stage_b1`, `stage_b2` wrap `cvsim_yiq_a/_b1/_b2`;
  `stage_*_reference` are their plain versions. Between them run the two
  seams `head_switch_rows` and `vblend_rows` (plain PyTorch, as the JAX
  package runs them in XLA between its kernels). parallel/mesh.py chains
  them into the line-sharded program.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel through kernels.launch or raises (kernels.device_of).
yiq.composite_layer_rgb_auto is the entry point of the main path.
"""

from __future__ import annotations

import ctypes

import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu_torch.models import chain_prep, yiq
from cvsim_tpu_torch.models.chain_prep import (Prepared, check,
                                               check_prepared, streams,
                                               u32_as_i32)
from cvsim_tpu_torch.ops.blocked_iir import BLOCK, full_float32

N_TABLES = 8   # rows of each IIR table (_alpha_consts)


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
    return chain_prep.stack_alpha_consts(alphas)


# ------------------------------------------------------------ inputs

def prepare(cfg: CompositeConfig, rgb: torch.Tensor, fieldno: torch.Tensor,
            field_parity: torch.Tensor, key: int, row0: int = 0,
            l_glob: int | None = None) -> Prepared:
    """chain_prep.prepare of uint8 RGB fields [B, L, W, 3] (or of rows
    row0 .. row0+L-1 of fields l_glob rows high), under `gen2.prepare`."""
    return chain_prep.prepare("gen2", _alpha_consts, cfg, rgb, fieldno,
                              field_parity, key, row0=row0, l_glob=l_glob)


# ------------------------------------------------------------ plain version

def chain_reference(rgb: torch.Tensor, prep: Prepared, *,
                    cfg: CompositeConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [B, L, W, 3] in and out,
    the stage path of models/yiq.py on `prep`'s per-line inputs. The
    stage functions derive the same IIR tables from cfg that `prep`
    carries (both come from _decay_consts/_cascade3_consts on the same
    alphas)."""
    full_float32(rgb)
    return yiq.composite_layer_rgb_streams(rgb, streams(prep), cfg=cfg)


def _planes_in(p: torch.Tensor, w: int) -> torch.Tensor:
    """f32 [B, L, Wp] plane -> int32 [B, L, w] (the values are integers)."""
    return p[..., :w].to(torch.int32)


def _planes_out(p: torch.Tensor, wp: int) -> torch.Tensor:
    """int32 [B, L, w] -> f32 [B, L, Wp], zero past w."""
    return torch.nn.functional.pad(p.to(torch.float32),
                                   (0, wp - p.shape[-1]))


def stage_a_reference(rgb: torch.Tensor, prep: Prepared, *,
                      cfg: CompositeConfig) -> torch.Tensor:
    """Plain version of kernel #2: uint8 [B, L, W, 3] -> the encoded luma,
    f32 [B, L, Wp] (zero past W), before the head switch."""
    full_float32(rgb)
    _, _, w, _ = rgb.shape
    c = rgb.to(torch.int32)
    y, i, q = yiq.rgb_to_yiq(c[..., 0], c[..., 1], c[..., 2])
    y = yiq.composite_front_a(y, i, q, cfg=cfg, streams=streams(prep),
                              row0=prep.row0)
    return _planes_out(y, _wp(w))


def stage_b1_reference(y: torch.Tensor, prep: Prepared, *,
                       cfg: CompositeConfig, w: int):
    """Plain version of kernel #3: the head-switched luma f32 [B, L, Wp]
    -> y, i, q f32 [B, L, Wp] (zero past w)."""
    full_float32(y)
    out = yiq.composite_front_b1(_planes_in(y, w), cfg=cfg,
                                 streams=streams(prep), row0=prep.row0,
                                 l_glob=prep.l_glob)
    return tuple(_planes_out(p, y.shape[-1]) for p in out)


def stage_b2_reference(y: torch.Tensor, i: torch.Tensor, q: torch.Tensor,
                       prep: Prepared, *, cfg: CompositeConfig,
                       w: int) -> torch.Tensor:
    """Plain version of kernel #4: the blended y, i, q f32 [B, L, Wp] ->
    uint8 RGB [B, L, w, 3]."""
    full_float32(y)
    y, i, q = yiq.composite_back_b2(*(_planes_in(p, w) for p in (y, i, q)),
                                    cfg=cfg, streams=streams(prep))
    return torch.stack(yiq.yiq_to_rgb(y, i, q), dim=-1).to(torch.uint8)


# ------------------------------------------------------------ the seams

def head_switch_rows(y: torch.Tensor, shifts: torch.Tensor,
                     w: int) -> torch.Tensor:
    """The VHS head switch on a f32 [B, L, Wp] plane: each row's first w
    samples rotate by the row's shift (yiq.head_switching_stage); the
    padding passes through. Rows never mix, so a row shard applies its own
    rows of the global shift table."""
    act = yiq.head_switching_stage(y[..., :w], shifts, fill=0)
    return torch.cat([act, y[..., w:]], dim=-1)


def vblend_rows(p: torch.Tensor, row0: int = 0,
                halo: torch.Tensor | None = None) -> torch.Tensor:
    """The 2-line chroma blend on rows row0 .. of a f32 [B, L, Wp] plane
    (twin of fused_yiq._vblend_xla): global row 0 is kept, row 1 blends
    with 0 (a reference quirk), row r with the unblended row r-1. A shard
    with row0 > 0 passes that row of the shard above as `halo` [B, 1, Wp]."""
    if row0 > 0 and halo is None:
        raise ValueError(f"vblend_rows: row0 {row0} needs the halo row")
    first = halo if row0 > 0 else torch.zeros_like(p[:, :1])
    prev = torch.cat([first, p[:, :-1]], dim=1)
    rows = torch.arange(row0, row0 + p.shape[1], device=p.device)[None, :, None]
    prev = torch.where(rows == 1, 0.0, prev)
    blended = torch.floor((prev + p + 1.0) / 2.0)
    return torch.where(rows == 0, p, blended)


# ------------------------------------------------------------ the kernel

class _ChainParams(ctypes.Structure):
    """Mirror of `ChainParams` in csrc/yiq_chain.cu (field order matters)."""
    _fields_ = [(name, ctypes.c_float if name.endswith("_gain")
                 else ctypes.c_int) for name in (
        "b", "l", "w", "wp", "amp", "amp_back", "in_lowpass", "preemph",
        "pre_gain", "video_noise", "nocolor", "chroma_noise",
        "phase_noise", "gen1_bug", "vhs", "chroma_delay", "vblend",
        "sharpen_gain", "svideo", "chroma_loss", "yc_recombine",
        "out_lowpass", "row0", "l_glob")]


def _wp(w: int) -> int:
    """Row width padded to whole 128-sample blocks."""
    return -(-w // BLOCK) * BLOCK


def _chain_params(cfg: CompositeConfig, b: int, l: int, w: int, wp: int,
                  row0: int = 0, l_glob: int | None = None) -> _ChainParams:
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
        out_lowpass=out_lowpass,
        row0=row0, l_glob=l if l_glob is None else l_glob)


def composite_layer_rgb_fused(rgb: torch.Tensor, prep: Prepared, *,
                              cfg: CompositeConfig) -> torch.Tensor:
    """The gen-2 chain on uint8 [B, L, W, 3] fields; uint8 out.

    A CPU tensor runs chain_reference. A CUDA tensor launches the kernel
    of csrc/yiq_chain.cu (built at first use) or raises; there is no
    fallback."""
    dev = kernels.device_of(rgb, "yiq_chain")
    if dev is None:
        return chain_reference(rgb, prep, cfg=cfg)
    if rgb.ndim != 4:
        raise ValueError(f"rgb: expected [B, L, W, 3], got {tuple(rgb.shape)}")
    b, l, w, _ = rgb.shape
    if prep.row0 != 0 or prep.l_glob != l:
        raise ValueError("yiq_chain runs whole fields; a row shard takes "
                         "stage_a/stage_b1/stage_b2")
    wp = _wp(w)
    check("rgb", rgb, torch.uint8, (b, l, w, 3), dev)
    check_prepared(prep, b, l, dev, N_TABLES)

    keys = u32_as_i32(prep.keys_ab)
    scratch = torch.empty((3, b, l, wp), dtype=torch.float32, device=dev)
    out = torch.empty_like(rgb)
    kernels.launch("yiq_chain", rgb, prep.xi, keys, prep.sincos, prep.keep,
                   prep.shifts, *prep.tables, scratch, out,
                   _chain_params(cfg, b, l, w, wp), device=dev)
    return out


def _split_params(cfg, prep: Prepared, b: int, l: int, w: int,
                  dev: torch.device) -> _ChainParams:
    check_prepared(prep, b, l, dev, N_TABLES)
    return _chain_params(cfg, b, l, w, _wp(w), prep.row0, prep.l_glob)


def stage_a(rgb: torch.Tensor, prep: Prepared, *,
            cfg: CompositeConfig) -> torch.Tensor:
    """Kernel #2 (yiq_a) on uint8 [B, L, W, 3] rows of a field: the encoded
    luma, f32 [B, L, Wp]. CPU tensor: stage_a_reference; CUDA tensor: the
    kernel (several rows a CTA at 480i and 576i widths) or raise."""
    dev = kernels.device_of(rgb, "yiq_a")
    if dev is None:
        return stage_a_reference(rgb, prep, cfg=cfg)
    if rgb.ndim != 4:
        raise ValueError(f"rgb: expected [B, L, W, 3], got {tuple(rgb.shape)}")
    b, l, w, _ = rgb.shape
    check("rgb", rgb, torch.uint8, (b, l, w, 3), dev)
    params = _split_params(cfg, prep, b, l, w, dev)
    keys = u32_as_i32(prep.keys_ab)
    y = torch.empty((b, l, _wp(w)), dtype=torch.float32, device=dev)
    kernels.launch("yiq_a", rgb, prep.xi, keys, *prep.tables, y, params,
                   device=dev)
    return y


def stage_b1(y: torch.Tensor, prep: Prepared, *, cfg: CompositeConfig,
             w: int):
    """Kernel #3 (yiq_b1) on the head-switched luma f32 [B, L, Wp] of w
    active samples: y, i, q f32 [B, L, Wp]. CPU tensor:
    stage_b1_reference; CUDA tensor: the kernel (several rows a CTA at
    480i and 576i widths) or raise."""
    dev = kernels.device_of(y, "yiq_b1")
    if dev is None:
        return stage_b1_reference(y, prep, cfg=cfg, w=w)
    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, Wp], got {tuple(y.shape)}")
    b, l, wp = y.shape
    check("y", y, torch.float32, (b, l, _wp(w)), dev)
    params = _split_params(cfg, prep, b, l, w, dev)
    keys = u32_as_i32(prep.keys_ab)
    out = torch.empty((3, b, l, wp), dtype=torch.float32, device=dev)
    kernels.launch("yiq_b1", y, prep.xi, keys, prep.sincos, *prep.tables,
                   *out, params, device=dev)
    return tuple(out)


def stage_b2(y: torch.Tensor, i: torch.Tensor, q: torch.Tensor,
             prep: Prepared, *, cfg: CompositeConfig, w: int) -> torch.Tensor:
    """Kernel #4 (yiq_b2) on the blended y, i, q f32 [B, L, Wp] of w
    active samples: uint8 RGB [B, L, w, 3]. CPU tensor:
    stage_b2_reference; CUDA tensor: the kernel (several rows a CTA at
    480i and 576i widths) or raise."""
    dev = kernels.device_of(y, "yiq_b2")
    if dev is None:
        return stage_b2_reference(y, i, q, prep, cfg=cfg, w=w)
    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, Wp], got {tuple(y.shape)}")
    b, l, _ = y.shape
    for name, p in (("y", y), ("i", i), ("q", q)):
        check(name, p, torch.float32, (b, l, _wp(w)), dev)
    params = _split_params(cfg, prep, b, l, w, dev)
    out = torch.empty((b, l, w, 3), dtype=torch.uint8, device=dev)
    kernels.launch("yiq_b2", y, i, q, prep.xi, prep.keep, *prep.tables, out,
                   params, device=dev)
    return out
