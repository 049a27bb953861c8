"""The gen-2 chain as hand-written CUDA kernels (twin of
cvsim_tpu.models.fused_yiq).

- `prepare`: every per-field and per-line input of the chain (phase xi,
  the two in-kernel noise stream ids, chroma-phase sin/cos, dropout keep
  mask, the full per-row head-switch shift table) plus the stacked IIR
  constant tables, for a whole field or for a row shard of one (the twin
  of `_fused_prepare(sharded=True)`). The TPU path's tiling, padding and
  8-aligned head-switch window exist for Mosaic's layout rules and have no
  counterpart here.
- `field_streams_fused`: `prepare`'s per-line streams, one launch of
  csrc/streams.cu's `cvsim_field_streams` on a CUDA tensor (no TPU twin:
  the JAX package builds them with XLA ops); yiq.field_streams is its
  plain version and runs on a CPU tensor.
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
launches its kernel or raises. yiq.composite_layer_rgb_auto is the entry
point of the main path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from cvsim_tpu_torch.config import CompositeConfig, NTSC_RATE, iir_alpha
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.ops.blocked_iir import (BLOCK, _cascade3_consts, _decay_consts,
                                             full_float32)
from cvsim_tpu_torch.utils import log



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
    with the gen-1 chain of models/fused_yuv.py). A row shard's per-line
    streams are its rows of the whole field's."""
    xi: torch.Tensor        # int32 [B, L]
    keys_ab: torch.Tensor   # int64 [B, 2] u32 stream ids (luma, chroma noise)
    sincos: torch.Tensor    # f32 [B, L, 2]
    keep: torch.Tensor      # f32 [B, L]
    shifts: torch.Tensor    # int32 [B, L]
    tables: tuple           # f32 tt [N,128,128], d [N,128], tt3 [N,128,128],
                            #     d3 [N,8,128], vt [N,128,8]; N = 8 rows
                            #     for gen-2, 11 for gen-1
    row0: int = 0           # global index of row 0 (non-zero on a shard)
    l_glob: int | None = None   # the whole field's height (None: L)


# csrc/streams.cu WALK_BLOCKS blocks: the walks that
# ops/blocked_iir.iir_lowpass_blocked carries block by block
_WALK_LINES = 16 * BLOCK


class _StreamsParams(ctypes.Structure):
    """Mirror of `StreamsParams` in csrc/streams.cu (field order matters)."""
    _fields_ = [
        *((n, ctypes.c_int) for n in ("b", "l")),
        ("key", ctypes.c_uint32),
        *((n, ctypes.c_int) for n in (
            "fieldno_bytes", "parity_bytes", "gen1", "ntsc", "phase_shift",
            "phase_offset", "phase_mag", "chroma_loss", "head_switching",
            "twidth", "vis_off")),
        *((n, ctypes.c_float) for n in (
            "hs_point", "hs_phase", "hs_phase_noise", "hs_t"))]


@functools.lru_cache(maxsize=16)
def _phase_table(m: int, dev: torch.device) -> torch.Tensor:
    """f32 [2m + 2, 2] (sin, cos) of k * pi/100 for k = -m .. m, then of
    -0.0: every value yiq.chroma_phase_angles takes at a phase noise of
    +-m, from its own yiq.phase_sincos on the same device."""
    k = torch.cat([torch.arange(-m, m + 1, dtype=torch.float32, device=dev),
                   torch.zeros(1, dtype=torch.float32, device=dev).neg()])
    return yiq.phase_sincos(k).contiguous()


def _field_ids(t: torch.Tensor, what: str, b: int,
               dev: torch.device) -> torch.Tensor:
    """t as a contiguous [B] int32 or int64 tensor on dev (the kernel reads
    the low 32 bits of each element)."""
    if t.dtype not in (torch.int32, torch.int64):
        t = t.to(torch.int32)
    t = t.contiguous()
    _check(what, t, t.dtype, (b,), dev)
    return t


def _streams_params(cfg: CompositeConfig, b: int, l: int, w: int, key: int,
                    gen1: bool, fieldno_bytes: int,
                    parity_bytes: int) -> _StreamsParams:
    """The kernel's parameters: yiq.field_streams' branches and the
    float32 values of _head_switch_geometry."""
    twidth = w + w // 10
    return _StreamsParams(
        b=b, l=l, key=key & 0xFFFFFFFF, fieldno_bytes=fieldno_bytes,
        parity_bytes=parity_bytes, gen1=int(gen1), ntsc=int(cfg.ntsc),
        phase_shift=cfg.video_scanline_phase_shift,
        phase_offset=cfg.video_scanline_phase_shift_offset,
        phase_mag=cfg.video_chroma_phase_noise,
        chroma_loss=cfg.video_chroma_loss,
        head_switching=int(cfg.vhs_head_switching),
        twidth=twidth,
        vis_off=(262 - 240) * 2 if cfg.ntsc else (312 - 288) * 2,
        hs_point=cfg.vhs_head_switching_point,
        # gen-1 takes both raster axes from the switch point
        hs_phase=(cfg.vhs_head_switching_point if gen1
                  else cfg.vhs_head_switching_phase),
        hs_phase_noise=cfg.vhs_head_switching_phase_noise,
        hs_t=twidth * (262.5 if cfg.ntsc else 312.5))


def field_streams_fused(cfg: CompositeConfig, fieldno: torch.Tensor,
                        field_parity: torch.Tensor, l: int, w: int, key: int,
                        gen1: bool = False) -> yiq.FieldStreams:
    """yiq.field_streams' outputs, bit for bit. A CPU tensor runs
    yiq.field_streams; a CUDA tensor launches csrc/streams.cu's
    `cvsim_field_streams` (one CTA a field, no copy, no sync) or raises,
    as it does for a chroma-phase walk longer than 2048 lines (the plain
    version's walk takes another form there; fields have at most 540)."""
    dev = _cuda_device(fieldno, "field_streams")
    if dev is None:
        return yiq.field_streams(cfg, fieldno, field_parity, l, w, key,
                                 gen1=gen1)
    from cvsim_tpu_torch import kernels

    mag = cfg.video_chroma_phase_noise
    if mag != 0 and l > _WALK_LINES:
        raise ValueError(f"field_streams: a chroma-phase walk of {l} lines; "
                         f"the kernel takes up to {_WALK_LINES}")
    b = fieldno.shape[0]
    fieldno = _field_ids(fieldno, "fieldno", b, dev)
    field_parity = _field_ids(field_parity, "field_parity", b, dev)
    params = _streams_params(cfg, b, l, w, key, gen1, fieldno.element_size(),
                             field_parity.element_size())
    table = _phase_table(abs(mag), dev) if mag != 0 else None
    out = yiq.FieldStreams(
        xi=torch.empty((b, l), dtype=torch.int32, device=dev),
        keys_ab=torch.empty((b, 2), dtype=torch.int64, device=dev),
        sincos=torch.empty((b, l, 2), dtype=torch.float32, device=dev),
        keep=torch.empty((b, l), dtype=torch.float32, device=dev),
        shifts=torch.empty((b, l), dtype=torch.int32, device=dev))
    _launch("field_streams", kernels.load().cvsim_field_streams, dev,
            fieldno.data_ptr(), field_parity.data_ptr(),
            None if table is None else table.data_ptr(),
            *(t.data_ptr() for t in out), ctypes.addressof(params))
    log.count("launches.field_streams")
    return out


def prepare(cfg: CompositeConfig, rgb: torch.Tensor, fieldno: torch.Tensor,
            field_parity: torch.Tensor, key: int, row0: int = 0,
            l_glob: int | None = None) -> Prepared:
    """Everything the chain needs besides the RGB planes, on rgb's device.
    key: the u32 stream seed (interop.key32_from_seed). For a row shard,
    rgb holds rows row0 .. row0+L-1 of fields l_glob rows high: the
    per-line streams (xi, the sequential chroma-phase walk, the dropout
    mask, the head-switch shifts) are computed at the global height and
    sliced, since they are addressed by absolute line."""
    _, l, w, _ = rgb.shape
    l_glob = l if l_glob is None else l_glob
    if row0 < 0 or row0 + l > l_glob:
        raise ValueError(f"rows {row0}..{row0 + l - 1} outside a field of "
                         f"{l_glob} lines")
    dev = rgb.device
    with log.span("gen2.prepare"):
        with log.span("gen2.prepare.copy"):
            fieldno = log.to_device(fieldno, dev)
            field_parity = log.to_device(field_parity, dev)
        with log.span("gen2.prepare.streams"):
            s = field_streams_fused(cfg, fieldno, field_parity, l_glob, w,
                                    key)
        with log.span("gen2.prepare.tables"):
            consts = _alpha_consts(cfg)
        with log.span("gen2.prepare.copy"):
            tables = tuple(log.to_device(torch.from_numpy(t), dev)
                           for t in consts)
    rows = slice(row0, row0 + l)
    return Prepared(s.xi[:, rows].contiguous(), s.keys_ab,
                    s.sincos[:, rows].contiguous(),
                    s.keep[:, rows].contiguous(),
                    s.shifts[:, rows].contiguous(), tables, row0, l_glob)


def _streams(prep: Prepared) -> yiq.FieldStreams:
    return yiq.FieldStreams(prep.xi, prep.keys_ab, prep.sincos, prep.keep,
                            prep.shifts)


# ------------------------------------------------------------ plain version

def chain_reference(rgb: torch.Tensor, prep: Prepared, *,
                    cfg: CompositeConfig) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [B, L, W, 3] in and out,
    the stage path of models/yiq.py on `prep`'s per-line inputs. The
    stage functions derive the same IIR tables from cfg that `prep`
    carries (both come from _decay_consts/_cascade3_consts on the same
    alphas)."""
    full_float32(rgb)
    return yiq.composite_layer_rgb_streams(rgb, _streams(prep), cfg=cfg)


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
    y = yiq.composite_front_a(y, i, q, cfg=cfg, streams=_streams(prep),
                              row0=prep.row0)
    return _planes_out(y, _wp(w))


def stage_b1_reference(y: torch.Tensor, prep: Prepared, *,
                       cfg: CompositeConfig, w: int):
    """Plain version of kernel #3: the head-switched luma f32 [B, L, Wp]
    -> y, i, q f32 [B, L, Wp] (zero past w)."""
    full_float32(y)
    out = yiq.composite_front_b1(_planes_in(y, w), cfg=cfg,
                                 streams=_streams(prep), row0=prep.row0,
                                 l_glob=_l_glob(prep))
    return tuple(_planes_out(p, y.shape[-1]) for p in out)


def stage_b2_reference(y: torch.Tensor, i: torch.Tensor, q: torch.Tensor,
                       prep: Prepared, *, cfg: CompositeConfig,
                       w: int) -> torch.Tensor:
    """Plain version of kernel #4: the blended y, i, q f32 [B, L, Wp] ->
    uint8 RGB [B, L, w, 3]."""
    full_float32(y)
    y, i, q = yiq.composite_back_b2(*(_planes_in(p, w) for p in (y, i, q)),
                                    cfg=cfg, streams=_streams(prep))
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


def _l_glob(prep: Prepared) -> int:
    return prep.xi.shape[1] if prep.l_glob is None else prep.l_glob


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


def _check_prep(prep: Prepared, b: int, l: int, dev: torch.device):
    _check("xi", prep.xi, torch.int32, (b, l), dev)
    _check("keys_ab", prep.keys_ab, torch.int64, (b, 2), dev)
    _check("sincos", prep.sincos, torch.float32, (b, l, 2), dev)
    _check("keep", prep.keep, torch.float32, (b, l), dev)
    _check("shifts", prep.shifts, torch.int32, (b, l), dev)
    table_shapes = ((8, BLOCK, BLOCK), (8, BLOCK), (8, BLOCK, BLOCK),
                    (8, 8, BLOCK), (8, BLOCK, 8))
    for k, (t, shape) in enumerate(zip(prep.tables, table_shapes)):
        _check(f"tables[{k}]", t, torch.float32, shape, dev)


def _launch(name: str, fn, dev: torch.device, *args):
    """Call the C entry point `fn` on dev's current stream; raise on a
    refused launch."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        from cvsim_tpu_torch import kernels

        raise RuntimeError(f"{name} launch failed: {kernels.error_string(rc)}")


def _cuda_device(t: torch.Tensor, what: str):
    """None for a CPU tensor (run the plain version), the device for a CUDA
    tensor; raises for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device


def composite_layer_rgb_fused(rgb: torch.Tensor, prep: Prepared, *,
                              cfg: CompositeConfig) -> torch.Tensor:
    """The gen-2 chain on uint8 [B, L, W, 3] fields; uint8 out.

    A CPU tensor runs chain_reference. A CUDA tensor launches the kernel
    of csrc/yiq_chain.cu (built at first use) or raises; there is no
    fallback."""
    dev = _cuda_device(rgb, "yiq_chain")
    if dev is None:
        return chain_reference(rgb, prep, cfg=cfg)
    from cvsim_tpu_torch import kernels

    if rgb.ndim != 4:
        raise ValueError(f"rgb: expected [B, L, W, 3], got {tuple(rgb.shape)}")
    b, l, w, _ = rgb.shape
    if prep.row0 != 0 or _l_glob(prep) != l:
        raise ValueError("yiq_chain runs whole fields; a row shard takes "
                         "stage_a/stage_b1/stage_b2")
    wp = _wp(w)
    _check("rgb", rgb, torch.uint8, (b, l, w, 3), dev)
    _check_prep(prep, b, l, dev)

    keys = _u32_as_i32(prep.keys_ab)
    scratch = torch.empty((3, b, l, wp), dtype=torch.float32, device=dev)
    out = torch.empty_like(rgb)
    params = _chain_params(cfg, b, l, w, wp)
    lib = kernels.load()
    _launch("yiq_chain", lib.cvsim_yiq_chain, dev,
            rgb.data_ptr(), prep.xi.data_ptr(), keys.data_ptr(),
            prep.sincos.data_ptr(), prep.keep.data_ptr(),
            prep.shifts.data_ptr(), *(t.data_ptr() for t in prep.tables),
            scratch.data_ptr(), out.data_ptr(), ctypes.addressof(params))
    log.count("launches.yiq_chain")
    return out


def _split_params(cfg, prep: Prepared, b: int, l: int, w: int,
                  dev: torch.device) -> _ChainParams:
    _check_prep(prep, b, l, dev)
    return _chain_params(cfg, b, l, w, _wp(w), prep.row0, _l_glob(prep))


def stage_a(rgb: torch.Tensor, prep: Prepared, *,
            cfg: CompositeConfig) -> torch.Tensor:
    """Kernel #2 (yiq_a) on uint8 [B, L, W, 3] rows of a field: the encoded
    luma, f32 [B, L, Wp]. CPU tensor: stage_a_reference; CUDA tensor: the
    kernel (several rows a CTA at 480i and 576i widths) or raise."""
    dev = _cuda_device(rgb, "yiq_a")
    if dev is None:
        return stage_a_reference(rgb, prep, cfg=cfg)
    from cvsim_tpu_torch import kernels

    if rgb.ndim != 4:
        raise ValueError(f"rgb: expected [B, L, W, 3], got {tuple(rgb.shape)}")
    b, l, w, _ = rgb.shape
    _check("rgb", rgb, torch.uint8, (b, l, w, 3), dev)
    params = _split_params(cfg, prep, b, l, w, dev)
    keys = _u32_as_i32(prep.keys_ab)
    y = torch.empty((b, l, _wp(w)), dtype=torch.float32, device=dev)
    _launch("yiq_a", kernels.load().cvsim_yiq_a, dev,
            rgb.data_ptr(), prep.xi.data_ptr(), keys.data_ptr(),
            *(t.data_ptr() for t in prep.tables), y.data_ptr(),
            ctypes.addressof(params))
    log.count("launches.yiq_a")
    return y


def stage_b1(y: torch.Tensor, prep: Prepared, *, cfg: CompositeConfig,
             w: int):
    """Kernel #3 (yiq_b1) on the head-switched luma f32 [B, L, Wp] of w
    active samples: y, i, q f32 [B, L, Wp]. CPU tensor:
    stage_b1_reference; CUDA tensor: the kernel (several rows a CTA at
    480i and 576i widths) or raise."""
    dev = _cuda_device(y, "yiq_b1")
    if dev is None:
        return stage_b1_reference(y, prep, cfg=cfg, w=w)
    from cvsim_tpu_torch import kernels

    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, Wp], got {tuple(y.shape)}")
    b, l, wp = y.shape
    _check("y", y, torch.float32, (b, l, _wp(w)), dev)
    params = _split_params(cfg, prep, b, l, w, dev)
    keys = _u32_as_i32(prep.keys_ab)
    out = torch.empty((3, b, l, wp), dtype=torch.float32, device=dev)
    _launch("yiq_b1", kernels.load().cvsim_yiq_b1, dev,
            y.data_ptr(), prep.xi.data_ptr(), keys.data_ptr(),
            prep.sincos.data_ptr(), *(t.data_ptr() for t in prep.tables),
            *(p.data_ptr() for p in out), ctypes.addressof(params))
    log.count("launches.yiq_b1")
    return tuple(out)


def stage_b2(y: torch.Tensor, i: torch.Tensor, q: torch.Tensor,
             prep: Prepared, *, cfg: CompositeConfig, w: int) -> torch.Tensor:
    """Kernel #4 (yiq_b2) on the blended y, i, q f32 [B, L, Wp] of w
    active samples: uint8 RGB [B, L, w, 3]. CPU tensor:
    stage_b2_reference; CUDA tensor: the kernel (several rows a CTA at
    480i and 576i widths) or raise."""
    dev = _cuda_device(y, "yiq_b2")
    if dev is None:
        return stage_b2_reference(y, i, q, prep, cfg=cfg, w=w)
    from cvsim_tpu_torch import kernels

    if y.ndim != 3:
        raise ValueError(f"y: expected [B, L, Wp], got {tuple(y.shape)}")
    b, l, _ = y.shape
    for name, p in (("y", y), ("i", i), ("q", q)):
        _check(name, p, torch.float32, (b, l, _wp(w)), dev)
    params = _split_params(cfg, prep, b, l, w, dev)
    out = torch.empty((b, l, w, 3), dtype=torch.uint8, device=dev)
    _launch("yiq_b2", kernels.load().cvsim_yiq_b2, dev,
            y.data_ptr(), i.data_ptr(), q.data_ptr(), prep.xi.data_ptr(),
            prep.keep.data_ptr(), *(t.data_ptr() for t in prep.tables),
            out.data_ptr(), ctypes.addressof(params))
    log.count("launches.yiq_b2")
    return out
