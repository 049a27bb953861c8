"""The per-line inputs of both chains' CUDA kernels (gen-2,
models/fused_yiq.py; gen-1, models/fused_yuv.py).

- `Prepared`: every per-field and per-line input of one chain call (phase
  xi, the two in-kernel noise stream ids, chroma-phase sin/cos, dropout
  keep mask, the full per-row head-switch shift table) plus the engine's
  stacked IIR constant tables; `check_prepared` holds it to a call's
  [B, L] and device, `streams` gives its yiq.FieldStreams.
- `prepare`: the body of both engines' `prepare`, for a whole field or a
  row shard of one (the twin of the JAX package's
  `_fused_prepare(sharded=True)`), under the spans `<gen>.prepare`,
  `.copy`, `.streams`, `.tables`, `.copy`.
- `field_streams_fused`: its per-line streams, one launch of
  csrc/streams.cu's `cvsim_field_streams` on a CUDA tensor (no TPU twin:
  the JAX package builds them with XLA ops); yiq.field_streams is its
  plain version and runs on a CPU tensor.
- `stack_alpha_consts`: the IIR tables of a list of pole alphas.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.config import CompositeConfig
from cvsim_tpu_torch.models import yiq
from cvsim_tpu_torch.ops.blocked_iir import (BLOCK, _cascade3_consts,
                                             _decay_consts)
from cvsim_tpu_torch.utils import log


class Prepared(NamedTuple):
    """Inputs of one chain call, all on the device of the fields. A row
    shard's per-line streams are its rows of the whole field's."""
    xi: torch.Tensor        # int32 [B, L]
    keys_ab: torch.Tensor   # int64 [B, 2] u32 stream ids (luma, chroma noise)
    sincos: torch.Tensor    # f32 [B, L, 2]
    keep: torch.Tensor      # f32 [B, L]
    shifts: torch.Tensor    # int32 [B, L]
    tables: tuple           # f32 tt [N,128,128], d [N,128], tt3 [N,128,128],
                            #     d3 [N,8,128], vt [N,128,8]; N = 8 rows
                            #     for gen-2, 11 for gen-1
    row0: int               # global index of row 0 (non-zero on a shard)
    l_glob: int             # the whole field's height (L unless a shard)


def streams(prep: Prepared) -> yiq.FieldStreams:
    return yiq.FieldStreams(prep.xi, prep.keys_ab, prep.sincos, prep.keep,
                            prep.shifts)


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_prepared(prep: Prepared, b: int, l: int, device: torch.device,
                   n_tables: int):
    """prep against a call of b fields of l rows on device, with n_tables
    rows in each IIR table."""
    check("xi", prep.xi, torch.int32, (b, l), device)
    check("keys_ab", prep.keys_ab, torch.int64, (b, 2), device)
    check("sincos", prep.sincos, torch.float32, (b, l, 2), device)
    check("keep", prep.keep, torch.float32, (b, l), device)
    check("shifts", prep.shifts, torch.int32, (b, l), device)
    table_shapes = ((BLOCK, BLOCK), (BLOCK,), (BLOCK, BLOCK), (8, BLOCK),
                    (BLOCK, 8))
    for k, (t, shape) in enumerate(zip(prep.tables, table_shapes)):
        check(f"tables[{k}]", t, torch.float32, (n_tables, *shape), device)


def u32_as_i32(keys: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same bits as int32."""
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32)


# ------------------------------------------------------------ IIR tables

def stack_alpha_consts(alphas):
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


# ------------------------------------------------------------ streams

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
    check(what, t, t.dtype, (b,), dev)
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
    dev = kernels.device_of(fieldno, "field_streams")
    if dev is None:
        return yiq.field_streams(cfg, fieldno, field_parity, l, w, key,
                                 gen1=gen1)
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
    kernels.launch("field_streams", fieldno, field_parity, table, *out,
                   params, device=dev)
    return out


# ------------------------------------------------------------ prepare

def prepare(gen: str, tables: Callable, cfg: CompositeConfig,
            x: torch.Tensor, fieldno: torch.Tensor,
            field_parity: torch.Tensor, key: int, *, gen1: bool = False,
            row0: int = 0, l_glob: int | None = None) -> Prepared:
    """Everything a chain call needs besides its planes, on x's device
    (x: the fields, [B, L, W, ...]), under the spans `<gen>.prepare`,
    `.copy`, `.streams`, `.tables`, `.copy`; `tables(cfg)` builds the
    engine's numpy IIR tables. key: the u32 stream seed
    (interop.key32_from_seed). For a row shard, x holds rows row0 ..
    row0+L-1 of fields l_glob rows high: the per-line streams (xi, the
    sequential chroma-phase walk, the dropout mask, the head-switch
    shifts) are computed at the global height and sliced, since they are
    addressed by absolute line."""
    l, w = x.shape[1], x.shape[2]
    l_glob = l if l_glob is None else l_glob
    if row0 < 0 or row0 + l > l_glob:
        raise ValueError(f"rows {row0}..{row0 + l - 1} outside a field of "
                         f"{l_glob} lines")
    dev = x.device
    with log.span(f"{gen}.prepare"):
        with log.span(f"{gen}.prepare.copy"):
            fieldno = log.to_device(fieldno, dev)
            field_parity = log.to_device(field_parity, dev)
        with log.span(f"{gen}.prepare.streams"):
            s = field_streams_fused(cfg, fieldno, field_parity, l_glob, w,
                                    key, gen1=gen1)
        with log.span(f"{gen}.prepare.tables"):
            consts = tables(cfg)
        with log.span(f"{gen}.prepare.copy"):
            tabs = tuple(log.to_device(torch.from_numpy(t), dev)
                         for t in consts)
    if l != l_glob:
        rows = slice(row0, row0 + l)
        s = s._replace(**{k: getattr(s, k)[:, rows].contiguous()
                          for k in ("xi", "sincos", "keep", "shifts")})
    return Prepared(*s, tabs, row0, l_glob)
