"""Kernel #9: a cascade of one-pole lowpasses over the rows of a float32
tensor (twin of cvsim_tpu.ops.pallas.fused_iir).

- `fused_iir_reference`: the plain PyTorch version. Each pole is one
  blocked pass (ops/blocked_iir.iir_lowpass_blocked: x @ T^T + d * carry
  per 128-sample block, as in the TPU kernel), then the mode's combine.
- `fused_iir`: the wrapper of csrc/fused_iir.cu. On a CPU tensor it runs
  fused_iir_reference; on a CUDA tensor it launches the kernel or raises.
- `CASCADES`: the three cascade shapes of ops/iir.py on this kernel, the
  twin of the JAX package's cascade_* under CVSIM_PALLAS=1
  (cvsim_tpu/ops/iir.py:100-132). The gen-1 debug-tap route hands them to
  the stage path (models/yuv422.composite_video_process_auto).

Poles run one at a time here, where the stage path groups three into one
T^3 product (ops/iir.PLAIN), so the two agree to float32 rounding only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.ops.blocked_iir import (BLOCK, _decay_consts, full_float32,
                                             iir_lowpass_blocked)
from cvsim_tpu_torch.ops.iir import Cascades

MAX_POLES = 8   # iir::MAX_POLES in csrc/fused_iir.cu
MODES = {"none": 0, "emph": 1, "unsharp": 2}


def _check_args(alphas, y0s, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {sorted(MODES)}")
    if not 1 <= len(alphas) <= MAX_POLES or len(y0s) != len(alphas):
        raise ValueError(f"{len(alphas)} alphas and {len(y0s)} y0s: expected "
                         f"the same count, 1 to {MAX_POLES}")


def fused_iir_reference(x: torch.Tensor, *, alphas: tuple, y0s: tuple,
                        mode: str = "none", gain: float = 0.0) -> torch.Tensor:
    """Plain version of the kernel on x [..., W]: the poles in series
    (alphas[i] with reset y0s[i]), then
      'none'    -> the cascade,
      'emph'    -> s + (s - pole_last(s)) * gain, s the cascade of all
                   poles but the last,
      'unsharp' -> x + (x - cascade(x)) * gain."""
    _check_args(alphas, y0s, mode)
    full_float32(x)
    n_lp = len(alphas) - (1 if mode == "emph" else 0)
    s = x
    for a, y0 in zip(alphas[:n_lp], y0s[:n_lp]):
        s = iir_lowpass_blocked(s, a, y0)
    g = torch.tensor(gain, dtype=x.dtype, device=x.device)
    if mode == "emph":
        return s + (s - iir_lowpass_blocked(s, alphas[-1], y0s[-1])) * g
    if mode == "unsharp":
        return x + (x - s) * g
    return s


@functools.lru_cache(maxsize=64)
def _tables(alphas: tuple, device: torch.device):
    """(tt [k,128,128] T^T per pole, d [k,128]) float32 on device, from the
    same constants as the plain version; built and copied once per
    (alphas, device)."""
    consts = [_decay_consts(float(a), BLOCK, "float32") for a in alphas]
    tt = np.stack([c[0].T.copy() for c in consts])
    d = np.stack([c[1] for c in consts])
    return torch.from_numpy(tt).to(device), torch.from_numpy(d).to(device)


class _IirParams(ctypes.Structure):
    """Mirror of `iir::Params` in csrc/fused_iir.cu (field order matters)."""
    _fields_ = [("rows", ctypes.c_int), ("w", ctypes.c_int),
                ("wp", ctypes.c_int), ("k", ctypes.c_int),
                ("mode", ctypes.c_int), ("gain", ctypes.c_float),
                ("y0", ctypes.c_float * MAX_POLES)]


def fused_iir(x: torch.Tensor, *, alphas: tuple, y0s: tuple,
              mode: str = "none", gain: float = 0.0) -> torch.Tensor:
    """The pole cascade over the last axis of x [..., W] (float32), the
    API of the JAX package's fused_iir. A CPU tensor runs
    fused_iir_reference. A CUDA tensor launches the kernel of
    csrc/fused_iir.cu (built at first use), several rows a CTA at the
    narrower widths (the kernel chooses how many), or raises; there is no
    fallback."""
    if kernels.device_of(x, "fused_iir") is None:
        return fused_iir_reference(x, alphas=alphas, y0s=y0s, mode=mode,
                                   gain=gain)
    _check_args(alphas, y0s, mode)
    if x.dtype != torch.float32:
        raise ValueError(f"x: dtype {x.dtype}, expected torch.float32")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected [..., W>0]")
    w = x.shape[-1]
    xf = x.reshape(-1, w).contiguous()
    tt, d = _tables(tuple(float(a) for a in alphas), x.device)
    out = torch.empty_like(xf)
    y0 = [float(v) for v in y0s] + [0.0] * (MAX_POLES - len(y0s))
    params = _IirParams(rows=xf.shape[0], w=w, wp=-(-w // BLOCK) * BLOCK,
                        k=len(alphas), mode=MODES[mode], gain=float(gain),
                        y0=(ctypes.c_float * MAX_POLES)(*y0))
    kernels.launch("fused_iir", xf, tt, d, out, params, device=x.device)
    return out.reshape(x.shape)


# ------------------------------------------- the stage path's cascade shapes

def cascade_emph(x, alpha, y0, passes: int, gain: float):
    """ops/iir.cascade_emph on the kernel: passes poles, then the emphasis
    against one more same-cut pole."""
    n = passes + 1
    return fused_iir(x, alphas=(float(alpha),) * n, y0s=(float(y0),) * n,
                     mode="emph", gain=float(gain))


def cascade_unsharp(x, alpha, y0, passes: int, gain: float):
    """ops/iir.cascade_unsharp on the kernel."""
    return fused_iir(x, alphas=(float(alpha),) * passes,
                     y0s=(float(y0),) * passes, mode="unsharp",
                     gain=float(gain))


def cascade_plain(x, alpha, y0, passes: int):
    """ops/iir.cascade_plain on the kernel."""
    return fused_iir(x, alphas=(float(alpha),) * passes,
                     y0s=(float(y0),) * passes)


CASCADES = Cascades(cascade_emph, cascade_unsharp, cascade_plain)
