"""One-pole IIR primitives (twin of cvsim_tpu.ops.iir).

The reference's `LowpassFilter` (ffmpeg_to_composite.cpp:99-131):

    y[t] = alpha * x[t] + (1 - alpha) * y[t-1],   y[-1] = y0
    highpass(x)[t] = x[t] - lowpass(x)[t]

Every filter runs on the blocked-matmul form of ops/blocked_iir.py. The
three cascade shapes below are the plain versions; the JAX package's
CVSIM_PALLAS branch (its standalone fused-IIR TPU kernel) has its
counterpart in ops/fused_iir.py, and the stage functions of
models/yuv422.py take either set as a `Cascades` argument.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cvsim_tpu_torch.ops.blocked_iir import (
    iir_lowpass3_blocked,
    iir_lowpass_blocked,
)


def iir_lowpass(x: torch.Tensor, alpha, y0) -> torch.Tensor:
    """One-pole lowpass along the last axis (y0: the filter's reset
    value). Every filter of the chain runs along the sample axis."""
    return iir_lowpass_blocked(x, alpha, y0)


def iir_lowpass_cascade(x: torch.Tensor, alpha, y0,
                        passes: int) -> torch.Tensor:
    """N identical one-pole lowpasses in series along the last axis (each
    with its own register, all reset to y0); groups of three compose into
    one T^3 blocked matmul."""
    y = x
    while passes >= 3:
        y = iir_lowpass3_blocked(y, alpha, y0)
        passes -= 3
    for _ in range(passes):
        y = iir_lowpass(y, alpha, y0)
    return y


def iir_highpass(x: torch.Tensor, alpha, y0) -> torch.Tensor:
    """highpass = x - lowpass(x) (ffmpeg_to_composite.cpp:120-124)."""
    return x - iir_lowpass(x, alpha, y0)


def cascade_emph(x, alpha, y0, passes: int, gain: float):
    """cascade(x), then s += highpass_alpha(s) * gain (VHS luma and
    preemphasis)."""
    s = iir_lowpass_cascade(x, alpha, y0, passes)
    return s + iir_highpass(s, alpha, y0) * torch.tensor(gain, dtype=x.dtype)


def cascade_unsharp(x, alpha, y0, passes: int, gain: float):
    """x + (x - cascade(x)) * gain (VHS sharpen)."""
    ts = iir_lowpass_cascade(x, alpha, y0, passes)
    return x + (x - ts) * torch.tensor(gain, dtype=x.dtype)


def cascade_plain(x, alpha, y0, passes: int):
    """Plain pole cascade."""
    return iir_lowpass_cascade(x, alpha, y0, passes)


class Cascades(NamedTuple):
    """The pole-cascade shapes a stage path runs, each called as
    (x, alpha, y0, passes[, gain])."""
    emph: Callable
    unsharp: Callable
    plain: Callable


# the blocked T^3 cascades above: what chain_reference and every plain
# version run
PLAIN = Cascades(cascade_emph, cascade_unsharp, cascade_plain)


def delay_writeback(orig: torch.Tensor, filtered: torch.Tensor,
                    delay: int) -> torch.Tensor:
    """The reference's in-place delayed writeback along the last axis:

        for x: ... if (x >= delay) P[x-delay] = f(P[x])

    out[i] = filtered[i+delay] for i < W-delay; the final `delay` samples
    keep their original values (they are never written)."""
    if delay == 0:
        return filtered
    return torch.cat([filtered[..., delay:], orig[..., -delay:]], dim=-1)
