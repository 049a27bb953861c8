"""C-semantics scalar helpers on tensors (twin of cvsim_tpu.ops.cmath).

The reference engines rely on C integer conversion rules at quantization
points; these reproduce them so the port can be held to the JAX package
exactly.
"""

from __future__ import annotations

import torch


def c_int(x: torch.Tensor) -> torch.Tensor:
    """C double->int conversion: truncation toward zero (dtype kept)."""
    return torch.trunc(x)


def c_div(a: torch.Tensor, b) -> torch.Tensor:
    """C integer division: truncation toward zero (torch's // floors)."""
    return torch.div(a, b, rounding_mode="trunc")


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device, as XLA's
    and the CPU's are: torch.sqrt of float32 on the card is one ULP off
    for some inputs (about 0.7% of a scanimate stamp's distances on an
    H100). The float64 root is correctly rounded, and rounding it once
    more to float32 gives the correctly rounded float32 root, because 53
    bits are at least 2 * 24 + 2."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def clips16(x: torch.Tensor) -> torch.Tensor:
    """clips16 (ffmpeg_to_composite.cpp:344-351): truncate a float toward
    zero, then clamp to the int16 range."""
    if x.is_floating_point():
        x = torch.trunc(x)
    return torch.clamp(x, -32768, 32767)


def clampu8(x: torch.Tensor) -> torch.Tensor:
    """clampu8 (ffmpeg_to_composite.cpp:335-342): truncate a float stage
    output toward zero, then clamp to [0, 255]."""
    if x.is_floating_point():
        x = torch.trunc(x)
    return torch.clamp(x, 0, 255)
