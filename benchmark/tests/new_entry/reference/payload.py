"""Plain reference of the gen-2 render's Y4M frame payloads, in PyTorch
on the CPU: each field bobbed (every line twice, cut to the height),
BT.601 RGB->YUV in a stated float type (reference/host.py's formula),
chroma at even columns of even rows (4:2:0) or of every row (4:2:2), and
the Y, U and V planes one after another."""

from __future__ import annotations

import torch


def rgb_to_yuv601(rgb: torch.Tensor, dtype=torch.float32):
    """uint8 Y, U, V of RGB [..., 3], computed in `dtype`."""
    def c(x):
        return torch.tensor(x, dtype=torch.float32).to(dtype)

    r, g, b = (rgb[..., k].to(dtype) for k in range(3))
    yl = c(0.299) * r + c(0.587) * g + c(0.114) * b
    y = yl * c(219.0 / 255.0) + c(16.0)
    u = (b - yl) / c(1.772) * c(224.0 / 255.0) + c(128.0)
    v = (r - yl) / c(1.402) * c(224.0 / 255.0) + c(128.0)
    return tuple(torch.round(p.float()).clamp(0, 255).to(torch.uint8)
                 for p in (y, u, v))


def payloads(fields: torch.Tensor, height: int, is422: bool,
             dtype=torch.float32) -> torch.Tensor:
    """uint8 [B, frame bytes] of uint8 RGB fields [B, L, W, 3]."""
    frames = fields.repeat_interleave(2, dim=1)[:, :height]
    y, u, v = rgb_to_yuv601(frames, dtype)
    u, v = u[:, :, 0::2], v[:, :, 0::2]
    if not is422:
        u, v = u[:, 0::2], v[:, 0::2]
    return torch.cat([p.reshape(p.shape[0], -1) for p in (y, u, v)], dim=1)
