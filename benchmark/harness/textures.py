"""Seeded picture content: smooth colour fields, hard-edged rectangles,
gratings at several frequencies and orientations, and grain, so that
every filter of the chain sees edges, flat areas and fine detail, and
every frame of a pool differs. The same seed gives the same pictures.

`frame_pool` makes Y4M frames on the host (numpy, in bulk);
`device_pool` makes batches of fields on a device (torch, a generator on
that device, a few large calls)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _upsample(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear upsample of [..., gh, gw] to [..., h, w]."""
    gh, gw = grid.shape[-2:]
    ys = np.linspace(0, gh - 1, h)
    xs = np.linspace(0, gw - 1, w)
    y0 = np.minimum(ys.astype(int), gh - 2)
    x0 = np.minimum(xs.astype(int), gw - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    g00 = grid[..., y0[:, None], x0[None, :]]
    g01 = grid[..., y0[:, None], x0[None, :] + 1]
    g10 = grid[..., y0[:, None] + 1, x0[None, :]]
    g11 = grid[..., y0[:, None] + 1, x0[None, :] + 1]
    return ((g00 * (1 - fx) + g01 * fx) * (1 - fy)
            + (g10 * (1 - fx) + g11 * fx) * fy)


def _plane(rng: np.random.Generator, h: int, w: int, lo: float, hi: float,
           detail: float) -> np.ndarray:
    """One plane: a smooth field, 3-8 rectangles, a grating and grain."""
    p = _upsample(rng.uniform(lo, hi, (6, 8)), h, w)
    for _ in range(int(rng.integers(3, 9))):
        y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        y1 = y0 + int(rng.integers(8, max(9, h // 3)))
        x1 = x0 + int(rng.integers(8, max(9, w // 3)))
        p[y0:y1, x0:x1] = rng.uniform(lo, hi)
    yy, xx = np.mgrid[0:h, 0:w]
    theta = rng.uniform(0, np.pi)
    period = rng.uniform(2.5, 40.0)
    p += detail * np.sin((xx * np.cos(theta) + yy * np.sin(theta))
                         * (2 * np.pi / period) + rng.uniform(0, 2 * np.pi))
    p += rng.normal(0.0, detail / 4, (h, w))
    return np.clip(np.round(p), 0, 255).astype(np.uint8)


def frame_pool(seed: int, n: int, width: int, height: int,
               chroma_h: int, chroma_w: int) -> list[tuple]:
    """n seeded frames as (Y [H, W], U, V [chroma_h, chroma_w]) uint8."""
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x59344D])
    out = []
    for _ in range(n):
        y = _plane(rng, height, width, 16.0, 235.0, 24.0)
        u = _plane(rng, chroma_h, chroma_w, 40.0, 216.0, 12.0)
        v = _plane(rng, chroma_h, chroma_w, 40.0, 216.0, 12.0)
        out.append((y, u, v))
    return out


def device_pool(seed: int, shape: tuple, channels_last: int | None,
                device, lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """uint8 [*shape] pictures made on `device` from `seed`: the leading
    axes are pictures, the last two (or, with channels_last=c, the two
    before a last axis of c channels) are lines and samples."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 63 - 1))
    if channels_last:
        lead, (h, w) = shape[:-3], shape[-3:-1]
        n = int(np.prod(lead)) * channels_last
    else:
        lead, (h, w) = shape[:-2], shape[-2:]
        n = int(np.prod(lead))

    def rand(*s):
        return torch.rand(s, generator=gen, device=device)

    grid = lo + (hi - lo) * rand(n, 1, 6, 8)
    p = F.interpolate(grid, size=(h, w), mode="bilinear",
                      align_corners=True)[:, 0]
    # one hard-edged rectangle per picture
    y0 = (rand(n) * (h * 2 // 3)).long()
    x0 = (rand(n) * (w * 2 // 3)).long()
    yy = torch.arange(h, device=device)[None, :, None]
    xx = torch.arange(w, device=device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < y0[:, None, None] + h // 4)
              & (xx >= x0[:, None, None]) & (xx < x0[:, None, None] + w // 4))
    p = torch.where(inside, (lo + (hi - lo) * rand(n))[:, None, None], p)
    theta = rand(n)[:, None, None] * torch.pi
    period = 2.5 + 37.5 * rand(n)[:, None, None]
    phase = rand(n)[:, None, None] * 2 * torch.pi
    p = p + 20.0 * torch.sin((xx * torch.cos(theta) + yy * torch.sin(theta))
                             * (2 * torch.pi / period) + phase)
    p = p + 6.0 * torch.randn((n, h, w), generator=gen, device=device)
    p = p.round().clamp(0, 255).to(torch.uint8)
    if channels_last:
        return p.reshape(*lead, channels_last, h, w).movedim(-3, -1).contiguous()
    return p.reshape(*lead, h, w)
