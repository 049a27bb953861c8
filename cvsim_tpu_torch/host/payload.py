"""The gen-2 render's Y4M frame payloads: a GOP of processed RGB fields to
the bytes that follow each frame's "FRAME\\n".

A field's frame is bobbed (frame row r is field row r >> 1, `height` rows)
and converted with colorconv.rgb_to_yuv601_np; its payload is the Y plane
[height, w], then U and V [ch, ceil(w / 2)], the frame's even columns, of
its even rows at 4:2:0 (ch = ceil(height / 2)) or of every row at 4:2:2
(ch = height): the bytes Y4MWriter.write puts after "FRAME\n" for those
planes, so that YIQPipeline._emit does no per-pixel work.

- `payloads_np`: the plain version, numpy on the host, field by field.
- `payloads`: on a CUDA tensor one launch of csrc/y4m_payload.cu
  (`cvsim_y4m_payload`, no sync), the payloads left on the card; on a CPU
  tensor `payloads_np`.
- `planes`: the Y, U and V views of one payload row.
"""

from __future__ import annotations

import numpy as np
import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.host.colorconv import rgb_to_yuv601_np


def plane_shapes(height: int, width: int, is422: bool):
    """(Y shape, chroma shape) of a payload."""
    ch = height if is422 else (height + 1) // 2
    return (height, width), (ch, (width + 1) // 2)


def frame_bytes(height: int, width: int, is422: bool) -> int:
    (h, w), (ch, cw) = plane_shapes(height, width, is422)
    return h * w + 2 * ch * cw


def _check(shape, height: int):
    if len(shape) != 4 or shape[-1] != 3:
        raise ValueError(f"fields: expected [B, L, W, 3], got {tuple(shape)}")
    if not 1 <= height <= 2 * shape[1]:
        raise ValueError(f"height {height}: a bobbed field of {shape[1]} "
                         f"lines gives 1 to {2 * shape[1]}")


def payloads_np(fields: np.ndarray, height: int, is422: bool) -> np.ndarray:
    """uint8 [B, frame_bytes] of uint8 RGB fields [B, L, W, 3]. Each
    field's read rows are converted once (the conversion is per pixel, so
    converting before the bob gives the bob's bytes) and placed."""
    _check(fields.shape, height)
    b, _, w, _ = fields.shape
    rows = (height + 1) // 2
    ch = plane_shapes(height, w, is422)[1][0]
    out = np.empty((b, frame_bytes(height, w, is422)), np.uint8)
    for k in range(b):
        y_p, u_p, v_p = planes(out[k], height, w, is422)
        f = fields[k, :rows].astype(np.int32)
        y, u, v = rgb_to_yuv601_np(f[..., 0], f[..., 1], f[..., 2])
        y_p[:] = np.repeat(y, 2, axis=0)[:height]
        u, v = u[:, 0::2], v[:, 0::2]
        if is422:
            u = np.repeat(u, 2, axis=0)[:ch]
            v = np.repeat(v, 2, axis=0)[:ch]
        u_p[:] = u
        v_p[:] = v
    return out


def planes(row: np.ndarray, height: int, width: int, is422: bool):
    """The Y, U and V planes of one payload row, as views of it."""
    (h, w), (ch, cw) = plane_shapes(height, width, is422)
    n = ch * cw
    return (row[:h * w].reshape(h, w),
            row[h * w:h * w + n].reshape(ch, cw),
            row[h * w + n:].reshape(ch, cw))


def payloads(fields: torch.Tensor, height: int, is422: bool) -> torch.Tensor:
    """payloads_np of uint8 fields [B, L, W, 3], on the fields' device. A
    CPU tensor runs payloads_np. A CUDA tensor launches csrc/y4m_payload.cu
    (built at first use) on the current stream, without a sync, or
    raises; there is no fallback."""
    _check(fields.shape, height)
    if fields.dtype != torch.uint8:
        raise ValueError(f"fields: expected uint8, got {fields.dtype}")
    dev = kernels.device_of(fields, "y4m_payload")
    if dev is None:
        return torch.from_numpy(payloads_np(fields.numpy(), height, is422))
    b, l, w, _ = fields.shape
    fields = fields.contiguous()
    out = torch.empty((b, frame_bytes(height, w, is422)), dtype=torch.uint8,
                      device=dev)
    kernels.launch("y4m_payload", fields, out, b, l, w, height, int(is422),
                   device=dev)
    return out
