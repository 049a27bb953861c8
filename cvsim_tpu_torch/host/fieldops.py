"""Field row index math (reference L4): the port's copy of the numpy
functions of cvsim_tpu/host/fieldops.py.

- render_field_indices: the row index math of the custom vertical scaler
  with 8-bit fractional interpolation, 4:2:0-vs-4:2:2 chroma siting and
  interlaced source field selection (ffmpeg_to_composite.cpp:1001-1129);
  host/batching.py builds its gather tables from it.
- bob_rows: the bob filter's row selection (output_frame, :1131-1250).
"""

from __future__ import annotations

import numpy as np


def _field_rows(dst_height: int, parity: int) -> np.ndarray:
    return np.arange(parity, dst_height, 2)


def render_field_indices(
    dst_height: int,
    src_height: int,
    chroma_height: int,
    parity: int,
    *,
    src_interlaced: bool = False,
    src_top_field_first: bool = True,
    pts_delta: int = 0,
    ticks_per_frame: int = 2,
):
    """Compute (luma_idx1, luma_idx2, luma_frac, chroma_idx1, chroma_idx2,
    chroma_frac) numpy arrays for one field's output rows — the index math of
    render_field (ffmpeg_to_composite.cpp:1019-1086)."""
    ys = _field_rows(dst_height, parity)
    sy_fix = (ys * 0x100 * src_height) // dst_height
    syf = sy_fix & 0xFF
    sy = sy_fix >> 8

    is420 = chroma_height != src_height
    csy = sy.copy()
    csyf = syf.copy()
    if is420:
        csyf = np.where((csy & 1) == 0, 0, csyf)
        csy >>= 1

    if src_interlaced:
        which = 0 if src_top_field_first else 1
        if pts_delta >= ticks_per_frame // 2:
            which ^= 1
        if which == 0:
            sy = sy + 1
            even = (sy & 1) == 0
            syf = np.where(even, 0, syf)
            sy = np.where(even, sy, sy - 1)
            csy = csy + 1
            ceven = (csy & 1) == 0
            csyf = np.where(ceven, 0, csyf)
            csy = np.where(ceven, csy, csy - 1)
        else:
            odd_fix = (sy & 1) == 0
            syf = np.where(odd_fix, 0, syf)
            sy = np.where(odd_fix, sy + 1, sy)
            codd_fix = (csy & 1) == 0
            csyf = np.where(codd_fix, 0, csyf)
            csy = np.where(codd_fix, csy + 1, csy)
        over = sy >= (src_height - 2)
        sy = np.where(over, src_height - 2, sy)
        syf = np.where(over, 0, syf)
        sy2 = sy + 2
        cover = csy >= (chroma_height - 2)
        csy = np.where(cover, chroma_height - 2, csy)
        csyf = np.where(cover, 0, csyf)
        csy2 = csy + 1
    else:
        over = sy >= (src_height - 1)
        sy = np.where(over, src_height - 1, sy)
        syf = np.where(over, 0, syf)
        sy2 = sy + 1
        cover = csy >= (chroma_height - 1)
        csy = np.where(cover, chroma_height - 1, csy)
        csyf = np.where(cover, 0, csyf)
        csy2 = csy + 1

    if not is420:
        # the reference's non-420 blend loop (:1109-1126) indexes ALL three
        # planes with the LUMA rows — csy/csy2/csyf are computed but only
        # consumed on the 420 path (:1102-1107). In particular interlaced
        # 4:2:2 chroma steps by 2 (same field), not 1.
        csy, csy2, csyf = sy, sy2, syf
    return sy, sy2, syf, csy, csy2, csyf


# ------------------------------------------------------------------ packers

def bob_rows(height: int, parity: int, interlaced_output: bool = False) -> np.ndarray:
    """Row selection of the bob filter (output_frame, :1178-1235):
    field=1 -> 1,1,3,3,5..., field=0 -> 0,2,2,4,4...; rows beyond the frame
    step back two."""
    ys = np.arange(height)
    if interlaced_output:
        sy = ys
    elif parity:
        sy = ys | 1
    else:
        sy = (ys + 1) & ~1
    return np.where(sy >= height, sy - 2, sy)
