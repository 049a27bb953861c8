"""Subcarrier scanline phase (xi) tables (twin of cvsim_tpu.ops.phase).

Per scanline, a phase index xi in {0,1,2,3} selects where the 4-sample QAM
multiplier pattern starts (ffmpeg_to_composite.cpp:446-459,
ffmpeg_ntsc.cpp:1473-1480): a pure function of (fieldno, frame row,
comp_phase, comp_phase_offset).
"""

from __future__ import annotations

import torch


def scanline_phase_xi(
    fieldno: torch.Tensor,       # int [B] running 59.94Hz field counter
    field_parity: torch.Tensor,  # int [B] 0=top, 1=bottom
    num_lines: int,
    phase_shift: int,            # -comp-phase: 0|90|180|270
    phase_offset: int,           # -comp-phase-offset
    ntsc: bool,
    gen1: bool = False,
) -> torch.Tensor:
    """Return int32 [B, L] xi table. Frame row y = field_parity + 2*l."""
    fieldno = fieldno.to(torch.int32)[:, None]
    parity = field_parity.to(torch.int32)[:, None]
    l = torch.arange(num_lines, dtype=torch.int32,
                     device=fieldno.device)[None, :]
    y = parity + 2 * l

    if not ntsc and gen1:
        # gen-1 PAL branch (ffmpeg_to_composite.cpp:456-459)
        return (fieldno + y) & 3

    if phase_shift == 90:
        xi = (fieldno + phase_offset + (y >> 1)) & 3
    elif phase_shift == 180:
        xi = (((fieldno + y) & 2) + phase_offset) & 3
    elif phase_shift == 270:
        xi = (fieldno + phase_offset - (y >> 1)) & 3
    else:
        fill = 0 if gen1 else (phase_offset & 3)
        xi = torch.full_like(y, fill) & 3
    return xi.to(torch.int32)
