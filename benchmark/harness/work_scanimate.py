"""The least time of one scanimate field's splat on the card (the peaks of
harness/work.py: 3.35 TB/s, 67 TFLOP/s in float32).

Counted is only what every correct splat must do, however it is built:
read the green plane of the field's source rows once and write the
field's uint8 raster once (bytes); evaluate the cone once for each stamp
cell that lies inside it, about pi * radius^2 cells a dot (operations:
CONE_FLOPS a cell). A splat that skips the stamp's empty cells, or
clamps and narrows the raster as it writes, is read against the same
work. The source is scaled to the raster first, so its rows and columns
are the raster's."""

from __future__ import annotations

import math

from harness.work import least_time_s

# a cell of the cone: the two offsets from the dot, their squares and
# sum, the root, the difference from the radius, the product with the
# dot's weight
CONE_FLOPS = 8


def field_splat(height: int, width: int, inntsc: bool,
                precision: int) -> tuple[float, str]:
    """(seconds, "bytes" or "operations") of one field's splat."""
    rows = height // 2 if inntsc else height
    dots = rows * (width << precision)
    radius = max(height * (2.05 if inntsc else 1.05) / height, 1.2)
    cells = dots * math.pi * radius ** 2
    return least_time_s(cells * CONE_FLOPS, rows * width + height * width)
