"""Host wall of scanimate's per-field packing (the program's
`scanimate.pack` spans: the gray raster to int32 RGB, the row-0 rule,
RGB->YUV and the chroma subsampling), per field, in ms."""

from harness.program_trace import aggregate, mean_ms


def read(run):
    return mean_ms("scanimate.pack")


# a recorder snapshot and what it reads: 64 fields in 320 ms
CASE = ({"aggregates": {"scanimate.pack": aggregate(64, 320.0),
                        "scanimate.batch": aggregate(4, 4000.0)}}, 5.0)
