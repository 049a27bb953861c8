"""Host wall of scanimate's source reads (the program's `scanimate.read`
spans: a Y4M frame read and scaled to the raster as int32, and the read
that meets the stream's end) per field (`scanimate.pack`, one a field
written), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("scanimate.read",), "scanimate.pack")


# a recorder snapshot and what it reads: 33 reads, 64 fields
CASE = ({"aggregates": {"scanimate.read": aggregate(33, 660.0),
                        "scanimate.pack": aggregate(64, 320.0),
                        "scanimate.batch": aggregate(4, 4000.0)}}, 10.3125)
