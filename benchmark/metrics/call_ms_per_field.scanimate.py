"""Host wall of scanimate's device calls (the program's `scanimate.call`
spans: the uint8 upload, `scanimate_field`'s warp and splat enqueued,
the clamp and the synchronous uint8 fetch; two calls a batch with
-inntsc) per field (`scanimate.pack`, one a field written), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("scanimate.call",), "scanimate.pack")


# a recorder snapshot and what it reads: 8 calls of 300 ms, 64 fields
CASE = ({"aggregates": {"scanimate.call": aggregate(8, 2400.0),
                        "scanimate.upload": aggregate(8, 40.0),
                        "scanimate.pack": aggregate(64, 320.0)}}, 37.5)
