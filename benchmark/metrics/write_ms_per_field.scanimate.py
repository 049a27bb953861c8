"""Host wall of scanimate's Y4M writes (the program's `scanimate.write`
spans, on the writer thread: one frame's planes into the output) per
field (`scanimate.pack`, one a field written), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("scanimate.write",), "scanimate.pack")


# a recorder snapshot and what it reads: 64 frames written in 96 ms
CASE = ({"aggregates": {"scanimate.write": aggregate(64, 96.0),
                        "scanimate.pack": aggregate(64, 320.0)}}, 1.5)
