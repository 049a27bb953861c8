"""Detector samples the raw decoder's sync examines (the program's
counter `raw28.sync_samples`, counted in the vsync hunt and the line
walk) per decoded field (`raw28.field`). A program that does not count
them reads None."""

from harness.program_trace import aggregate, aggregates, count_per_span

COUNTER = "raw28.sync_samples"


def read(run):
    if not any(COUNTER in a["counts"] for a in (aggregates() or {}).values()):
        return None
    return count_per_span(COUNTER, ("raw28.field",))


# a recorder snapshot and what it reads: 20 fields, each examining about
# 55,000 samples in the hunt and 72,000 in the walk
CASE = ({"aggregates": {
            "raw28.field": aggregate(20, 400.0, {COUNTER: 2_540_000}),
            "raw28.hunt": aggregate(20, 6.0, {COUNTER: 1_100_000}),
            "raw28.lines": aggregate(20, 2.0, {COUNTER: 1_440_000})}},
        127_000.0)
