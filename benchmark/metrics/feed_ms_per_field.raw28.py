"""Host wall of the raw decoder's `feed` (the program's `raw28.feed`
spans: the native DC tracker over a chunk and its buffering) per decoded
field (`raw28.field`), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("raw28.feed",), "raw28.field")


# a recorder snapshot and what it reads: 9 chunks fed, 20 fields decoded
CASE = ({"aggregates": {"raw28.feed": aggregate(9, 72.0),
                        "raw28.field": aggregate(20, 400.0),
                        "raw28.hunt": aggregate(20, 60.0)}}, 3.6)
