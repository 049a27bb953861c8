"""Host wall of the raw decoder's line decode per decoded field
(`raw28.decode`: the gather, the copy to the card, `decode_lines` with
kernel `raw28_tails`, and the fetch), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("raw28.decode",), "raw28.field")


# a recorder snapshot and what it reads: 50 ms over 20 fields
CASE = ({"aggregates": {"raw28.field": aggregate(20, 400.0),
                        "raw28.lines": aggregate(20, 200.0),
                        "raw28.decode": aggregate(20, 50.0)}}, 2.5)
