"""Host wall of the raw decoder's stream loop writing a field's Y4M frame
(`raw28.write`: neutral 4:2:2 chroma and the writer) per decoded field
(`raw28.field`), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("raw28.write",), "raw28.field")


# a recorder snapshot and what it reads: 30 ms over 20 fields
CASE = ({"aggregates": {"raw28.field": aggregate(20, 400.0),
                        "raw28.write": aggregate(20, 30.0)}}, 1.5)
