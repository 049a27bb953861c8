"""Host wall of the raw decoder's sync per decoded field (`raw28.field`):
the vsync hunt with its AGC updates (`raw28.hunt`) and the line pacing
with the per-line hsync re-lock (`raw28.lines`), in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("raw28.hunt", "raw28.lines"), "raw28.field")


# a recorder snapshot and what it reads: (60 + 200) ms over 20 fields; the
# decode is not sync
CASE = ({"aggregates": {"raw28.field": aggregate(20, 400.0),
                        "raw28.hunt": aggregate(20, 60.0),
                        "raw28.lines": aggregate(20, 200.0),
                        "raw28.decode": aggregate(20, 50.0)}}, 13.0)
