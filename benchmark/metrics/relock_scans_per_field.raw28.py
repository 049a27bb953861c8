"""Per-line hsync re-locks (the program's counter `raw28.relock_scans`,
one a `relock_hsync` call) per decoded field (`raw28.field`)."""

from harness.program_trace import aggregate, count_per_span


def read(run):
    return count_per_span("raw28.relock_scans", ("raw28.field",))


# a recorder snapshot and what it reads: 20 fields of 262 lines, one of
# them cut 4 lines short by a vsync
CASE = ({"aggregates": {"raw28.field": aggregate(
            20, 400.0, {"raw28.relock_scans": 5236}),
         "raw28.lines": aggregate(20, 200.0, {"raw28.relock_scans": 5236})}},
        261.8)
