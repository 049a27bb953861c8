"""Stamp cells scanimate's splat evaluates (the program's counter
`scanimate.stamp_cells`, dots x the stamp's area, counted inside
`scanimate.batch`) per field (`scanimate.pack`, one a field written). A
program that does not count them reads None."""

from harness.program_trace import aggregate, aggregates

COUNTER = "scanimate.stamp_cells"


def read(run):
    aggs = aggregates() or {}
    fields = aggs.get("scanimate.pack", {}).get("count")
    counts = aggs.get("scanimate.batch", {}).get("counts", {})
    if not fields or COUNTER not in counts:
        return None
    return counts[COUNTER] / fields


# a recorder snapshot and what it reads: 4 batches of 16 fields at 1080p
# with -inntsc, 2,073,600 dots a field, a stamp of 6 x 6
CASE = ({"aggregates": {
            "scanimate.batch": aggregate(4, 4000.0,
                                         {COUNTER: 64 * 74_649_600}),
            "scanimate.splat": aggregate(8, 100.0,
                                         {COUNTER: 64 * 74_649_600}),
            "scanimate.pack": aggregate(64, 320.0)}}, 74_649_600.0)
