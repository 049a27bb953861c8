"""Host wall of the program's `gen2.stack` (the GOP's fields copied into
the staging buffer, which the first flush makes) and `gen2.pin` (a batch
pinned for its copy, on a pipeline without the pinned buffer) spans per
`gen2.flush` of the gen-2 host loop, in ms."""

from harness.program_trace import aggregate, per_parent_ms


def read(run):
    return per_parent_ms(("gen2.stack", "gen2.pin"), "gen2.flush")


# a recorder snapshot and what it reads: 12 ms of stacks and 2 ms of one
# pin over 4 flushes
CASE = ({"aggregates": {"gen2.flush": aggregate(4, 100.0),
                        "gen2.stack": aggregate(4, 12.0),
                        "gen2.pin": aggregate(1, 2.0),
                        "gen2.wait": aggregate(4, 30.0)}}, 3.5)
