"""Host waits on the card (the program's `syncs` counter) counted inside
the gen-2 host loop's `gen2.flush` spans, per GOP."""

from harness.program_trace import aggregate, count_per_span


def read(run):
    return count_per_span("syncs", ("gen2.flush",))


# a recorder snapshot and what it reads: 28 waits in 4 flushes (the 4
# inside their `gen2.wait` spans are among them)
CASE = ({"aggregates": {"gen2.flush": aggregate(4, 100.0, {"syncs": 28}),
                        "gen2.wait": aggregate(4, 30.0, {"syncs": 4})}},
        7.0)
