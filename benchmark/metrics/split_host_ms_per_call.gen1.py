"""Host wall of the gen-1 split route's steps (the program's
`gen1.split.a`, `.switch`, `.b1`, `.blend` and `.b2` spans: the launches
of kernels #6-#8 and the head switch's and the blend's eager ops) per
library call (`gen1.call`), in ms."""

from harness.program_trace import aggregate, per_parent_ms

STEPS = ("gen1.split.a", "gen1.split.switch", "gen1.split.b1",
         "gen1.split.blend", "gen1.split.b2")


def read(run):
    return per_parent_ms(STEPS, "gen1.call")


# a recorder snapshot and what it reads: 2 PAL calls (no blend), the
# steps' (0.3 + 0.5 + 0.4 + 0.6) ms over them; the prepare is not a step
CASE = ({"aggregates": {"gen1.call": aggregate(2, 10.0),
                        "gen1.prepare": aggregate(2, 5.0),
                        "gen1.launch": aggregate(2, 2.0),
                        "gen1.split.a": aggregate(2, 0.3),
                        "gen1.split.switch": aggregate(2, 0.5),
                        "gen1.split.b1": aggregate(2, 0.4),
                        "gen1.split.b2": aggregate(2, 0.6)}}, 0.9)
