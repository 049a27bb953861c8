"""Host wall of the program's `gen1.prepare.tables` (the IIR tables
built in numpy) and `gen1.prepare.copy` spans (their copies and the
field numbers' to the card, with the waits they make) per
`gen1.prepare`, in ms."""

from harness.program_trace import per_parent_ms


def read(run):
    return per_parent_ms(("gen1.prepare.tables", "gen1.prepare.copy"),
                         "gen1.prepare")
