"""Host wall of the program's `gen2.prepare.tables` (the IIR tables
built in numpy) and `gen2.prepare.copy` spans (their copies and the
field numbers' to the card, with the waits they make) per
`gen2.prepare`, in ms."""

from harness.program_trace import per_parent_ms


def read(run):
    return per_parent_ms(("gen2.prepare.tables", "gen2.prepare.copy"),
                         "gen2.prepare")
