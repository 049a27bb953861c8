"""Host waits on the card (the program's `syncs` counter: blocking
copies, `.cpu()`, event waits) counted inside its library-entry spans
`gen2.call` and `gen1.call`, per call."""

from harness.program_trace import count_per_span


def read(run):
    return count_per_span("syncs", ("gen2.call", "gen1.call"))
