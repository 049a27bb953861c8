"""Host wall of the program's `gen2.prepare.streams` span (the per-line
streams of `models/fused_yiq.prepare`: `yiq.field_streams`), mean a
call, in ms."""

from harness.program_trace import mean_ms


def read(run):
    return mean_ms("gen2.prepare.streams")
