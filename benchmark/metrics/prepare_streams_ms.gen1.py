"""Host wall of the program's `gen1.prepare.streams` span (the per-line
streams of `models/fused_yuv.prepare`: `yiq.field_streams`), mean a
call, in ms."""

from harness.program_trace import mean_ms


def read(run):
    return mean_ms("gen1.prepare.streams")
