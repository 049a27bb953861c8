"""Host wall of the program's `gen2.emit.convert` span (bob, RGB->YUV and
the uint8 casts of one field in `YIQPipeline._emit`), mean a field, in
ms."""

from harness.program_trace import mean_ms


def read(run):
    return mean_ms("gen2.emit.convert")
