"""Host wall of the program's `gen2.read` span (one source frame: the
Y4M read and `_scale_frame_to`) in the gen-2 host loop, mean a frame,
in ms."""

from harness.program_trace import mean_ms


def read(run):
    return mean_ms("gen2.read")
