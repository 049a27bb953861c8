"""Host wall of the program's `gen2.wait` span (the `out.cpu()` of a GOP
in `YIQPipeline.process_batch`, which waits for the chain and the
device-to-host copy), mean a GOP, in ms."""

from harness.program_trace import mean_ms


def read(run):
    return mean_ms("gen2.wait")
