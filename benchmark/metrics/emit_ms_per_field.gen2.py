"""Host wall inside the gen-2 host loop's `YIQPipeline._emit` (bob,
RGB->YUV, the Y4M write of one field) over the fields it emitted, in ms."""


def read(run):
    return run.spans.mean_ms("emit") if run.spans else None
