"""Host wall per call of the gen-2 per-line inputs
(`models/fused_yiq.prepare`), in ms: the call's launches and the copies it
waits for."""


def read(run):
    return run.spans.mean_ms("prepare") if run.spans else None
