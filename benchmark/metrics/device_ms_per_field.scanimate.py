"""Device busy time per field the window completed, in ms: the union of
the profiler's device intervals in the window (the upload, the warp's
and the splat's eager ops, the fetch) over the fields; None without a
trace or a field."""


def read(run):
    if run.trace is None or run.window.fields == 0:
        return None
    return 1e3 * run.trace.busy_s / run.window.fields
