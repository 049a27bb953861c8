"""Share of the traced window in which no kernel, copy or memset runs on
the card: one minus the union of the profiler's device intervals (not
their sum) over the window, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
