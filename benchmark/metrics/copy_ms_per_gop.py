"""Device time of the memory copies (the union of the profiler's memcpy
intervals in the window) per GOP the window completed, in ms."""


def read(run):
    if run.trace is None or run.window.units == 0:
        return None
    return 1e3 * run.trace.copy_s / run.window.units
