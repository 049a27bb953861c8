"""Device time per call of what is neither a `cvsim::` kernel nor a
memory copy: the eager PyTorch ops of the head-switch seam and of
`prepare`. The union of the window's device intervals less the copies'
union and less the `cvsim::` kernels among the trace's ten longest
device ops (`DeviceTrace.device_ops`), per call, in ms. A `cvsim::`
kernel off that list (`field_streams` on the split route) counts here as
eager. The difference is not floored: a negative reading says the
subtraction went wrong."""


def read(run):
    if run.trace is None or run.window.units == 0:
        return None
    kernels = sum(sec for name, sec in run.trace.device_ops
                  if name.startswith("cvsim::"))
    rest = run.trace.busy_s - kernels - run.trace.copy_s
    return 1e3 * rest / run.window.units
