"""Device time of the gen-1 split route's kernels, #6 `cvsim::yuv_a`, #7
`cvsim::yuv_b1` and #8 `cvsim::yuv_b2` (csrc/yuv_chain.cu), in the
traced window's device activities, per call, in ms."""

KERNELS = ("cvsim::yuv_a", "cvsim::yuv_b1", "cvsim::yuv_b2")


def read(run):
    if run.trace is None or run.window.units == 0:
        return None
    # a template instance is named `cvsim::yuv_a<true>`
    s = [sec for name, sec in run.trace.device_ops
         if name.split("<", 1)[0] in KERNELS]
    if not s:
        return None
    return 1e3 * sum(s) / run.window.units
