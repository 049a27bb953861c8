"""Device time of the `y4m_payload` kernel per call, in ms: None without
a trace, a call or the kernel among the trace's longest device ops."""


def read(run):
    if run.trace is None or run.window.units == 0:
        return None
    found = [sec for name, sec in run.trace.device_ops
             if "y4m_payload" in name]
    return 1e3 * sum(found) / run.window.units if found else None
