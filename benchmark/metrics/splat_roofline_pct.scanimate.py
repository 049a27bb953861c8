"""The least time of a field's splat (harness/work_scanimate.py: the cone
once per in-cone cell at 67 TFLOP/s, or the green bytes read and the
raster written at 3.35 TB/s, whichever is larger) times the fields the
window completed, over the splat's device time: the union of the device
intervals in the window outside the copies (the warp's and the splat's
eager ops, the clamp), in %. None without a trace, a count of work or a
field."""


def read(run):
    if (run.trace is None or run.least_time is None
            or run.window.fields == 0):
        return None
    splat_s = run.trace.busy_s - run.trace.copy_s
    if splat_s <= 0:
        return None
    return 100.0 * run.least_time[0] * run.window.fields / splat_s
