"""The least time of one `to-composite` library call's work (harness/work.py:
its bytes over 3.35 TB/s or its recurrences' float32 operations over 67
TFLOP/s, whichever is larger) over the device time of everything the
call launched (`prepare`'s work and kernel csrc/yuv_chain.cu's; the union of
the device intervals in the window, per call), in %."""

from harness.work import roofline_pct


def read(run):
    return roofline_pct(run)
