"""95th percentile, over every library call of the window, of the time
from the call's start to its synchronised output, in ms (numpy's linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = run.window.latencies
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
