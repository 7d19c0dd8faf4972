"""frame_latency_p95_ms (ms, host clock): the 95th percentile of every
frame call of the window, each from the call to its return (numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
