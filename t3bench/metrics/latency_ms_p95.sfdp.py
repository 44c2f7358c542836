"""latency_ms_p95.sfdp: ``latency_ms_p95`` of the four-card superframe
split: the 95th percentile of every request of the window, from rank 0's
broadcast that lets the other ranks run it to rank 0's device sync after
the gather (host clock, linear interpolation between order statistics)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s) * 1e3, 95))
