"""latency_ms_p95: the 95th percentile of every request of the window,
from the call into the port to the device sync that ends it (host clock,
linear interpolation between order statistics)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s) * 1e3, 95))
