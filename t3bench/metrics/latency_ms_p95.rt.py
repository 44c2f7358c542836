"""latency_ms_p95.rt: ``latency_ms_p95`` of the host-bound round trip:
the 95th percentile of every request of the window (host clock, linear
interpolation between order statistics)."""
import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.latencies_s) * 1e3, 95))
