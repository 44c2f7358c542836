"""device_idle_share.sfdp: ``device_idle_share`` of the four-card
superframe split, read on rank 0's card (the only rank profiled): one
minus the union of its kernel, copy and set intervals over the profiled
stretch, in percent."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
