"""device_idle_share: one minus the union of the device's kernel, copy and
set intervals over the profiled stretch of the window, in percent."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
