"""fps.rt: ``fps`` of the host-bound write-verify round trip, a metric of
its own so that its host noise does not set the bound of the other
cells' ``fps``: frames completed over the whole window (host clock)."""


def read(ctx):
    return ctx.frames / ctx.window_s
