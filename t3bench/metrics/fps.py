"""fps: 8K frames completed over the whole measured window, all frames of
all requests divided by all the time (host clock)."""


def read(ctx):
    return ctx.frames / ctx.window_s
