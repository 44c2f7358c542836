"""fps.sfdp: ``fps`` of the four-card superframe split, a metric of its own
since its host and its collectives set its noise: frames completed over
the whole window (host clock), each request counted from the broadcast
that lets the other ranks run it."""


def read(ctx):
    return ctx.frames / ctx.window_s
