"""encode_ms.rt: device time of ``SuperframeCodec.encode`` a frame, CUDA
events around the call, mean over the window's requests."""


def read(ctx):
    ms = ctx.spans.get("encode")
    return sum(ms) / len(ms) if ms else None
