"""decode_ms.rt: device time of ``SuperframeCodec.decode(..., "auto")`` a
frame (header, K1 check), CUDA events around the call, mean over the
window's requests."""


def read(ctx):
    ms = ctx.spans.get("decode")
    return sum(ms) / len(ms) if ms else None
