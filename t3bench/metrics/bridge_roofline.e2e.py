"""bridge_roofline.e2e: both pixel bridges against their memory bound, in
percent: the least bytes they move for a frame (``rgb.bridge_bytes``:
497,664,000 B at 7680x4320) over ``peaks.json``'s HBM rate, over the
device time a frame under the spans ``t3.ingest`` and ``t3.egress``.  The
bytes come from the frame's shape, not from the calls, so the reading
holds whatever implements the bridges."""
from t3bench.lib import program, rgb


def read(ctx):
    ingest = program.device_ms(ctx, "t3.encode_rgb", "t3.ingest")
    egress = program.device_ms(ctx, "t3.decode_rgb", "t3.egress")
    if not ingest or not egress:
        return None
    least_s = rgb.bridge_bytes(*rgb.frame_size(ctx.config)) \
        / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / ((ingest + egress) / 1e3)
