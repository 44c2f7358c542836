"""repair_ms: the repair window of the fused decode in device ms a
frame: the union of the kernels' and copies' intervals that the program
launched under its ``t3.repair`` span (the argsort of the flags, the
window's gather, the paged chain with K2 and the header chain, the
scatter back) inside ``t3.decode_frames``, from the trace.  The host's
dispatch of that work is not in it: where the host is slower than the
device, the stream waits and the reading does not grow."""
from t3bench.lib import program


def read(ctx):
    return program.device_ms(ctx, "t3.decode_frames", "t3.repair")
