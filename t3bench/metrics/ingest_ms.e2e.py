"""ingest_ms.e2e: the ingest bridge (``wordcodec.ingest9``: BT.601, the
quantiser and the word9 pack of the whole frame) in device ms a frame: the
union of the kernels' and copies' intervals that the program launched
under its ``t3.ingest`` span inside ``t3.encode_rgb``, from the trace."""
from t3bench.lib import program


def read(ctx):
    return program.device_ms(ctx, "t3.encode_rgb", "t3.ingest")
