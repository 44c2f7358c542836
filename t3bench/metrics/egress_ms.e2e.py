"""egress_ms.e2e: the egress bridge (``wordcodec.egress9``: the word9
unpack, the dequantiser and YCbCr -> RGB of the whole frame) in device ms
a frame: the union of the kernels' and copies' intervals that the program
launched under its ``t3.egress`` span inside ``t3.decode_rgb``, from the
trace."""
from t3bench.lib import program


def read(ctx):
    return program.device_ms(ctx, "t3.decode_rgb", "t3.egress")
