"""encode_host_ms.rt: host ms a frame of the program's ``t3.encode`` span
(``SuperframeCodec.encode``): the encode's dispatch, since it waits for
the device nowhere."""
from t3bench.lib import program


def read(ctx):
    return program.host_ms(ctx, "t3.encode", "t3.encode")
