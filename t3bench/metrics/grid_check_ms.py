"""grid_check_ms: the plain grid check (``pipeline.grid_check``, the
check route of layouts K1 does not cover) in device ms a frame: the union
of the kernels' and copies' intervals that the program launched under its
``t3.check.grid`` spans inside ``t3.decode_frames``, from the trace."""
from t3bench.lib import program


def read(ctx):
    return program.device_ms(ctx, "t3.decode_frames", "t3.check.grid")
