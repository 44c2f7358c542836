"""k2_launches: K2 launches a request: the program's ``t3.k2.launches``
counter (calls of ``rs.correct_pm`` that reach ``rs_cuda.rs_correct``)
over the calls of ``t3.decode_frames``."""
from t3bench.lib import program


def read(ctx):
    c, rep = program.counts(ctx), program.report(ctx)
    if not c or "t3.k2.launches" not in c:
        return None
    n = program.calls(rep, "t3.decode_frames")
    return c["t3.k2.launches"] / n if n else None
