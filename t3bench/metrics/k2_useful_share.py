"""k2_useful_share: the share of the codewords sent to K2 that needed it:
the program's ``t3.k2.dirty`` counter (codewords with a nonzero syndrome
among those the paged chains sent) over ``t3.k2.codewords`` (every
codeword ``rs.correct_pm`` received), in percent."""
from t3bench.lib import program


def read(ctx):
    c = program.counts(ctx)
    if not c or not c.get("t3.k2.codewords") or "t3.k2.dirty" not in c:
        return None
    return 100.0 * c["t3.k2.dirty"] / c["t3.k2.codewords"]
