"""k2_roofline: K2 (``csrc/rs_correct.cu``) against its memory bound,
``rooflines/rs_correct.json``."""
from t3bench.lib import roofline


def read(ctx):
    return roofline.share(ctx, "rs_correct")
