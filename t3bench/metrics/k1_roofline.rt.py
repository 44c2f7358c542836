"""k1_roofline.rt: K1 (``csrc/check_decode.cu``) against its memory bound,
``rooflines/check_decode.json``, in the round trip's decode."""
from t3bench.lib import roofline


def read(ctx):
    return roofline.share(ctx, "check_decode")
