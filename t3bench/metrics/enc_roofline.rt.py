"""enc_roofline.rt: K3 (``csrc/encode.cu``) against its memory bound,
``rooflines/superframe_encode.json``, in the round trip's encode."""
from t3bench.lib import roofline


def read(ctx):
    return roofline.share(ctx, "superframe_encode")
