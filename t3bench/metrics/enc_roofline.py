"""enc_roofline: K3 (``csrc/encode.cu``) against its memory bound,
``rooflines/superframe_encode.json``, in the cells that report ``fps``."""
from t3bench.lib import roofline


def read(ctx):
    return roofline.share(ctx, "superframe_encode")
