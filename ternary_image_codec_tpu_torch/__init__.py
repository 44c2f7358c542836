"""PyTorch/CUDA port of the ternary superframe codec.

The JAX package ``ternary_image_codec_tpu`` is the reference; this package
imports torch and numpy, never jax and nothing of the JAX package (its
``config`` is a copy of the reference's).  The entry points run on the
CUDA card unless the caller passes ``device="cpu"``.  See ops/pipeline.py
for the stream.
"""
from .config import (EncoderConfig, ProfileID, ScramblerSeed,
                     SuperframeHeader, uep_luma_priority, uep_uniform)
from .codec import SuperframeCodec, tables_from_reference
from .ops.pipeline import (decode_stream_superframes,
                           encode_stream_superframes, roundtrip_stream)

__all__ = ["EncoderConfig", "ProfileID", "ScramblerSeed", "SuperframeCodec",
           "SuperframeHeader", "decode_stream_superframes",
           "encode_stream_superframes", "roundtrip_stream",
           "tables_from_reference", "uep_luma_priority", "uep_uniform"]
