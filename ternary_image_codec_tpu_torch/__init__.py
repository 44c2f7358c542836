"""PyTorch/CUDA port of the ternary superframe codec.

The JAX package ``ternary_image_codec_tpu`` is the reference; this package
imports torch and numpy, never jax and nothing of the JAX package (its
``config`` is a copy of the reference's).  The entry points run on the
CUDA card unless the caller passes ``device="cpu"``.  See ops/pipeline.py
for the stream and the profile API, ops/wordcodec.py and io/image.py for
the pixel bridge, io/serve.py for the serve path (T3V6 containers on disk,
the base-243 wire pack, the approval gate, the pipelined executor).
"""
from .config import (EncoderConfig, ProfileID, ScramblerSeed,
                     SuperframeHeader, uep_luma_priority, uep_uniform)
from .codec import SuperframeCodec, tables_from_reference
from .ops.pipeline import (decode_frames_fused, decode_header_from_words,
                           decode_profile_to_raw, decode_stream_superframes,
                           encode_profile_from_raw, encode_stream_superframes,
                           roundtrip_stream)

__all__ = ["EncoderConfig", "ProfileID", "ScramblerSeed", "SuperframeCodec",
           "SuperframeHeader", "decode_frames_fused",
           "decode_header_from_words", "decode_profile_to_raw",
           "decode_stream_superframes", "encode_profile_from_raw",
           "encode_stream_superframes", "roundtrip_stream",
           "tables_from_reference", "uep_luma_priority", "uep_uniform"]
