"""The benchmark's plain reference of the codec's wire format.

Written from the format's definition (old/include/ternary_image_codec_v6_min.hpp
as the repository documents it), in numpy and plain torch, and importing
nothing of either codec package: ``codec.encode`` makes a frame's wire
planes, ``codec.expected_decode`` the RAW planes a decode must return.
"""
