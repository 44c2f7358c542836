"""RAW pixel <-> Word27 codecs and the pixel bridges, in torch.

The JAX package's ops/wordcodec.py.  Two word codecs:

* word9: 2 pixels a word, 9 GF(27) symbols: per pixel Yq in 5 trits,
  Cbq + 40 in 4 and Crq + 40 in 4, then the spare trit 26 = 0
  (old/include/ternary_image_codec_v6_min.hpp:665-747);
* word13: 1 pixel a word, the 13-trit integer
  code = Yq + 243 (Cbq + 40 + 81 (Crq + 40))
  (src/ternary_image_codec_v6_min.cpp:44-155).  The reference holds it in
  uint32; the port in int32 (codes are below 3^13 = 1,594,323), which
  torch computes on every device.

Quantized pixels are (n, 3) int32 [Yq, Cbq, Crq], Yq in [0, 242] and
Cbq/Crq in [-40, 40].

Two pairs of pixel bridges:

* ``ingest9``/``egress9``, the frame bridges of ``SuperframeCodec.encode_rgb``
  and ``decode_rgb``: interleaved RGB (..., 3) uint8 in raster order ->
  word-major word9 words (n, 9) int8, word j holding pixels 2j and
  2j + 1, and word9 planes (..., 9, m) -> interleaved RGB (..., m, 2, 3).
  A CUDA tensor goes to one hand-written kernel each way, K4 and K5
  (csrc/bridge.cu via ``bridge_cuda``); any other to the plain twins
  ``ingest9_ref``/``egress9_ref``, the streaming bridges' chains between
  copies;
* ``ingest9_planes``/``egress9_planes``, the streaming bridges of the
  micro-batched round trip: RGB (3, 2, m) uint8 [channel, pixel parity,
  word] <-> word9 planes (9, m) int8, torch on every device.

The BT.601 rows stay float32, one rounding per operation in the
reference's order (ops/quant.py says why nothing may fuse them): one
torch op each here, one ``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` each in
K4/K5; every step after the rounding is integer arithmetic.  The trit
pack and unpack are closed forms over the symbols
(``_pack_pair``/``_unpack_pair``) with the floor semantics of the
reference's digit chains, so any int8 word, valid or not, decodes as the
reference decodes it.

Functions take tensors and compute on the tensor's device.
"""
from __future__ import annotations

import torch

from ..config import SubwordMode
from . import bridge_cuda
from . import quant as Q

POW3_4 = 81
POW3_5 = 243


def _fdiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _pack_pair(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """(..., 9, m) word symbols of the pixel pairs whose 13-trit fields are
    y (..., 2, m) in [0, 242] and cb, cr (..., 2, m) in [0, 80], index 0 of
    the pair axis the word's first pixel.  Word trits: pixel a's y, cb, cr
    in 0..12, pixel b's in 13..25, trit 26 zero; symbol s is trits
    3s..3s+2."""
    ya, yb = y.unbind(-2)
    cba, cbb = cb.unbind(-2)
    cra, crb = cr.unbind(-2)
    syms = [ya % 27, _fdiv(ya, 27) + 9 * (cba % 3), _fdiv(cba, 3),
            cra % 27, _fdiv(cra, 27) + 3 * (yb % 9), _fdiv(yb, 9),
            cbb % 27, _fdiv(cbb, 27) + 3 * (crb % 9), _fdiv(crb, 9)]
    return torch.stack(syms, dim=-2).to(torch.int8)


def _unpack_pair(v: torch.Tensor):
    """(y, cb, cr), each (..., 2, m) int32, of word symbols v (..., 9, m):
    the fields as the reference reads them when each symbol's digits are
    (v mod 3, floor(v / 3) mod 3, floor(v / 9)) -- the top digit not
    reduced -- so a field spanning two symbols takes the low part of the
    second.  cb and cr still carry the +40."""
    v = v.to(torch.int32)
    v0, v1, v2, v3, v4, v5, v6, v7, v8 = v.unbind(-2)
    y = torch.stack([v0 + 27 * (v1 % 9), _fdiv(v4, 3) + 9 * v5], dim=-2)
    cb = torch.stack([_fdiv(v1, 9) + 3 * v2, v6 + 27 * (v7 % 3)], dim=-2)
    cr = torch.stack([v3 + 27 * (v4 % 3), _fdiv(v7, 3) + 9 * (v8 % 9)], dim=-2)
    return y, cb, cr


# ---------------------------------------------------------------------------
# word9: 2 px / word
# ---------------------------------------------------------------------------


def quant_to_words9(q: torch.Tensor) -> torch.Tensor:
    """(n, 3) quant pixels -> (ceil(n / 2), 9) int8 words.  An odd tail is
    padded with the default pixel (0, 0, 0) (old/.../v6_min.hpp:723-734);
    each field keeps its low trits (its value mod 3^5 or 3^4)."""
    q = q.to(torch.int32)
    if q.shape[0] % 2:
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
    p = q.reshape(-1, 2, 3).permute(2, 1, 0)                # (3, 2, m)
    words = _pack_pair(p[0] % POW3_5, (p[1] + 40) % POW3_4,
                       (p[2] + 40) % POW3_4)                # (9, m)
    return words.T


def words9_to_quant(words: torch.Tensor, n_pixels=None) -> torch.Tensor:
    """(m, 9) words -> (2m, 3) int32 quant pixels (first ``n_pixels``)."""
    y, cb, cr = _unpack_pair(words.T.to(torch.int32) % 27)  # (2, m) each
    q = torch.stack([y, cb - 40, cr - 40], dim=-1)          # (2, m, 3)
    q = q.transpose(0, 1).reshape(-1, 3)
    return q if n_pixels is None else q[:n_pixels]


# ---------------------------------------------------------------------------
# word13: 1 px / word (int32 codes)
# ---------------------------------------------------------------------------


def quant_to_words13(q: torch.Tensor) -> torch.Tensor:
    """(n, 3) quant pixels -> (n,) int32 13-trit codes, with the defensive
    clamps of pack13_from_quant (src/ternary_image_codec_v6_min.cpp:62-78)."""
    q = q.to(torch.int32)
    Y = q[:, 0].clamp(0, 242)
    Cb = (q[:, 1] + 40).clamp(0, 80)
    Cr = (q[:, 2] + 40).clamp(0, 80)
    return Y + POW3_5 * (Cb + POW3_4 * Cr)


def words13_to_quant(codes: torch.Tensor) -> torch.Tensor:
    """(n,) codes -> (n, 3) int32 quant pixels
    (src/ternary_image_codec_v6_min.cpp:81-94); codes are taken as int32."""
    c = codes.to(torch.int32)
    Y = (c % POW3_5).clamp(max=242)
    block = _fdiv(c, POW3_5)
    Cb = (block % POW3_4 - 40).clamp(-40, 40)
    Cr = (_fdiv(block, POW3_4) - 40).clamp(-40, 40)
    return torch.stack([Y, Cb, Cr], dim=-1)


# ---------------------------------------------------------------------------
# pixel bridges: ingest9/egress9 (frames), ingest9_planes/egress9_planes
# ---------------------------------------------------------------------------


def _round_u8(v: torch.Tensor) -> torch.Tensor:
    """clamp(lround(v), 0, 255) of float32 v as int32.  Below zero lround
    and floor(v + 0.5) both clamp to 0, so the half-away-from-zero arm of
    the reference's rounding is not needed."""
    return torch.floor(v + Q.f32(0.5)).clamp(0, 255).to(torch.int32)


def ingest9_planes(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3, 2, m) planar RGB, uint8 or its float32 values -> (..., 9, m)
    int8 word9 planes.

    BT.601 RGB -> YCbCr with lround (include/io_image.hpp:66-93), the
    quantization (:80-99) and the 2 px/word trit pack
    (old/.../v6_min.hpp:693-747).  Y, Cb and Cr of uint8 inputs are never
    negative (the rows' negative coefficients sum to -0.5), so lround is
    floor(v + 0.5)."""
    x = rgb.to(torch.float32)
    y, cb, cr = (_round_u8(v) for v in Q.ycbcr_rows(
        x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]))
    yq = Q.lround_ratio(y, 242, 255).clamp(0, 242)
    cbq = Q.lround_ratio(cb - 128, 40, 128).clamp(-40, 40) + 40
    crq = Q.lround_ratio(cr - 128, 40, 128).clamp(-40, 40) + 40
    return _pack_pair(yq, cbq, crq)


def egress9_planes(wplanes: torch.Tensor) -> torch.Tensor:
    """(..., 9, m) int8 word9 planes -> (..., 3, 2, m) uint8 planar RGB: the
    trit unpack, the dequantization with the C++ double-lround fix-ups and
    YCbCr -> RGB (include/io_image.hpp:94-124)."""
    yq, cbq, crq = _unpack_pair(wplanes)
    y = Q.dequant_y(yq).clamp(0, 255).to(torch.float32)
    cb = ((128 + Q.dequant_c(cbq - 40)).clamp(0, 255) - 128).to(torch.float32)
    cr = ((128 + Q.dequant_c(crq - 40)).clamp(0, 255) - 128).to(torch.float32)
    rgb = [_round_u8(v) for v in Q.rgb_rows(y, cb, cr)]
    return torch.stack(rgb, dim=-3).to(torch.uint8)


def ingest9(rgb: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Interleaved RGB (..., 3) uint8, pixels in raster order -> the word9
    words of its n pixels, written into ``out``, (ceil(n / 2), 9) int8:
    word j holds pixels 2j and 2j + 1.  An odd last pixel is paired with
    black, whose quant is the default pixel (0, 0, 0) that
    ``quant_to_words9`` pads with.  On a CUDA tensor K4 in one launch
    (``bridge_cuda.ingest``: ``out`` contiguous on the same device, else
    it raises); otherwise ``ingest9_ref``."""
    if rgb.device.type == "cuda":
        return bridge_cuda.ingest(rgb, out)
    return ingest9_ref(rgb, out)


def ingest9_ref(rgb: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``ingest9``'s plain twin, on any device: ``ingest9_planes`` between
    two copies, the pixels to float32 planes (3, 2, m), the word9 planes
    (9, m) to ``out``."""
    px = rgb.reshape(-1, 3)
    if px.shape[0] % 2:
        px = torch.cat([px, px.new_zeros((1, 3))])
    pairs = px.view(-1, 2, 3)
    x = torch.empty((3, 2, pairs.shape[0]), dtype=torch.float32,
                    device=rgb.device)
    x.copy_(pairs.permute(2, 1, 0))
    return out.copy_(ingest9_planes(x).T)


def egress9(wplanes: torch.Tensor) -> torch.Tensor:
    """(..., 9, m) int8 word9 planes (any strides) -> (..., m, 2, 3) uint8
    interleaved RGB: word w's two pixels in order, so that a frame's
    planes (n_sf, 9, words a superframe) give its pixels in raster order.
    On a CUDA tensor K5 in one launch, reading the planes where they lie
    (``bridge_cuda.egress``; raises on a tensor it does not take);
    otherwise ``egress9_ref``."""
    if wplanes.device.type == "cuda":
        return bridge_cuda.egress(wplanes)
    return egress9_ref(wplanes)


def egress9_ref(wplanes: torch.Tensor) -> torch.Tensor:
    """``egress9``'s plain twin, on any device: ``egress9_planes``, then one
    copy from (..., 3, 2, m)."""
    rgb = egress9_planes(wplanes)
    return rgb.movedim((-3, -1), (-1, -3)).contiguous()


# ---------------------------------------------------------------------------
# subword-validating API (src/ternary_image_codec_v6_min.cpp:104-155)
# ---------------------------------------------------------------------------


def encode_raw_pixels_to_words_subword(q: torch.Tensor, sub: SubwordMode,
                                       codec: str = "word13") -> torch.Tensor:
    if not isinstance(sub, SubwordMode):
        raise ValueError(f"invalid subword mode: {sub!r}")
    return quant_to_words13(q) if codec == "word13" else quant_to_words9(q)


def decode_raw_words_to_pixels_subword(words: torch.Tensor, sub: SubwordMode,
                                       codec: str = "word13",
                                       n_pixels=None) -> torch.Tensor:
    if not isinstance(sub, SubwordMode):
        raise ValueError(f"invalid subword mode: {sub!r}")
    if codec == "word13":
        return words13_to_quant(words)
    return words9_to_quant(words, n_pixels)
