"""Plain reference of the pixel schema: 8-bit RGB frames as word9 RAW words.

Written from the rules of the reference's image bridge and RAW packer, in
plain torch, and importing nothing of the codec packages or of a kernel:

* colour (include/io_image.hpp:66-93): BT.601 in float32, each product
  and each sum rounded to float32 on its own in the C++ expression's
  order (left to right), then std::lround (half away from zero) and a
  clamp to 0..255:

      Y  =  0.299 R + 0.587 G + 0.114 B
      Cb = -0.168736 R - 0.331264 G + 0.5 B + 128
      Cr =  0.5 R - 0.418688 G - 0.081312 B + 128

  and back, from Y and the centred Cb - 128, Cr - 128:

      R = Y + 1.402 Cr,  G = Y - 0.344136 Cb - 0.714136 Cr,
      B = Y + 1.772 Cb;

* quantiser (:80-99) in float64, as the C++ computes it in double:
  Yq = clamp(lround(Y * (242.0 / 255.0)), 0, 242) and
  Cq = clamp(lround((C - 128) * (40.0 / 128.0)), -40, 40); its inverse
  (:94-124) Y = clamp(lround(Yq * (255.0 / 242.0)), 0, 255) and
  C = clamp(128 + lround(Cq * (128.0 / 40.0)), 0, 255), the ratio rounded
  to a double before the product;
* packing (old/include/ternary_image_codec_v6_min.hpp:693-747): 2 pixels
  a word, pixel 2j in trits 0..12 of word j and pixel 2j + 1 in trits
  13..25, each pixel Yq in 5 trits, Cbq + 40 in 4 and Crq + 40 in 4, least
  significant first, trit 26 the spare, zero; symbol s of a word is trits
  3s..3s+2 as t0 + 3 t1 + 9 t2.  An odd last pixel is paired with the
  default pixel, quant (0, 0, 0).  A frame's words fill superframes of
  ``superframe_words`` in order, the last one zero-padded.

std::lround of a float32 value is computed exactly in float64, where
x + 0.5 of a float32 x needs no rounding.  Departures from the C++: none
known.  ``egress`` takes words of symbols 0..26, as a decode returns them.

``ingest`` and ``egress`` take the precision of the rows (``rows``,
float32 by the rules) and of the quantiser (``quant``, float64 by the
rules): the cell's control computes them one precision lower, float16
rows and a float32 quantiser.
"""
from __future__ import annotations

import torch

Y_ROW = (0.299, 0.587, 0.114)
CB_ROW = (-0.168736, -0.331264, 0.5)
CR_ROW = (0.5, -0.418688, -0.081312)
Y_TRITS, C_TRITS = 5, 4
CHUNK = 1 << 22         # pixels a step, which bounds the temporaries


def _const(v: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype)


def lround(x: torch.Tensor) -> torch.Tensor:
    """std::lround of float values (half away from zero), exact: int64."""
    x = x.to(torch.float64)
    return torch.where(x < 0, -torch.floor(-x + 0.5),
                       torch.floor(x + 0.5)).to(torch.int64)


def _row(c, a: torch.Tensor, b: torch.Tensor, d: torch.Tensor):
    """c0 a + c1 b + c2 d in the dtype of a, b and d, left to right, one
    rounding a step."""
    return (_const(c[0], a.dtype) * a + _const(c[1], a.dtype) * b
            + _const(c[2], a.dtype) * d)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return lround(x).clamp(0, 255)


def rgb_to_ycbcr(px: torch.Tensor, rows=torch.float32) -> torch.Tensor:
    """(n, 3) RGB 0..255 -> (n, 3) int64 Y, Cb, Cr; rows in ``rows``."""
    r, g, b = px.to(rows).unbind(-1)
    c128 = _const(128.0, rows)
    return torch.stack([_u8(_row(Y_ROW, r, g, b)),
                        _u8(_row(CB_ROW, r, g, b) + c128),
                        _u8(_row(CR_ROW, r, g, b) + c128)], -1)


def ycbcr_to_rgb(ycc: torch.Tensor, rows=torch.float32) -> torch.Tensor:
    """(n, 3) Y, Cb, Cr 0..255 -> (n, 3) int64 R, G, B; rows in ``rows``."""
    y, cb, cr = ycc.to(rows).unbind(-1)
    c128 = _const(128.0, rows)
    cb, cr = cb - c128, cr - c128
    r = y + _const(1.402, rows) * cr
    g = y - _const(0.344136, rows) * cb - _const(0.714136, rows) * cr
    b = y + _const(1.772, rows) * cb
    return torch.stack([_u8(r), _u8(g), _u8(b)], -1)


def quantize(ycc: torch.Tensor, quant=torch.float64) -> torch.Tensor:
    """(n, 3) Y, Cb, Cr -> (n, 3) int64 Yq, Cbq, Crq, in ``quant``."""
    x = ycc.to(quant)
    yq = lround(x[:, 0] * _const(242.0 / 255.0, quant)).clamp(0, 242)
    cq = lround((x[:, 1:] - _const(128.0, quant))
                * _const(40.0 / 128.0, quant)).clamp(-40, 40)
    return torch.cat([yq[:, None], cq], -1)


def dequantize(q: torch.Tensor, quant=torch.float64) -> torch.Tensor:
    """(n, 3) Yq, Cbq, Crq -> (n, 3) int64 Y, Cb, Cr, in ``quant``."""
    x = q.to(quant)
    y = lround(x[:, 0] * _const(255.0 / 242.0, quant)).clamp(0, 255)
    c = (128 + lround(x[:, 1:] * _const(128.0 / 40.0, quant))).clamp(0, 255)
    return torch.cat([y[:, None], c], -1)


def _trits(v: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) base-3 digits of v >= 0, least significant first."""
    p = 3 ** torch.arange(n, device=v.device)
    return torch.div(v[..., None], p, rounding_mode="floor") % 3


def _value(t: torch.Tensor) -> torch.Tensor:
    """The integer of base-3 digits (..., n), least significant first."""
    p = 3 ** torch.arange(t.shape[-1], device=t.device)
    return (t * p).sum(-1)


def _pack(q: torch.Tensor) -> torch.Tensor:
    """(2m, 3) quant pixels -> (m, 9) int8 words."""
    t = torch.cat([_trits(q[:, 0], Y_TRITS), _trits(q[:, 1] + 40, C_TRITS),
                   _trits(q[:, 2] + 40, C_TRITS)], -1)        # (2m, 13)
    t = torch.nn.functional.pad(t.reshape(-1, 26), (0, 1))    # (m, 27)
    return _value(t.reshape(-1, 9, 3)).to(torch.int8)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """(m, 9) words -> (2m, 3) int64 quant pixels."""
    t = _trits(words.to(torch.int64), 3).reshape(-1, 27)[:, :26]
    t = t.reshape(-1, 13)                                     # a pixel a row
    return torch.stack([_value(t[:, :5]), _value(t[:, 5:9]) - 40,
                        _value(t[:, 9:13]) - 40], -1)


def ingest(rgb: torch.Tensor, rows=torch.float32,
           quant=torch.float64) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (ceil(H W / 2), 9) int8 RAW words."""
    px = rgb.reshape(-1, 3)
    out = []
    for part in px.split(CHUNK):
        out.append(quantize(rgb_to_ycbcr(part, rows), quant))
    q = torch.cat(out)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1, 3))])
    return torch.cat([_pack(p) for p in q.split(CHUNK)])


def egress(words: torch.Tensor, height: int, width: int,
           rows=torch.float32, quant=torch.float64) -> torch.Tensor:
    """RAW words (n, 9), n >= ceil(H W / 2), symbols 0..26 -> (H, W, 3)
    uint8 RGB of the first H W pixels; precisions as for ``ingest``."""
    n_px = height * width
    words = words[:-(-n_px // 2)]
    out = []
    for part in words.split(CHUNK // 2):
        out.append(ycbcr_to_rgb(dequantize(_unpack(part), quant), rows))
    return torch.cat(out)[:n_px].to(torch.uint8).reshape(height, width, 3)


def superframes(words: torch.Tensor, superframe_words: int) -> torch.Tensor:
    """RAW words (n, 9) -> (n_sf, superframe_words, 9), the last
    superframe zero-padded."""
    n = words.shape[0]
    pad = -n % superframe_words
    words = torch.nn.functional.pad(words, (0, 0, 0, pad))
    return words.view(-1, superframe_words, 9)


def words(planes: torch.Tensor, superframe_words: int) -> torch.Tensor:
    """RAW planes (n_sf, 9, n_out) of a decode -> the words (n_sf *
    superframe_words, 9) they hold, in stream order."""
    return planes[:, :, :superframe_words].transpose(1, 2) \
        .reshape(-1, planes.shape[1])
