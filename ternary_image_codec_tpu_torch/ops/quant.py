"""BT.601 colour conversion and quantization with the C++ rounding, in torch.

The JAX package's ops/quant.py.  The reference rounds with std::lround
(half away from zero, include/io_image.hpp:66-99).  Quantization is exact
integer arithmetic:

    lround(n * p / q) == sign(n) * ((2 p |n| + q) // (2 q))

with the C++ double-semantics fix-ups on dequantization
(``_double_semantics_fixups``).  The RGB <-> YCbCr rows are float32, as in
the C++: each product and each sum is one torch operation, rounded to
float32 on its own, in the reference's order, with float32 constants.
Never fuse them: ``torch.addcmul``, ``alpha=``, ``torch.lerp`` or
``torch.compile`` may contract a product and a sum into one FMA on the
card, which moves ties.  The hand-written frame bridges K4/K5
(csrc/bridge.cu) keep each rounding by writing every product and sum as
one ``__fmul_rn``, ``__fadd_rn`` or ``__fsub_rn``, which the compiler never
contracts.  tests/test_torch_bridge.py holds these functions against the
C++ golden file, chip_smoke.py the card's run against the CPU's and
K4/K5 against their twins.

Functions take tensors and compute on the tensor's device.

Reference parity: include/io_image.hpp:66-99 (quantize/dequantize),
:102-124 (NN resize), :125-140 (center blit), :215-235 (center extract).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.cache
def f32(v: float) -> torch.Tensor:
    """The float32 constant v as a 0-d CPU tensor, which torch takes as a
    scalar operand beside tensors on any device (no copy to the card)."""
    return torch.tensor(v, dtype=torch.float32)


def np_lround(x) -> np.ndarray:
    x = np.asarray(x)
    return np.where(x < 0, -np.floor(-x + 0.5), np.floor(x + 0.5)) \
        .astype(np.int64)


def lround_ratio(n: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Exact lround(n * p / q) of integers n (q > 0), any sign; int32."""
    n = n.to(torch.int32)
    mag = torch.div(2 * p * n.abs() + q, 2 * q, rounding_mode="floor")
    return torch.where(n < 0, -mag, mag)


def lround_f32(x: torch.Tensor) -> torch.Tensor:
    """std::lround of float32 values (half away from zero), int32."""
    half = f32(0.5)
    return torch.where(x < 0, -torch.floor(-x + half),
                       torch.floor(x + half)).to(torch.int32)


# ---------------------------------------------------------------------------
# RGB <-> YCbCr (BT.601, float32 + lround, include/io_image.hpp:66-93)
# ---------------------------------------------------------------------------


def ycbcr_rows(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """float32 Y, Cb, Cr of float32 R, G, B, one rounding per operation in
    the reference's order."""
    y = f32(0.299) * r + f32(0.587) * g + f32(0.114) * b
    cb = f32(-0.168736) * r - f32(0.331264) * g + f32(0.5) * b + f32(128.0)
    cr = f32(0.5) * r - f32(0.418688) * g - f32(0.081312) * b + f32(128.0)
    return y, cb, cr


def rgb_rows(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor):
    """float32 R, G, B of float32 Y and centred Cb, Cr (Cb - 128, Cr - 128),
    one rounding per operation in the reference's order."""
    r = y + f32(1.402) * cr
    g = y - f32(0.344136) * cb - f32(0.714136) * cr
    b = y + f32(1.772) * cb
    return r, g, b


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (..., 3) uint8 YCbCr."""
    x = rgb.to(torch.float32)
    out = torch.stack(ycbcr_rows(x[..., 0], x[..., 1], x[..., 2]), dim=-1)
    return lround_f32(out).clamp(0, 255).to(torch.uint8)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 YCbCr -> (..., 3) uint8 RGB."""
    x = ycc.to(torch.float32)
    c128 = f32(128.0)
    out = torch.stack(rgb_rows(x[..., 0], x[..., 1] - c128, x[..., 2] - c128),
                      dim=-1)
    return lround_f32(out).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# quantization (integer-exact lround, include/io_image.hpp:80-99)
# ---------------------------------------------------------------------------


def quantize_ycbcr(ycc: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 YCbCr -> (..., 3) int32 quant [Yq, Cbq, Crq]:
    Yq = clamp(lround(Y*242/255), 0, 242), Cbq/Crq = clamp(lround((C-128)
    *40/128), -40, 40)."""
    x = ycc.to(torch.int32)
    yq = lround_ratio(x[..., 0], 242, 255).clamp(0, 242)
    cbq = lround_ratio(x[..., 1] - 128, 40, 128).clamp(-40, 40)
    crq = lround_ratio(x[..., 2] - 128, 40, 128).clamp(-40, 40)
    return torch.stack([yq, cbq, crq], dim=-1)


def _double_semantics_fixups(p: int, q: int, lo: int, hi: int):
    """(inputs, outputs): the n in [lo, hi] where the C++
    ``lround(n * (double)(p / q))`` differs from the exact lround(n p / q),
    and the C++ result there.  The ratio is rounded to a double first
    (include/io_image.hpp:94-99), so an exact tie can fall to the other
    side: 121 * (255.0 / 242.0) = 127.4999... gives 127 where the exact
    127.5 gives 128."""
    n = np.arange(lo, hi + 1, dtype=np.int64)
    mag = (2 * p * np.abs(n) + q) // (2 * q)
    exact = np.where(n < 0, -mag, mag)
    dbl = np_lround(n.astype(np.float64) * (np.float64(p) / np.float64(q)))
    differ = exact != dbl
    return n[differ], dbl[differ]


Y_FIX_IN, Y_FIX_OUT = _double_semantics_fixups(255, 242, 0, 242)
C_FIX_IN, C_FIX_OUT = _double_semantics_fixups(128, 40, -40, 40)


def _fixup(v: torch.Tensor, n: torch.Tensor, fix_in, fix_out) -> torch.Tensor:
    for a, b in zip(fix_in.tolist(), fix_out.tolist()):
        v = torch.where(n == a, b, v)
    return v


def dequant_y(yq: torch.Tensor) -> torch.Tensor:
    """C++ dequantized luma lround(Yq * (double)(255/242)), int32, unclamped."""
    return _fixup(lround_ratio(yq, 255, 242), yq, Y_FIX_IN, Y_FIX_OUT)


def dequant_c(cq: torch.Tensor) -> torch.Tensor:
    """C++ dequantized chroma offset lround(Cq * (double)(128/40)), int32,
    unclamped and not yet re-centred on 128."""
    return _fixup(lround_ratio(cq, 128, 40), cq, C_FIX_IN, C_FIX_OUT)


def dequantize_ycbcr(q: torch.Tensor) -> torch.Tensor:
    """(..., 3) quant -> (..., 3) uint8 YCbCr (C++ double-lround semantics)."""
    q = q.to(torch.int32)
    y = dequant_y(q[..., 0]).clamp(0, 255)
    cb = (128 + dequant_c(q[..., 1])).clamp(0, 255)
    cr = (128 + dequant_c(q[..., 2])).clamp(0, 255)
    return torch.stack([y, cb, cr], dim=-1).to(torch.uint8)


def rgb_to_quant(rgb: torch.Tensor) -> torch.Tensor:
    """The ingest bridge: (..., 3) uint8 RGB -> (..., 3) int32 quant."""
    return quantize_ycbcr(rgb_to_ycbcr(rgb))


def quant_to_rgb(q: torch.Tensor) -> torch.Tensor:
    return ycbcr_to_rgb(dequantize_ycbcr(q))


# ---------------------------------------------------------------------------
# image geometry (NN resize, center blit, center extract)
# ---------------------------------------------------------------------------


def resize_nn(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """Nearest-neighbour resize by the C++ centre-sample rule
    src_i = clamp(int((i + 0.5) * src / dst), 0, src - 1), computed
    exactly as ((2i + 1) * src) // (2 * dst)."""
    sh, sw = img.shape[0], img.shape[1]
    idx = lambda n, s: (((2 * torch.arange(n, device=img.device) + 1) * s)
                        // (2 * n)).clamp(0, s - 1)
    return img[idx(dst_h, sh)][:, idx(dst_w, sw)]


def blit_center(img: torch.Tensor, canvas_h: int, canvas_w: int,
                fill=0) -> torch.Tensor:
    """img centred in a ``fill`` canvas (include/io_image.hpp:125-140)."""
    h, w = img.shape[0], img.shape[1]
    y0 = max(0, (canvas_h - h) // 2)
    x0 = max(0, (canvas_w - w) // 2)
    canvas = torch.full((canvas_h, canvas_w) + tuple(img.shape[2:]), fill,
                        dtype=img.dtype, device=img.device)
    canvas[y0:y0 + h, x0:x0 + w] = img[:canvas_h - y0, :canvas_w - x0]
    return canvas


def extract_center(img: torch.Tensor, sub_h: int, sub_w: int) -> torch.Tensor:
    """Centred crop (include/io_image.hpp:215-235)."""
    h, w = img.shape[0], img.shape[1]
    y0 = max(0, (h - sub_h) // 2)
    x0 = max(0, (w - sub_w) // 2)
    return img[y0:y0 + sub_h, x0:x0 + sub_w]


def pad_even(w: int) -> int:
    return w if w % 2 == 0 else w + 1
