"""Image file <-> RAW word bridge of the PyTorch port.

The JAX package's io/image.py: PNG/JPG load and save through PIL on the
host; on the device, NN resize to the subword mode's standard resolution,
the centred blit into the S27 canvas, quantization and the word codec
(ops/quant.py, ops/wordcodec.py), and the mirror on decode.

Flow parity (include/io_image.hpp:238-337): encode resizes to the standard
resolution; a centred mode other than S27 blits into the 8K canvas and
encodes the full canvas, anything else encodes at the target size.
Decode takes the exact size directly, centre-extracts a full S27 frame,
and otherwise takes or pads to w * h pixels (best effort).
"""
from __future__ import annotations

import numpy as np
import torch

from ..codec import resolve_device
from ..config import SubwordMode, std_res_for
from ..ops import quant as Q
from ..ops import wordcodec as WC


def load_image_rgb8(path: str) -> np.ndarray:
    """-> (h, w, 3) uint8 on the host."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert("RGB"), dtype=np.uint8)


def host_rgb(rgb) -> np.ndarray:
    """An (h, w, 3) image as a host uint8 array (a tensor comes off its
    device)."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.cpu().numpy()
    return np.asarray(rgb, dtype=np.uint8)


def save_image_png(path: str, rgb) -> None:
    from PIL import Image
    Image.fromarray(host_rgb(rgb), "RGB").save(path, "PNG")


def save_image_jpg(path: str, rgb, quality: int = 90) -> None:
    from PIL import Image
    Image.fromarray(host_rgb(rgb), "RGB").save(path, "JPEG", quality=quality)


def rgb_to_words(rgb, sub: SubwordMode, centered: bool,
                 codec: str = "word13", device=None):
    """(h, w, 3) uint8 -> (words, (enc_w, enc_h)): the words on ``device``
    (default the current CUDA device; the input moves there) and the size
    actually encoded.  word13 words are (n,) int32, word9 (ceil(n/2), 9)
    int8."""
    rgb = torch.as_tensor(rgb).to(resolve_device(device))
    tw, th = std_res_for(sub)
    if rgb.shape[0] != th or rgb.shape[1] != tw:
        rgb = Q.resize_nn(rgb, th, tw)
    if centered and sub != SubwordMode.S27:
        enc_w, enc_h = std_res_for(SubwordMode.S27)
        rgb = Q.blit_center(rgb, enc_h, enc_w)
    else:
        enc_w, enc_h = tw, th
    q = Q.rgb_to_quant(rgb).reshape(-1, 3)
    return WC.encode_raw_pixels_to_words_subword(q, sub, codec=codec), \
        (enc_w, enc_h)


def words_to_rgb(words, sub: SubwordMode, w: int, h: int,
                 codec: str = "word13", device=None) -> torch.Tensor:
    """Words -> (h, w, 3) uint8 RGB on ``device`` (as for ``rgb_to_words``)."""
    words = torch.as_tensor(words).to(resolve_device(device))
    q = WC.decode_raw_words_to_pixels_subword(words, sub, codec=codec)
    bw, bh = std_res_for(SubwordMode.S27)
    n = int(q.shape[0])
    if n == w * h:
        return Q.quant_to_rgb(q).reshape(h, w, 3)
    if n == bw * bh and sub != SubwordMode.S27:
        tw, th = std_res_for(sub)
        sub_q = Q.extract_center(q.reshape(bh, bw, 3), th, tw)
        rgb = Q.quant_to_rgb(sub_q.reshape(-1, 3)).reshape(th, tw, 3)
        return rgb if (th, tw) == (h, w) else Q.resize_nn(rgb, h, w)
    # best effort: take or zero-pad to w * h pixels
    m = w * h
    qf = torch.nn.functional.pad(q.reshape(-1, 3), (0, 0, 0, max(0, m - n)))
    return Q.quant_to_rgb(qf[:m]).reshape(h, w, 3)


def image_to_words_subword(path: str, sub: SubwordMode, centered: bool,
                           codec: str = "word13", device=None):
    """File -> (words on ``device``, (enc_w, enc_h))
    (include/io_image.hpp:238-300)."""
    device = resolve_device(device)
    return rgb_to_words(load_image_rgb8(path), sub, centered, codec, device)


def words_to_image_subword(words, sub: SubwordMode, w: int, h: int,
                           out_path_png: str, codec: str = "word13",
                           device=None) -> None:
    """Words -> PNG file, decoded on ``device``
    (include/io_image.hpp:304-337)."""
    save_image_png(out_path_png, words_to_rgb(words, sub, w, h, codec, device))
