"""Optional image-format adapters: HEIF / AVIF / TIFF / EXR <-> words.

The JAX package's io/formats.py: the file side is host code (the optional
libraries are imported when a file is read or written); the words bridge
is io/image.py's, on the device.

Runtime analog of the reference's compile-gated adapters
(include/io_heif_avif.hpp:27-48 + src/io_heif_avif.cpp:20-488,
include/io_tiff_exr.hpp:25-43 + src/io_tiff_exr.cpp:19-347): each format is
probed at runtime; unavailable formats raise FormatUnavailable (the analog of
the reference stubs returning false, src/io_heif_avif.cpp:432-487).

All adapters share one generic words bridge (the reference duplicates the
same encode/decode path per format — src/io_heif_avif.cpp:344-425,
src/io_tiff_exr.cpp:214-293; here it is a single pair of functions).
"""
from __future__ import annotations

import importlib
from typing import Tuple

import numpy as np
import torch

from ..codec import resolve_device
from ..config import SubwordMode
from . import image as I


class FormatUnavailable(RuntimeError):
    pass


def _has(mod: str) -> bool:
    try:
        importlib.import_module(mod)
        return True
    except ImportError:
        return False


def format_available(fmt: str) -> bool:
    """fmt in {'heif', 'avif', 'tiff', 'exr'}."""
    fmt = fmt.lower()
    if fmt in ("heif", "avif"):
        return _has("pillow_heif")
    if fmt == "tiff":
        return _has("PIL")
    if fmt == "exr":
        return _has("OpenEXR") or _has("imageio")
    return False


# -- loading ------------------------------------------------------------------


def _load_heif_avif(path: str) -> np.ndarray:
    if not _has("pillow_heif"):
        raise FormatUnavailable(
            "HEIF/AVIF support requires pillow-heif (reference gates on "
            "TERNARY_USE_LIBHEIF/LIBAVIF the same way)")
    import pillow_heif
    pillow_heif.register_heif_opener()
    return I.load_image_rgb8(path)


def _load_tiff(path: str) -> np.ndarray:
    return I.load_image_rgb8(path)  # PIL handles scanline RGB8 TIFF


def _exr_planes_openexr(path: str) -> np.ndarray:
    """Read float RGB planes via the OpenEXR python bindings (the analog of
    the reference's dedicated EXR backends: TinyEXR in src/io_tiff_exr.cpp:
    103-131 and the Imf RgbaInputFile path in
    old/src/io_image_tiff_exr.cpp:21-29).  Grayscale 'Y' files replicate to
    RGB like the reference's Rgba reader does."""
    import OpenEXR
    if hasattr(OpenEXR, "InputFile"):       # classic bindings (1.x-3.x)
        import Imath
        f = OpenEXR.InputFile(path)
        hdr = f.header()
        dw = hdr["dataWindow"]
        w = dw.max.x - dw.min.x + 1
        h = dw.max.y - dw.min.y + 1
        names = set(hdr["channels"].keys())
        pt = Imath.PixelType(Imath.PixelType.FLOAT)

        def chan(c):
            return np.frombuffer(f.channel(c, pt),
                                 dtype=np.float32).reshape(h, w)

        if {"R", "G", "B"} <= names:
            planes = [chan(c) for c in ("R", "G", "B")]
        elif "Y" in names:
            planes = [chan("Y")] * 3
        else:
            raise FormatUnavailable(f"EXR: no RGB or Y channels in {path}")
        return np.stack(planes, axis=-1).astype(np.float64)
    # OpenEXR >= 3.2 "File" API (no InputFile symbol)
    part = OpenEXR.File(path).parts[0]
    ch = {name: c.pixels for name, c in part.channels.items()}
    if "RGB" in ch:
        return np.asarray(ch["RGB"], dtype=np.float64)[..., :3]
    if {"R", "G", "B"} <= ch.keys():
        return np.stack([np.asarray(ch[c], dtype=np.float64)
                         for c in ("R", "G", "B")], axis=-1)
    if "Y" in ch:
        y = np.asarray(ch["Y"], dtype=np.float64)
        return np.stack([y] * 3, axis=-1)
    raise FormatUnavailable(f"EXR: no RGB or Y channels in {path}")


def _load_exr(path: str) -> np.ndarray:
    """Float EXR -> u8 RGB with the reference's TinyEXR-style mapping:
    clamp(lround(v*255), 0, 255) per channel (src/io_tiff_exr.cpp:124-127;
    the old tree's round(clamp(v,0,1)*255) at old/src/io_image_tiff_exr.cpp:27
    yields identical bytes).  OpenEXR bindings are preferred when importable;
    imageio is the fallback reader."""
    if _has("OpenEXR"):
        f = _exr_planes_openexr(path)
    elif _has("imageio"):
        import imageio.v3 as iio
        f = np.asarray(iio.imread(path)).astype(np.float64)
    else:
        raise FormatUnavailable("EXR support requires OpenEXR or imageio")
    if f.ndim == 2:
        f = np.stack([f] * 3, axis=-1)
    f = f[..., :3]
    from ..ops.quant import np_lround
    return np.clip(np_lround(f * 255.0), 0, 255).astype(np.uint8)


_LOADERS = {"heif": _load_heif_avif, "avif": _load_heif_avif,
            "tiff": _load_tiff, "exr": _load_exr}


def _save_exr_openexr(path: str, f32: np.ndarray) -> None:
    """Write float32 RGB via OpenEXR bindings (mirrors the reference's
    SaveEXR-as-FP32 call, src/io_tiff_exr.cpp:131-149)."""
    import OpenEXR
    h, w = f32.shape[:2]
    planes = [np.ascontiguousarray(f32[..., i], dtype=np.float32)
              for i in range(3)]
    if hasattr(OpenEXR, "OutputFile"):      # classic bindings
        import Imath
        hdr = OpenEXR.Header(w, h)
        ch = Imath.Channel(Imath.PixelType(Imath.PixelType.FLOAT))
        hdr["channels"] = {c: ch for c in ("R", "G", "B")}
        out = OpenEXR.OutputFile(path, hdr)
        try:
            out.writePixels({c: p.tobytes()
                             for c, p in zip("RGB", planes)})
        finally:
            out.close()
        return
    # OpenEXR >= 3.2 "File" API: File(header, channels) with an
    # interleaved (h, w, 3) "RGB" channel array
    header = {"compression": OpenEXR.ZIP_COMPRESSION,
              "type": OpenEXR.scanlineimage}
    channels = {"RGB": np.ascontiguousarray(f32[..., :3],
                                            dtype=np.float32)}
    OpenEXR.File(header, channels).write(path)


def _save(fmt: str, path: str, rgb: np.ndarray) -> None:
    from PIL import Image
    fmt = fmt.lower()
    rgb = I.host_rgb(rgb)
    im = Image.fromarray(rgb, "RGB")
    if fmt in ("heif", "avif"):
        if not _has("pillow_heif"):
            raise FormatUnavailable("HEIF/AVIF save requires pillow-heif")
        import pillow_heif
        pillow_heif.register_heif_opener()
        im.save(path, format="AVIF" if fmt == "avif" else "HEIF")
    elif fmt == "tiff":
        im.save(path, format="TIFF")
    elif fmt == "exr":
        f32 = np.asarray(rgb, np.float32) / 255.0
        if _has("OpenEXR"):
            _save_exr_openexr(path, f32)
        elif _has("imageio"):
            import imageio.v3 as iio
            iio.imwrite(path, f32)
        else:
            raise FormatUnavailable("EXR save requires OpenEXR or imageio")
    else:
        raise FormatUnavailable(f"unknown format: {fmt}")


# -- generic words bridge (one implementation for every format) ---------------


def image_file_to_words(path: str, fmt: str, sub: SubwordMode,
                        centered: bool, codec: str = "word13", device=None
                        ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """{heif,avif,tiff,exr}_to_words equivalents
    (include/io_heif_avif.hpp:27-48, io_tiff_exr.hpp:25-43): the words on
    ``device`` (default the current CUDA device) and the encoded size."""
    device = resolve_device(device)
    loader = _LOADERS.get(fmt.lower())
    if loader is None:
        raise FormatUnavailable(f"unknown format: {fmt}")
    return I.rgb_to_words(loader(path), sub, centered, codec=codec,
                          device=device)


def words_to_image_file(words, fmt: str, sub: SubwordMode, w: int, h: int,
                        path: str, codec: str = "word13", device=None) -> None:
    """words_to_{heif,avif,tiff,exr} equivalents, decoded on ``device``."""
    _save(fmt, path, I.words_to_rgb(words, sub, w, h, codec=codec,
                                    device=device))
