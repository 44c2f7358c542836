"""K4 and K5: the frame pixel bridges as hand-written CUDA kernels.

Replace no Pallas kernel: the JAX package left ``ingest9_planes`` and
``egress9_planes`` to XLA.  The kernels are csrc/bridge.cu; their plain
torch twins are ``wordcodec.ingest9_ref`` and ``wordcodec.egress9_ref``,
which they match bit for bit on any input (every RGB triple, every int8
word).  ``wordcodec.ingest9``/``egress9`` launch them for a CUDA tensor.

K5 reads one int32 table, built here from ``quant``'s arrays
(``host_consts``) and uploaded once a device: the number of luma and of
chroma fix-ups, then ``quant.Y_FIX_IN``, ``Y_FIX_OUT``, ``C_FIX_IN`` and
``C_FIX_OUT``, each padded to ``MAX_FIX`` entries.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..runtime import build
from . import quant as Q

MAX_FIX = 16


def host_consts() -> np.ndarray:
    """(2 + 4 * MAX_FIX,) int32: the fix-up table K5 reads (module
    docstring)."""
    arrays = (Q.Y_FIX_IN, Q.Y_FIX_OUT, Q.C_FIX_IN, Q.C_FIX_OUT)
    if max(len(a) for a in arrays) > MAX_FIX:
        raise ValueError(f"more than {MAX_FIX} fix-ups")
    t = np.zeros(2 + 4 * MAX_FIX, dtype=np.int32)
    t[:2] = len(Q.Y_FIX_IN), len(Q.C_FIX_IN)
    for i, a in enumerate(arrays):
        t[2 + i * MAX_FIX:][:len(a)] = a
    return t


@functools.cache
def _consts(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(host_consts(), device=device)


@functools.cache
def _lib():
    lib = build.load("bridge")
    lib.t3_bridge_ingest.restype = ctypes.c_int
    lib.t3_bridge_ingest.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.t3_bridge_egress.restype = ctypes.c_int
    lib.t3_bridge_egress.argtypes = [ctypes.c_void_p] \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3
    return lib


def _on_card(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")


def ingest(rgb: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K4: interleaved RGB (..., 3) uint8 on a CUDA device, pixels in raster
    order -> the word9 words of its n pixels in ``out``, (ceil(n / 2), 9)
    int8 and contiguous, in one launch; equal to ``wordcodec.ingest9_ref``.
    A strided input is made contiguous once.  Raises on a tensor the kernel
    does not take."""
    if rgb.dtype != torch.uint8 or out.dtype != torch.int8:
        raise TypeError(f"ingest needs uint8 RGB and int8 words, got "
                        f"{rgb.dtype} and {out.dtype}")
    if rgb.dim() == 0 or rgb.shape[-1] != 3:
        raise ValueError(f"ingest needs (..., 3) RGB, got {tuple(rgb.shape)}")
    n_px = rgb.numel() // 3
    if tuple(out.shape) != (-(-n_px // 2), 9) or not out.is_contiguous():
        raise ValueError(f"ingest needs contiguous ({-(-n_px // 2)}, 9) "
                         f"words, got {tuple(out.shape)}")
    _on_card(rgb, "ingest")
    if out.device != rgb.device:
        raise ValueError(f"ingest: words on {out.device}, RGB on {rgb.device}")
    if n_px == 0:
        return out
    rgb = rgb.contiguous()
    build.launch(_lib(), "t3_bridge_ingest", rgb.device, rgb.data_ptr(),
                 n_px, out.data_ptr(), counter="t3.ingest.k4")
    return out


def egress(wplanes: torch.Tensor) -> torch.Tensor:
    """K5: word9 planes (..., 9, m) int8 on a CUDA device, any strides ->
    interleaved RGB (..., m, 2, 3) uint8 in one launch; equal to
    ``wordcodec.egress9_ref``.  Planes of consecutive words are read where
    they lie, at any plane and superframe strides (the decode's); others
    are copied once.  Raises on a tensor the kernel does not take."""
    if wplanes.dtype != torch.int8:
        raise TypeError(f"egress needs int8 word9 planes, got {wplanes.dtype}")
    if wplanes.dim() < 2 or wplanes.shape[-2] != 9:
        raise ValueError(f"egress needs (..., 9, m) planes, got "
                         f"{tuple(wplanes.shape)}")
    _on_card(wplanes, "egress")
    lead, m = wplanes.shape[:-2], wplanes.shape[-1]
    out = torch.empty((*lead, m, 2, 3), dtype=torch.uint8,
                      device=wplanes.device)
    planes = wplanes.reshape(-1, 9, m)
    if out.numel() == 0:
        return out
    if planes.stride(-1) != 1:
        planes = planes.contiguous()
    build.launch(_lib(), "t3_bridge_egress", planes.device,
                 planes.data_ptr(), planes.shape[0], m, *planes.stride()[:2],
                 _consts(planes.device).data_ptr(), out.data_ptr(),
                 counter="t3.egress.k5")
    return out
