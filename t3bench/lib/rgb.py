"""8-bit RGB frames of a configuration with a ``pixels`` block, and the
bytes the pixel bridges must move.

A frame is ``height x width x 3`` uint8, interleaved, uniform random
pixels drawn on the device with a ``torch.Generator`` seeded from (seed,
frame number), as ``traffic.make_frames`` draws RAW frames: a frame can
be made again after the window without keeping it.  The bridges do the
same work whatever the picture holds.
"""
from __future__ import annotations

import torch

from .traffic import MASK


def frame_size(cfg: dict):
    """(height, width) of one frame."""
    return cfg["frame"]["height"], cfg["frame"]["width"]


def make_frame(cfg: dict, seed: int, idx: int, device) -> torch.Tensor:
    """Frame ``idx`` of the run: (height, width, 3) uint8."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + idx) & MASK)
    return torch.randint(0, 256, frame_size(cfg) + (3,), generator=gen,
                         device=device, dtype=torch.uint8)


def bridge_bytes(height: int, width: int) -> int:
    """The least bytes both bridges move for one frame: the RGB (3 bytes a
    pixel) read once and the word9 words (9 bytes a word of 2 pixels)
    written once on the way in, and the words read once and the RGB
    written once on the way out."""
    return 2 * (3 * height * width + 9 * -(-height * width // 2))
