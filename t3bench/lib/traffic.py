"""The one traffic generator: frames and damage from a cell's parameters
and the run's seed.

A frame is ``width x height / px_per_word`` RAW words (9 symbols 0..26,
band 8 below 9 since trit 26 is never carried), zero-padded to whole
superframes, drawn on the device with a ``torch.Generator`` seeded from
(seed, frame number): a frame can be made again after the window without
keeping it.  Damage comes from the frozen ``damage`` model with a numpy
seed made from (seed, group).
"""
from __future__ import annotations

import torch

from . import damage

MASK = (1 << 63) - 1


def frame_shape(cfg: dict):
    """(RAW words, superframes, words a superframe) of one frame."""
    f = cfg["frame"]
    n_raw = f["width"] * f["height"] // f["px_per_word"]
    sf = cfg["superframe_words"]
    return n_raw, -(-n_raw // sf), sf


def make_frames(cfg: dict, seed: int, idxs, device) -> torch.Tensor:
    """Frames ``idxs`` of the run: (len(idxs), n_sf, sf, 9) int8."""
    n_raw, n_sf, sf = frame_shape(cfg)
    idxs = list(idxs)
    out = torch.zeros((len(idxs), n_sf * sf, 9), dtype=torch.int8,
                      device=device)
    gen = torch.Generator(device=device)
    for j, idx in enumerate(idxs):
        gen.manual_seed((seed * 1_000_003 + idx) & MASK)
        w = torch.randint(0, 27, (n_raw, 9), generator=gen, device=device,
                          dtype=torch.int8)
        w[:, 8] %= 9
        out[j, :n_raw] = w
    return out.view(len(idxs), n_sf, sf, 9)


def damage_events(params: dict, n_sf: int, total_words: int, frames: int,
                  seed: int, group: int):
    """The damage of one group of ``frames`` frames (``damage.damage``'s
    events), from the cell's ``damage`` parameters."""
    d = params["damage"]
    return damage.damage(n_sf, total_words, frames, D=d["D"], E=d["E"],
                         overcap=d["overcap"], hdr=d["hdr"],
                         seed=[seed & MASK, group])
