"""Main-path superframe encode: RAW words -> wire planes (9, 6 + H).

The counterpart of the JAX package's ``pipeline_v3.encode_fn_v3`` for the
residue-group configs.  Per superframe of n RAW words:

* the 26 useful trits of each word form the symbol stream (trit 26 is
  dropped); stream symbol i is digits 3i..3i+2 of that trit stream;
* symbols go round-robin over the 9 bands (band i % 9, column i // 9),
  and band b cuts its column into RS(26, k_b) data blocks;
* parity per block is one GF(3)-linear map of the data digits (the parity
  columns of the reference's ``G2``);
* every body cell is scrambled (the offset added to each digit), packed
  to a symbol sum(3^d * digit), and the 6 constant header words go first.

All of it is index gathers built once per layout (``pipeline.derive_tables``)
and one mod-3 product per k-group.  The reference never wrote this step as
a TPU kernel, so it stays plain torch here.
"""
from __future__ import annotations

import torch

from ..config import NUM_BANDS
from . import rs
from .gf27 import mod3
from .pipeline import k_groups


def encode_superframes(chunks: torch.Tensor, layout, T: dict) -> torch.Tensor:
    """RAW words (n, superframe_words, 9) int8 -> wire planes
    (n, 9, 6 + H) int8, with ``T`` the codec's tables."""
    geom = layout.geom
    n = chunks.shape[0]
    nblk, H = geom.blocks[0], geom.H
    flat = torch.nn.functional.pad(chunks.reshape(n, -1), (0, 1))
    cw = torch.empty((n, NUM_BANDS, nblk, rs.N, 3), dtype=torch.int8,
                     device=chunks.device)
    for k, bands in k_groups(geom).items():
        src, pw = T[f"enc_src{k}"], T[f"enc_pow{k}"]
        g, r = len(bands), rs.N - k
        s = flat[:, src.reshape(-1)].to(torch.int16)
        d = mod3(torch.div(s, pw.reshape(-1), rounding_mode="floor")) \
            .to(torch.int8).reshape(n, g, nblk, k, 3)
        par = torch.matmul(d.reshape(-1, 3 * k).to(torch.float32),
                           T[f"par{k}"].to(torch.float32))
        par = mod3(par.to(torch.int32)).to(torch.int8).reshape(n, g, nblk, r, 3)
        cw[:, torch.as_tensor(bands, device=chunks.device)] = \
            torch.cat([d, par], dim=3)
    off = T["off_enc"].reshape(NUM_BANDS, 3, nblk, rs.N).permute(0, 2, 3, 1)
    scr = mod3(cw.to(torch.int16) + off)
    body = (scr[..., 0] + 3 * scr[..., 1] + 9 * scr[..., 2]) \
        .to(torch.int8).reshape(n, NUM_BANDS, H)
    hdr = T["header_words"].T.expand(n, NUM_BANDS, -1)
    return torch.cat([hdr, body], dim=2)
