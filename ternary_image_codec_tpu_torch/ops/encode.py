"""Superframe encode: RAW words -> wire planes (9, 6 + H).

The counterpart of the JAX package's encoder (``_encode_parts_pm``,
ops/pipeline.py:533-688, and ``pipeline_v3.encode_fn_v3``).  Per
superframe of n RAW words:

* the 26 useful trits of each word form the symbol stream (trit 26 is
  dropped); stream symbol i is digits 3i..3i+2 of that trit stream;
* under P5 the stream is interleaved (its permutation folded into the
  gather tables); symbols go round-robin over the 9 bands (band i % 9,
  column i // 9), and band b cuts its column into RS(26, k_b) data blocks;
* parity per block is one GF(3)-linear map of the data digits (the parity
  columns of the reference's ``G2``), per group of bands (``k_groups``:
  the uniform bands of one k, the beacon band on its own);
* a uniform band's codewords fill its row from the top, the beacon band's
  run down its payload rows; cells past the last whole codeword hold zero
  data; every cell is scrambled (the offset added to each digit) except
  the beacon cells, which carry the beacon symbol as it is; cells pack to
  a symbol sum(3^d * digit), and the 6 constant header words go first.

``encode_superframes`` takes one of two routes, fixed by the tensor's
device: on a CUDA tensor K3 (csrc/encode.cu via ``enc_cuda.encode``), one
launch for every superframe of the call, or a raise; on the CPU the plain
torch twin ``encode_superframes_ref``: index gathers built once per
layout (``pipeline.derive_tables``) and one mod-3 product per group.  K3
matches the twin bit for bit; the twin runs on any device, so the card
can hold K3 to it.  ``encode_rows`` (one superframe's rows, for the
mesh's row split) always runs the twin's steps.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import NUM_BANDS
from . import enc_cuda, rs, scramble
from .gf27 import mod3, np_sym_to_dig
from .pipeline import (_beacon_payload_rows, _beacon_rows, _encode_gather,
                       k_groups, parity_map)


def group_codewords(flat: torch.Tensor, src: torch.Tensor, pw: torch.Tensor,
                    par: torch.Tensor, k: int) -> torch.Tensor:
    """The codewords of one group: flat RAW symbols (n, m + 1) (a zero slot
    last), the gather ``src``/``pw`` (g, nblk, k, 3) and the parity map
    ``par`` (3k, 3(26-k)) -> codeword digits (n, g, nblk * 26, 3) int8."""
    n = flat.shape[0]
    g, nblk = src.shape[:2]
    s = flat[:, src.reshape(-1)].to(torch.int16)
    d = mod3(torch.div(s, pw.reshape(-1), rounding_mode="floor")) \
        .to(torch.int8).reshape(n, g, nblk, k, 3)
    p = torch.matmul(d.reshape(-1, 3 * k).to(torch.float32),
                     par.to(torch.float32))
    p = mod3(p.to(torch.int32)).to(torch.int8) \
        .reshape(n, g, nblk, rs.N - k, 3)
    return torch.cat([d, p], dim=3).reshape(n, g, nblk * rs.N, 3)


def scramble_pack(grid: torch.Tensor, off: torch.Tensor, beacon,
                  bc_rows: torch.Tensor, bc_sym: torch.Tensor) -> torch.Tensor:
    """Digit grid (n, 9, R, 3) and its scramble offsets (27, R) -> wire
    rows (n, 9, R) int8: every cell scrambled, then the beacon cells
    ``bc_rows`` of the beacon band set to the beacon symbol's digits."""
    R = grid.shape[2]
    scr = mod3(grid.to(torch.int16) + off.reshape(NUM_BANDS, 3, R)
               .transpose(1, 2))
    if beacon.enabled:
        scr[:, beacon.band_slot, bc_rows] = bc_sym.to(torch.int16)
    return (scr[..., 0] + 3 * scr[..., 1] + 9 * scr[..., 2]).to(torch.int8)


def encode_superframes(chunks: torch.Tensor, layout, T: dict) -> torch.Tensor:
    """RAW words (n, n_raw_words, 9) int8 -> wire planes
    (n, 9, 6 + H) int8, with ``T`` the codec's tables: K3 on a CUDA
    tensor (any strides), the plain twin on the CPU."""
    if chunks.device.type == "cuda":
        return enc_cuda.encode(chunks, layout)
    return encode_superframes_ref(chunks, layout, T)


def encode_superframes_ref(chunks: torch.Tensor, layout, T: dict
                           ) -> torch.Tensor:
    """Plain torch twin of K3 on any device: RAW words (n, n_raw_words, 9)
    -> wire planes (n, 9, 6 + H) int8, ``T`` the codec's tables on the
    same device."""
    geom, beacon = layout.geom, layout.cfg.beacon
    n, H = chunks.shape[0], geom.H
    dev = chunks.device
    flat = torch.nn.functional.pad(chunks.reshape(n, -1), (0, 1))
    grid = torch.zeros((n, NUM_BANDS, H, 3), dtype=torch.int8, device=dev)
    for grp in k_groups(geom, beacon):
        cw = group_codewords(flat, T[f"enc_src_{grp.name}"],
                             T[f"enc_pow_{grp.name}"], T[f"par{grp.k}"], grp.k)
        if grp.beacon:
            grid[:, grp.bands[0], T["bc_pay"]] = cw[:, 0]
        else:
            grid[:, torch.as_tensor(grp.bands, device=dev),
                 :grp.nblk * rs.N] = cw
    body = scramble_pack(grid, T["off_enc"], beacon, T.get("bc_rows"),
                         T.get("bc_sym"))
    hdr = T["header_words"].T.expand(n, NUM_BANDS, -1)
    return torch.cat([hdr, body], dim=2)


def encode_rows(raw_words, layout, lo: int, hi: int, device) -> torch.Tensor:
    """Body rows lo..hi of the one superframe ``layout`` encodes from RAW
    words (n_raw_words, 9) -> wire words (hi - lo, 9) int8 on ``device``.

    Only the codewords that reach those rows are computed, a codeword of
    the beacon band that crosses lo or hi in full, and only the RAW words
    they read are taken from ``raw_words`` (any device) and moved.  The
    host tables are built for those blocks alone (``_encode_gather``'s
    ``blocks``), so rows of one frame encode apart and equal the rows of
    ``encode_superframes``."""
    geom, beacon = layout.geom, layout.cfg.beacon
    n = layout.n_raw_words
    parts = []
    for grp in k_groups(geom, beacon):
        if grp.beacon:
            pay = _beacon_payload_rows(geom.usable[grp.bands[0]],
                                       beacon.words_period)[:grp.nblk * rs.N]
            j = np.flatnonzero((pay >= lo) & (pay < hi)) // rs.N
            if j.size == 0:
                continue
            j0, j1 = int(j[0]), int(j[-1]) + 1
            rows = pay[j0 * rs.N:j1 * rs.N]
        else:
            j0, j1 = lo // rs.N, min(-(-hi // rs.N), grp.nblk)
            if j0 >= j1:
                continue
            rows = np.arange(j0 * rs.N, j1 * rs.N)
        src, pw = _encode_gather(layout, grp, range(j0, j1))
        parts.append((grp, rows, src, pw))
    # the RAW words read, and each one's place in the local copy; the zero
    # slot (symbol n*9) lands after them
    used = np.zeros(n + 1, dtype=bool)
    for _, _, src, _ in parts:
        used[src // NUM_BANDS] = True
    used[n] = False
    words = np.flatnonzero(used)
    pos = np.cumsum(used) - 1
    pos[n] = words.size
    raw = torch.as_tensor(raw_words)
    raw = raw[torch.as_tensor(words, device=raw.device)].to(device, torch.int8)
    flat = torch.nn.functional.pad(raw.reshape(1, -1), (0, 1))
    grid = torch.zeros((1, NUM_BANDS, hi - lo, 3), dtype=torch.int8,
                       device=device)
    for grp, rows, src, pw in parts:
        lsrc = pos[src // NUM_BANDS] * NUM_BANDS + src % NUM_BANDS
        par = parity_map(rs._matrices_pm(grp.k)["G2"], grp.k)
        cw = group_codewords(flat, torch.as_tensor(lsrc, device=device),
                             torch.as_tensor(pw, device=device),
                             torch.as_tensor(par, device=device), grp.k)[0]
        keep = (rows >= lo) & (rows < hi)
        cw = cw[:, torch.as_tensor(np.flatnonzero(keep), device=device)]
        r = torch.as_tensor(rows[keep] - lo, device=device)
        b = torch.as_tensor(grp.bands, device=device)
        grid[0, b[:, None], r[None, :]] = cw
    off = scramble.pm_offsets(geom.H, layout.cfg.seed, 1)[:, lo:hi]
    bc_rows = bc_sym = None
    if beacon.enabled:
        bc = _beacon_rows(geom.H, beacon.words_period)
        bc_rows = torch.as_tensor(bc[(bc >= lo) & (bc < hi)] - lo,
                                  device=device)
        bc_sym = torch.as_tensor(np_sym_to_dig(geom.beacon_sym), device=device)
    return scramble_pack(grid, torch.as_tensor(off, device=device), beacon,
                         bc_rows, bc_sym)[0].T
