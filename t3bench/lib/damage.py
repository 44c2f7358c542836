"""Frozen copy of the damage model of the port's ``bench/damage.py``
(itself bench.py's dirty phase, bench.py:390-463), kept here so that later
changes to the program cannot change the benchmark's traffic.

Per frame, ``D`` dirty superframes; each takes ``E`` symbol errors in
distinct bands at distinct body positions.  A fraction ``overcap`` of the
dirty superframes (the head of the dirty list) also takes 3 errors in one
codeword of band 1 (k=22, t=2: beyond capacity, the repair must flag it),
and a fraction ``hdr`` (the tail) 2 errors among the 52 used header cells
(the RS(26,18) header chain repairs them).  numpy's ``default_rng(seed)``
draws in bench.py's order, so the damage is the JAX benchmark's.
"""
from __future__ import annotations

import numpy as np
import torch

HEADER_WORDS = 6
HEADER_CELLS = 52      # used cells of the 9 x 6 header slab (word-major)
OVERCAP_BAND = 1       # k=22 under luma-priority UEP
OVERCAP_BLOCK = 2


def damage(n_sf: int, total_w: int, frames: int, D: int = 20, E: int = 8,
           overcap: float = 0.0, hdr: float = 0.25, seed: int = 1):
    """Damage events for ``frames`` frames of ``n_sf`` superframes of
    ``total_w`` wire words: ((fi, si, bi, pi, dlt), (fi_sf, si_sf)) --
    frame, superframe, band, word position and delta 1..26 of each symbol
    error, then the dirty list (frame, superframe) of ``min(D, n_sf)``
    superframes a frame."""
    D = min(D, n_sf)
    E = min(E, 9)
    r2 = np.random.default_rng(seed)
    fi_sf = np.repeat(np.arange(frames), D)
    si_sf = np.stack([r2.choice(n_sf, D, replace=False)
                      for _ in range(frames)]).reshape(-1)
    n = len(fi_sf)
    fi = np.repeat(fi_sf, E)
    si = np.repeat(si_sf, E)
    bi = np.stack([r2.choice(9, E, replace=False)
                   for _ in range(n)]).reshape(-1)
    pi = np.stack([HEADER_WORDS
                   + r2.choice(total_w - HEADER_WORDS, E, replace=False)
                   for _ in range(n)]).reshape(-1)
    dlt = r2.integers(1, 27, size=fi.shape)
    n_over = int(round(overcap * n))
    if n_over:
        ob = HEADER_WORDS + OVERCAP_BLOCK * 26
        fi = np.concatenate([fi, np.repeat(fi_sf[:n_over], 3)])
        si = np.concatenate([si, np.repeat(si_sf[:n_over], 3)])
        bi = np.concatenate([bi, np.tile([OVERCAP_BAND] * 3, n_over)])
        pi = np.concatenate([pi, np.tile([ob, ob + 1, ob + 2], n_over)])
        dlt = np.concatenate([dlt, r2.integers(1, 27, size=3 * n_over)])
    n_hdr = int(round(hdr * n))
    if n_hdr:
        sel = np.arange(n)[::-1][:n_hdr]
        # cell c of the word-major slab: wire row c % 9, header word c // 9
        hc = np.stack([r2.choice(HEADER_CELLS, 2, replace=False)
                       for _ in range(n_hdr)])
        fi = np.concatenate([fi, np.repeat(fi_sf[sel], 2)])
        si = np.concatenate([si, np.repeat(si_sf[sel], 2)])
        bi = np.concatenate([bi, (hc % 9).reshape(-1)])
        pi = np.concatenate([pi, (hc // 9).reshape(-1)])
        dlt = np.concatenate([dlt, r2.integers(1, 27, size=2 * n_hdr)])
    return (fi, si, bi, pi, dlt), (fi_sf, si_sf)


def apply(words: torch.Tensor, dmg) -> torch.Tensor:
    """A damaged copy of wire planes (F, n_sf, 9, total) int8: each event
    of ``dmg`` (``damage``'s first result) adds its delta mod 27."""
    fi, si, bi, pi, dlt = dmg
    dev = words.device
    idx = tuple(torch.as_tensor(a, device=dev) for a in (fi, si, bi, pi))
    out = words.clone()
    out[idx] = ((out[idx].to(torch.int16) + torch.as_tensor(dlt, device=dev))
                % 27).to(torch.int8)
    return out
