"""Superframe header (27 GF(27) symbols) with its ternary CRC-12, host side.

Only what the stream needs: ``pack`` builds the symbols the constant
header wire words carry.  Layout and CRC as in the JAX package's
ops/header.py: the CRC is the mod-3 LFSR of g(x) = x^12 + x^7 + x^4 + x^3 + 1
over the trits of every slot except {20, 21, 22, 26}, then 12 zero-flush
steps; it is linear, so it is one (69, 12) GF(3) matrix.
"""
from __future__ import annotations

import functools

import numpy as np

from ..config import SubwordMode, SuperframeHeader

CRC_L = 12
CRC_SLOTS = (20, 21, 22, 26)
MSG_SLOTS = tuple(i for i in range(27) if i not in CRC_SLOTS)
MSG_TRITS = len(MSG_SLOTS) * 3

_SUB_CODE = {SubwordMode.S27: 0, SubwordMode.S24: 1, SubwordMode.S21: 2,
             SubwordMode.S18: 3, SubwordMode.S15: 4}


def crc12_lfsr(trits) -> np.ndarray:
    """The mod-3 LFSR remainder of a trit message."""
    r = np.zeros(CRC_L, dtype=np.int64)

    def step(t):
        fb = (t + r[CRC_L - 1]) % 3
        nx = np.empty_like(r)
        nx[0] = fb
        nx[1] = r[0]
        nx[2] = r[1]
        nx[3] = (r[2] + fb) % 3
        nx[4] = (r[3] + fb) % 3
        nx[5:7] = r[4:6]
        nx[7] = (r[6] + fb) % 3
        nx[8:12] = r[7:11]
        r[:] = nx

    for t in np.asarray(trits, dtype=np.int64):
        step(t)
    for _ in range(CRC_L):
        step(0)
    return r.copy()


@functools.cache
def crc12_matrix() -> np.ndarray:
    """(MSG_TRITS, 12) GF(3) matrix: crc = msg_trits @ M mod 3."""
    M = np.zeros((MSG_TRITS, CRC_L), dtype=np.int8)
    for i in range(MSG_TRITS):
        e = np.zeros(MSG_TRITS, dtype=np.int64)
        e[i] = 1
        M[i] = crc12_lfsr(e)
    return M


def pack(h: SuperframeHeader) -> np.ndarray:
    """Header -> 27 GF(27) symbols (int8) with the CRC-12 filled in."""
    s = np.zeros(27, dtype=np.int64)
    s[0] = h.magic % 27
    s[1] = (h.magic // 27) % 27
    s[2] = h.version % 27
    s[3] = int(h.profile) % 27
    for g in range(3):          # UEP: 3 bands per symbol, first band MSD
        u = 0
        for i in range(3 * g, 3 * g + 3):
            u = u * 3 + (h.uep.band_profile[i] % 3)
        s[4 + g] = u
    s[7] = h.tile.w % 27
    s[8] = h.tile.h % 27
    s[9] = h.seed.a % 27
    s[10] = h.seed.b % 27
    s[11] = h.seed.s0 % 27
    s[12] = (_SUB_CODE[h.subword] + 9 * (1 if h.centered else 0)) % 27
    s[13] = h.band_map_hash % 27
    s[14] = (h.band_map_hash // 27) % 27
    s[15] = (h.band_map_hash // 729) % 27
    s[16] = int(h.coset) % 3
    s[17] = h.frame_seq % 27
    s[18] = (h.frame_seq // 27) % 27
    s[19] = (h.frame_seq // 729) % 27
    s[23] = 1 if h.beacon.enabled else 0
    s[24] = h.beacon.band_slot % 27
    s[25] = min(h.beacon.words_period, 26)
    msg = s[list(MSG_SLOTS)]
    trits = np.stack([msg % 3, (msg // 3) % 3, (msg // 9) % 3], -1).reshape(-1)
    crc = (trits @ crc12_matrix().astype(np.int64)) % 3
    c4 = crc.reshape(4, 3)
    s[list(CRC_SLOTS)] = c4[:, 0] + 3 * c4[:, 1] + 9 * c4[:, 2]
    return s.astype(np.int8)
