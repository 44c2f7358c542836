"""Wire planes <-> base-243 bytes for serving, in plain torch integer ops.

The port of the JAX package's ``ops/wirepack.py``: the same byte stream,
bit for bit.  Per superframe, the (9, total) wire plane grid in C order
(band-major symbol stream), each GF(27) symbol taken as 3 trits LSD first,
the trits packed 5 a byte LSD first (base 243), the superframe's tail byte
zero-padded, so every superframe is exactly ``sf_bytes(total)`` bytes and
frames concatenate cleanly.

The reference expands every symbol to trits (an 8K frame is 432M trits).
Here no trit is ever materialised: 27^5 = 243^3 = 14,348,907 < 2^31, so
five symbols make one int32 value that is exactly three bytes, and three
bytes make one value that is exactly five symbols.  The reference's
contract on bad input is kept: a symbol outside 0..26 (int8, negative ones
too) packs as ``s mod 27`` with floor semantics, and a byte 243..255
unpacks as ``b mod 243`` (its quotient digit is dropped), so each byte is
reduced before three are combined.
"""
from __future__ import annotations

import numpy as np
import torch

_POW5 = np.array([1, 3, 9, 27, 81], dtype=np.int32)


def sf_bytes(total_words: int) -> int:
    """Packed bytes per superframe for a (9, total) wire plane grid."""
    return -(-9 * total_words * 3 // 5)


def pack_wire(planes: torch.Tensor) -> torch.Tensor:
    """(n_sf, 9, total) int8 wire symbols -> (n_sf, sf_bytes) uint8."""
    n_sf, bands, total = planes.shape
    nsym = bands * total
    s = planes.reshape(n_sf, nsym).to(torch.int32).remainder_(27)
    s = torch.nn.functional.pad(s, (0, -nsym % 5)).view(n_sf, -1, 5)
    v = (s[..., 0] + 27 * s[..., 1] + 729 * s[..., 2] + 19683 * s[..., 3]
         + 531441 * s[..., 4])
    by = torch.stack([v % 243, v // 243 % 243, v // 59049], dim=-1)
    return by.view(n_sf, -1)[:, :-(-nsym * 3 // 5)].to(torch.uint8)


def unpack_wire(by: torch.Tensor, total_words: int) -> torch.Tensor:
    """(n_sf, >= sf_bytes) uint8 -> (n_sf, 9, total) int8 wire symbols."""
    n_sf, width = by.shape
    nsym = 9 * total_words
    if width < sf_bytes(total_words):
        raise ValueError(f"{width} bytes a superframe, {total_words} words "
                         f"need {sf_bytes(total_words)}")
    m = -(-nsym // 5)                        # groups of 5 symbols, 3 bytes
    b = by[:, :3 * m].to(torch.int32).remainder_(243)
    b = torch.nn.functional.pad(b, (0, 3 * m - b.shape[1])).view(n_sf, m, 3)
    v = b[..., 0] + 243 * b[..., 1] + 59049 * b[..., 2]
    s = torch.stack([v % 27, v // 27 % 27, v // 729 % 27, v // 19683 % 27,
                     v // 531441], dim=-1).to(torch.int8)
    return s.view(n_sf, 5 * m)[:, :nsym].contiguous().view(n_sf, 9,
                                                          total_words)


def np_pack_wire(planes: np.ndarray) -> np.ndarray:
    """Host oracle for pack_wire (golden tests): the reference's trit
    expansion in numpy."""
    planes = np.asarray(planes, dtype=np.int64)
    n_sf = planes.shape[0]
    ntr = planes.shape[1] * planes.shape[2] * 3
    d = planes.reshape(n_sf, -1, 1) // np.array([1, 3, 9]) % 3
    t = d.reshape(n_sf, ntr)
    pad = (-ntr) % 5
    if pad:
        t = np.concatenate([t, np.zeros((n_sf, pad), np.int64)], axis=1)
    return (t.reshape(n_sf, -1, 5) * _POW5).sum(-1).astype(np.uint8)
