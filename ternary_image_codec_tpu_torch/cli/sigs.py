"""Cheap stream signatures used by the dump tools: CRC-12(0x80F) and mod-3
parity over raw bytes (src/t3dump.cpp:48-69, src/minitest_trits.cpp:112-126).
Host code, the JAX package's cli/sigs.py on the port's runtime/native.py.

CRC-12 is table-driven: processing one byte is affine in the 12-bit state
(state' = M[state] ^ K[byte] over GF(2)), so two precomputed tables replace
the reference's bit loop.  A C fast path (runtime/native) takes over for
large payloads when available.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_TABLES: Optional[Tuple[np.ndarray, np.ndarray]] = None


def _tables() -> Tuple[np.ndarray, np.ndarray]:
    global _TABLES
    if _TABLES is None:
        poly = 0x80F
        k = np.zeros(256, dtype=np.uint16)
        for byte in range(256):
            c = 0
            for bit in range(7, -1, -1):
                inb = (byte >> bit) & 1
                msb = (c >> 11) & 1
                c = (c << 1) & 0xFFF
                if msb ^ inb:
                    c ^= poly
            k[byte] = c
        m = np.zeros(4096, dtype=np.uint16)
        for state in range(4096):
            c = state
            for _ in range(8):
                msb = (c >> 11) & 1
                c = (c << 1) & 0xFFF
                if msb:
                    c ^= poly
            m[state] = c
        _TABLES = (m, k)
    return _TABLES


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8).reshape(-1)


_VTABLES: Optional[Tuple[int, np.ndarray]] = None


def _vtables() -> Tuple[int, np.ndarray]:
    """Position-class contribution tables for the vectorized fallback.

    The byte update state' = M[state] ^ K[byte] is affine with M linear
    over GF(2) and M[0] = 0, so the final CRC is the XOR of per-byte
    contributions M^d(K[byte]) where d = distance from the stream end.
    M (multiply by x^8 mod g) is invertible (g has a +1 term), so M^d
    cycles with period p <= 4095: T[d % p, byte] covers every position.
    """
    global _VTABLES
    if _VTABLES is None:
        m, k = _tables()
        ident = np.arange(4096, dtype=np.uint16)
        cur = m[ident]
        p = 1
        while not np.array_equal(cur, ident):
            cur = m[cur]
            p += 1
        T = np.empty((p, 256), dtype=np.uint16)
        T[0] = k
        for d in range(1, p):
            T[d] = m[T[d - 1]]
        _VTABLES = (p, T)
    return _VTABLES


def _crc12_numpy(b: np.ndarray) -> int:
    """Vectorized CRC-12 via XOR-reduce of position-class contributions
    (chunked; no O(n) index array held live)."""
    p, T = _vtables()
    n = b.size
    acc = 0
    step = 1 << 22
    for i in range(0, n, step):
        j = min(i + step, n)
        # distance from the end for positions [i, j): n-1-i .. n-j
        d = (np.arange(n - 1 - i, n - 1 - j, -1, dtype=np.int64)) % p
        acc ^= int(np.bitwise_xor.reduce(T[d, b[i:j]]))
    return acc & 0xFFF


def crc12_0x80F(data) -> int:
    """Bit-faithful CRC-12, polynomial 0x80F, init 0 (src/t3dump.cpp:48-62)."""
    b = _as_u8(data)
    try:
        from ..runtime import native
        if native.available():
            return native.crc12_0x80F(b)
    except ImportError:
        pass
    if b.size >= 4096:          # table-build amortizes; full-payload
        return _crc12_numpy(b)  # signatures stay fast with no compiler
    m, k = _tables()
    crc = 0
    for byte in b.tolist():
        crc = int(m[crc]) ^ int(k[byte])
    return crc & 0xFFF


def parity_mod3(data) -> int:
    """sum(byte % 3) % 3 (src/t3dump.cpp:64-69)."""
    b = _as_u8(data)
    return int((b.astype(np.int64) % 3).sum() % 3)
