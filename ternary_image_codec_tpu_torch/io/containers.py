"""T3P6 / T3V6 containers -- byte-exact with the C++ reference.

The port's copy of the JAX package's ``io/containers.py`` (host code, no
framework); ``tests/test_torch_containers.py`` holds the two equal.

Layouts (include/io_t3p_t3v.hpp:16-84, src/io_t3p_t3v.cpp):

.t3p (image):
  "T3P6" | ver u8=6 | sub u8 | w u16 | h u16 | meta_len u32 | words u64
  | hdr_crc32 u32 | meta_json | words*4 bytes (uint32 LE each) | payload_crc32

.t3v (video):
  "T3V6" | ver u8=6 | sub u8 | w u16 | h u16 | frame_count u64 | meta_g u32
  | hdr_crc32 u32 | global meta | index[(offset u64, words u64, meta u32)]
  | per frame: meta | words*4 | crc32     (index rewritten after data pass)

Byte-exactness notes:
* All integers little-endian; payload words are the 4-byte uint32 Word27 ABI
  of the reference's new tree (include/ternary_image_codec_v6_min.hpp:29-34).
* The header CRC32 is computed over the *in-memory C struct* including its
  alignment padding (src/io_t3p_t3v.cpp:88-96): for t3p that is the 24-byte
  image {ver,sub,w,h,pad2,meta_len,pad4,words_count}; for t3v the 24-byte
  image {ver,sub,w,h,pad2,frame_count,meta_g_len,pad4}.  Verified by a
  compiled reference probe (tests/test_containers.py golden files).
* CRC32 is the standard zlib polynomial 0xEDB88320 (src/io_t3p_t3v.cpp:18-33).

Security: readers accept an `approve_meta(meta_json) -> bool` callback which
MUST pass before any payload bytes are read (meta-only approval,
include/io_t3p_t3v.hpp:35-55); on refusal the payload is never loaded.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SubwordMode

ApproveMetaFn = Callable[[str], bool]


class ContainerError(Exception):
    pass


def _crc32(data, init: int = 0) -> int:
    """Container CRC-32 (zlib polynomial).  Routed through the native
    PCLMUL-folded kernel when it builds (``runtime/native.py``), else
    through zlib; the two are bit-identical (differential in
    tests/test_torch_containers.py).  The 112 MB serve frames of an 8K
    stream make this the host's hottest loop on the serve path."""
    from ..runtime import native
    if native.available():
        return native.crc32(data, init)
    return zlib.crc32(data, init) & 0xFFFFFFFF


def _t3p_hdr_crc(ver: int, sub: int, w: int, h: int, meta_len: int,
                 words_count: int) -> int:
    # struct { u8 ver, subu; u16 W, H; u32 meta_len; u64 words_count; }
    # with natural alignment padding (2 bytes after H, 4 after meta_len)
    buf = struct.pack("<BBHH2xI4xQ", ver, sub, w, h, meta_len, words_count)
    assert len(buf) == 24
    return _crc32(buf)


def _t3v_hdr_crc(ver: int, sub: int, w: int, h: int, frame_count: int,
                 meta_g_len: int) -> int:
    # struct { u8 ver, subu; u16 W, H; u64 frame_count; u32 meta_g_len; }
    buf = struct.pack("<BBHH2xQI4x", ver, sub, w, h, frame_count, meta_g_len)
    assert len(buf) == 24
    return _crc32(buf)


def _words_bytes(words) -> bytes:
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    if w.ndim != 1:
        raise ContainerError("T3P6/T3V6 payload must be a flat uint32 word array")
    return w.astype("<u4").tobytes()


# ---------------------------------------------------------------------------
# .t3p
# ---------------------------------------------------------------------------


def t3p_write(path: str, sub: SubwordMode, w: int, h: int, words,
              meta_json: str = "") -> None:
    """src/io_t3p_t3v.cpp:56-120."""
    meta = meta_json.encode("utf-8")
    payload = _words_bytes(words)
    n_words = len(payload) // 4
    with open(path, "wb") as f:
        f.write(b"T3P6")
        f.write(struct.pack("<BBHHIQ", 6, int(sub), w, h, len(meta), n_words))
        f.write(struct.pack("<I", _t3p_hdr_crc(6, int(sub), w, h, len(meta), n_words)))
        f.write(meta)
        f.write(payload)
        f.write(struct.pack("<I", _crc32(payload) if n_words else 0))


def _read_t3p_header(f, check_header_crc: bool = True
                     ) -> Tuple[SubwordMode, int, int, int, int]:
    if f.read(4) != b"T3P6":
        raise ContainerError("t3p: bad magic")
    ver, sub, w, h, meta_len, words_count = struct.unpack("<BBHHIQ", f.read(18))
    (hdr_crc,) = struct.unpack("<I", f.read(4))
    if (check_header_crc
            and _t3p_hdr_crc(ver, sub, w, h, meta_len, words_count) != hdr_crc):
        raise ContainerError("t3p: header crc mismatch")
    return SubwordMode(sub), w, h, meta_len, words_count


def t3p_read_header(path: str, check_header_crc: bool = True
                    ) -> Tuple[SubwordMode, int, int, str, int]:
    """-> (sub, w, h, meta_json, words_count)  (src/io_t3p_t3v.cpp:122-168).

    check_header_crc=False accepts files written by the C++ reference, whose
    header CRC covers uninitialized struct padding and is therefore garbage
    (docs/DIVERGENCES.md #9); payload CRC is still enforced.
    """
    with open(path, "rb") as f:
        sub, w, h, meta_len, words_count = _read_t3p_header(f, check_header_crc)
        meta = f.read(meta_len).decode("utf-8") if meta_len else ""
    return sub, w, h, meta, words_count


def t3p_read_payload(path: str, approve_meta: Optional[ApproveMetaFn] = None,
                     check_header_crc: bool = True) -> np.ndarray:
    """Meta-approved payload read (src/io_t3p_t3v.cpp:170-215).

    Raises ContainerError (and never touches payload bytes) if approve_meta
    returns False.
    """
    with open(path, "rb") as f:
        sub, w, h, meta_len, words_count = _read_t3p_header(f, check_header_crc)
        meta = f.read(meta_len).decode("utf-8") if meta_len else ""
        if approve_meta is not None and not approve_meta(meta):
            raise ContainerError("t3p: meta not approved -- payload not read")
        payload = f.read(words_count * 4)
        if len(payload) != words_count * 4:
            raise ContainerError("t3p: truncated payload")
        (pl_crc,) = struct.unpack("<I", f.read(4))
        want = _crc32(payload) if words_count else 0
        if pl_crc != want:
            raise ContainerError("t3p: payload crc mismatch")
    return np.frombuffer(payload, dtype="<u4").copy()


# ---------------------------------------------------------------------------
# .t3v
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class T3VFrameIndex:
    offset: int = 0
    words: int = 0
    meta_len: int = 0


def t3v_write(path: str, sub: SubwordMode, w: int, h: int,
              frames: Sequence, meta_json_global: str = "",
              metas_per_frame: Optional[Sequence[str]] = None) -> None:
    """src/io_t3p_t3v.cpp:220-289 (two-pass: placeholder index, rewrite)."""
    metag = meta_json_global.encode("utf-8")
    n = len(frames)
    per = ([m.encode("utf-8") for m in metas_per_frame]
           if metas_per_frame is not None and len(metas_per_frame) == n
           else [b""] * n)
    with open(path, "wb") as f:
        f.write(b"T3V6")
        f.write(struct.pack("<BBHHQI", 6, int(sub), w, h, n, len(metag)))
        f.write(struct.pack("<I", _t3v_hdr_crc(6, int(sub), w, h, n, len(metag))))
        f.write(metag)
        idx_pos = f.tell()
        for i in range(n):
            f.write(struct.pack("<QQI", 0, len(frames[i]), len(per[i])))
        index: List[T3VFrameIndex] = []
        for i in range(n):
            off = f.tell()
            payload = _words_bytes(frames[i])
            index.append(T3VFrameIndex(off, len(payload) // 4, len(per[i])))
            f.write(per[i])
            f.write(payload)
            f.write(struct.pack("<I", _crc32(payload) if payload else 0))
        f.seek(idx_pos)
        for fi in index:
            f.write(struct.pack("<QQI", fi.offset, fi.words, fi.meta_len))


def t3v_read_header(path: str, check_header_crc: bool = True):
    """-> (sub, w, h, meta_global, frame_count, index)
    (src/io_t3p_t3v.cpp:295-342)."""
    with open(path, "rb") as f:
        if f.read(4) != b"T3V6":
            raise ContainerError("t3v: bad magic")
        ver, sub, w, h, frame_count, meta_g_len = struct.unpack("<BBHHQI", f.read(18))
        (hdr_crc,) = struct.unpack("<I", f.read(4))
        if (check_header_crc
                and _t3v_hdr_crc(ver, sub, w, h, frame_count, meta_g_len) != hdr_crc):
            raise ContainerError("t3v: header crc mismatch")
        metag = f.read(meta_g_len).decode("utf-8") if meta_g_len else ""
        index = []
        for _ in range(frame_count):
            off, words, ml = struct.unpack("<QQI", f.read(20))
            index.append(T3VFrameIndex(off, words, ml))
    return SubwordMode(sub), w, h, metag, frame_count, index


def t3v_read_frame(path: str, frame_idx: int,
                   approve_meta: Optional[ApproveMetaFn] = None,
                   check_header_crc: bool = True) -> np.ndarray:
    """Meta-approved random frame access (src/io_t3p_t3v.cpp:344-389)."""
    sub, w, h, metag, fc, index = t3v_read_header(path, check_header_crc)
    if frame_idx >= fc:
        raise ContainerError("t3v: frame idx OOB")
    fi = index[frame_idx]
    with open(path, "rb") as f:
        f.seek(fi.offset)
        meta = f.read(fi.meta_len).decode("utf-8") if fi.meta_len else ""
        if approve_meta is not None and not approve_meta(meta):
            raise ContainerError("t3v: meta not approved -- frame payload not read")
        payload = f.read(fi.words * 4)
        if len(payload) != fi.words * 4:
            raise ContainerError("t3v: truncated frame payload")
        (pl_crc,) = struct.unpack("<I", f.read(4))
        want = _crc32(payload) if fi.words else 0
        if pl_crc != want:
            raise ContainerError("t3v: frame payload crc mismatch")
    return np.frombuffer(payload, dtype="<u4").copy()
