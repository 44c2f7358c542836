"""Legacy container generations: T3P1 (new+old), T3V1 (new+old rich), T3B1,
T3VI index sidecar, and the .t3proto (T3PT) lab container.

The port's copy of the JAX package's ``io/legacy_containers.py``, on the
port's ``ops/trits.py`` numpy helpers; tests/test_torch_containers.py holds
it to the golden files as tests/test_legacy_containers.py does.

Byte-exact re-implementations of the reference formats (SURVEY.md §2.5
F3-F8).  All host-side (numpy + struct); payload trit math stays on device
in ops/*.  All integers little-endian; the packed C structs of the old tree
use #pragma pack(1), so there is no alignment padding to model.

Reference parity (behavior studied from, not copied):
  - T3P1-new   stream:  include/t3p_io.hpp:16-41
  - T3V1-new   stream:  include/t3v_io.hpp:17-41
  - T3P1-old / T3B1:    old/include/t3p_io.hpp:45-113, old/include/t3b_io.hpp:43-111
  - T3V1-old   rich:    old/include/t3v_io.hpp:42-159
  - T3VI sidecar:       old/include/t3v_indexed_io.hpp:14-108
  - T3PT (.t3proto):    include/io_t3proto.hpp:46-354
"""
from __future__ import annotations

import dataclasses
import enum
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import ActiveWindow, CosetID, ProfileID, SubwordMode
from ..ops.trits import np_base243_to_trits, np_trits_to_base243
from .containers import ContainerError

__all__ = [
    "ProtoProfile",
    "t3p1_write", "t3p1_read",
    "t3v1_write", "t3v1_read_all",
    "T3POldHeader", "t3p_old_write", "t3p_old_read",
    "t3b_write", "t3b_read",
    "T3VOldHeader", "t3v_old_write", "t3v_old_read_header",
    "t3v_old_read_frames", "t3v_old_append_frame",
    "t3vi_write", "t3vi_read", "t3v_scan_and_index",
    "t3proto_write", "t3proto_read", "t3proto_peek", "infer_ntrits_from_meta",
    "meta_find_int",
    "subword_to_code", "code_to_subword",
]


def _crc32(data: bytes) -> int:
    # All legacy formats use the zlib polynomial 0xEDB88320
    # (old/include/t3v_io.hpp:14-41 and siblings).
    return zlib.crc32(data) & 0xFFFFFFFF


def subword_to_code(m: SubwordMode) -> int:
    """old/include/t3v_io.hpp:61-77 (S27..S15 -> 0..4)."""
    return {SubwordMode.S27: 0, SubwordMode.S24: 1, SubwordMode.S21: 2,
            SubwordMode.S18: 3, SubwordMode.S15: 4}[SubwordMode(m)]


def code_to_subword(c: int) -> SubwordMode:
    """old/include/t3v_io.hpp:78-95 (unknown codes fall back to S27)."""
    return {0: SubwordMode.S27, 1: SubwordMode.S24, 2: SubwordMode.S21,
            3: SubwordMode.S18, 4: SubwordMode.S15}.get(c, SubwordMode.S27)


def _as_trits(tr) -> np.ndarray:
    return (np.asarray(tr, dtype=np.int64).reshape(-1) % 3).astype(np.uint8)


def _as_sym_frames(frame) -> np.ndarray:
    """A frame is (n_words, 9) GF27 symbols (word9 ABI)."""
    a = np.asarray(frame, dtype=np.int64)
    if a.ndim != 2 or a.shape[1] != 9:
        raise ContainerError("t3v1 frame must be (n_words, 9) GF27 symbols")
    return (a % 27).astype(np.uint8)


# ---------------------------------------------------------------------------
# F3: T3P1 (new-min) — 'T3P1' u32 | total_trits u32 | base-243 bytes
# ---------------------------------------------------------------------------

_T3P1_MAGIC = 0x31503354  # 'T3P1' LE (include/t3p_io.hpp:16)


def t3p1_write(path: str, trits) -> None:
    """include/t3p_io.hpp:18-30 (UTrit stream transport, zero-padded tail)."""
    tr = _as_trits(trits)
    by, _tail = np_trits_to_base243(tr)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", _T3P1_MAGIC, tr.size))
        f.write(by.tobytes())


def t3p1_read(path: str) -> np.ndarray:
    """include/t3p_io.hpp:32-41 -> int8 UTrit array."""
    with open(path, "rb") as f:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ContainerError("t3p1: truncated header")
        magic, total = struct.unpack("<II", hdr)
        if magic != _T3P1_MAGIC:
            raise ContainerError("t3p1: bad magic")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size * 5 < total:
        raise ContainerError("t3p1: truncated payload")
    return np_base243_to_trits(data, total)


# ---------------------------------------------------------------------------
# F4a: T3V1 (new-min) — 'T3V1' u32 | frames u32 | [words u32 | 9*words bytes]
# ---------------------------------------------------------------------------

_T3V1_MAGIC = 0x31563354  # 'T3V1' LE (include/t3v_io.hpp:17)


def t3v1_write(path: str, frames: Sequence) -> None:
    """include/t3v_io.hpp:20-27 generalized to n frames (the reference's
    write_single writes exactly one; read_all accepts any count)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<II", _T3V1_MAGIC, len(frames)))
        for fr in frames:
            syms = _as_sym_frames(fr)
            f.write(struct.pack("<I", syms.shape[0]))
            f.write(syms.tobytes())


def t3v1_read_all(path: str) -> List[np.ndarray]:
    """include/t3v_io.hpp:29-41 -> list of (n_words, 9) int8 symbol arrays."""
    out: List[np.ndarray] = []
    with open(path, "rb") as f:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ContainerError("t3v1: truncated header")
        magic, n_frames = struct.unpack("<II", hdr)
        if magic != _T3V1_MAGIC:
            raise ContainerError("t3v1: bad magic")
        for _ in range(n_frames):
            raw = f.read(4)
            if len(raw) < 4:
                raise ContainerError("t3v1: truncated frame header")
            (n_words,) = struct.unpack("<I", raw)
            buf = f.read(n_words * 9)
            if len(buf) != n_words * 9:
                raise ContainerError("t3v1: truncated frame payload")
            out.append(np.frombuffer(buf, dtype=np.uint8)
                       .reshape(n_words, 9).astype(np.int8))
    return out


# ---------------------------------------------------------------------------
# F6/F8: T3B1 (.t3b) and T3P1-old (.t3p) — identical packed layout, different
#        magic.  29-byte #pragma pack(1) header, CRC32 over first 25 bytes.
# ---------------------------------------------------------------------------

_T3PB_FMT = "<4sBBBBIIIBII"  # magic, ver, sub_code, centered, rsv, W, H,
#                              trit_count, tail, payload_crc, header_crc
_T3PB_SIZE = struct.calcsize(_T3PB_FMT)
assert _T3PB_SIZE == 29


@dataclasses.dataclass(frozen=True)
class T3POldHeader:
    """old/include/t3p_io.hpp:46-58 / t3b_io.hpp:44-56 (same fields)."""
    subword: SubwordMode
    centered: bool
    width: int
    height: int
    trit_count: int
    tail_trits: int


def _t3pb_write(path: str, magic: bytes, sub: SubwordMode, centered: bool,
                width: int, height: int, trits) -> None:
    tr = _as_trits(trits)
    packed, tail = np_trits_to_base243(tr)
    pay = packed.tobytes()
    head25 = struct.pack("<4sBBBBIIIB", magic, 1, subword_to_code(sub),
                         1 if centered else 0, 0, width, height, tr.size, tail)
    head25 += struct.pack("<I", _crc32(pay))
    with open(path, "wb") as f:
        f.write(head25)
        f.write(struct.pack("<I", _crc32(head25)))
        f.write(pay)


def _t3pb_read(path: str, magic: bytes) -> Tuple[T3POldHeader, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read(_T3PB_SIZE)
        if len(raw) < _T3PB_SIZE:
            raise ContainerError("t3p/t3b: truncated header")
        (mg, ver, sub_code, centered, _rsv, w, h, trit_count, tail,
         pay_crc, hdr_crc) = struct.unpack(_T3PB_FMT, raw)
        if mg != magic:
            raise ContainerError("t3p/t3b: bad magic")
        if _crc32(raw[:_T3PB_SIZE - 4]) != hdr_crc:
            raise ContainerError("t3p/t3b: header crc mismatch")
        n_bytes = trit_count // 5 + (1 if tail else 0)
        pay = f.read(n_bytes)
        if len(pay) != n_bytes:
            raise ContainerError("t3p/t3b: truncated payload")
    if _crc32(pay) != pay_crc:
        raise ContainerError("t3p/t3b: payload crc mismatch")
    if tail > 4:
        raise ContainerError("t3p/t3b: invalid tail_trits")
    trits = np_base243_to_trits(np.frombuffer(pay, dtype=np.uint8), trit_count)
    hdr = T3POldHeader(code_to_subword(sub_code), bool(centered), w, h,
                       trit_count, tail)
    return hdr, trits


def t3p_old_write(path, sub, centered, width, height, trits) -> None:
    """old/include/t3p_io.hpp:61-82."""
    _t3pb_write(path, b"T3P1", sub, centered, width, height, trits)


def t3p_old_read(path) -> Tuple[T3POldHeader, np.ndarray]:
    """old/include/t3p_io.hpp:83-113."""
    return _t3pb_read(path, b"T3P1")


def t3b_write(path, sub, centered, width, height, trits) -> None:
    """old/include/t3b_io.hpp:59-80."""
    _t3pb_write(path, b"T3B1", sub, centered, width, height, trits)


def t3b_read(path) -> Tuple[T3POldHeader, np.ndarray]:
    """old/include/t3b_io.hpp:81-111."""
    return _t3pb_read(path, b"T3B1")


# ---------------------------------------------------------------------------
# F4b: T3V1-old rich video container (the most complete video container)
# ---------------------------------------------------------------------------

_T3VOLD_FMT = "<4sBBBBBB11I"  # 54 bytes packed
_T3VOLD_SIZE = struct.calcsize(_T3VOLD_FMT)
assert _T3VOLD_SIZE == 54


@dataclasses.dataclass(frozen=True)
class T3VOldHeader:
    """old/include/t3v_io.hpp:42-59."""
    file_type: int = 1           # 0=image, 1=video
    profile: ProfileID = ProfileID.P2_RS26_22
    subword: SubwordMode = SubwordMode.S27
    centered: bool = True
    coset: CosetID = CosetID.C0
    width: int = 7680
    height: int = 4320
    aw: ActiveWindow = ActiveWindow(0, 0, 7680, 4320)
    fps_num: int = 0
    fps_den: int = 1
    frame_count: int = 1


def _t3v_old_header_bytes(h: T3VOldHeader) -> bytes:
    head50 = struct.pack(
        "<4sBBBBBB10I", b"T3V1", 1, h.file_type, int(h.profile) & 0xFF,
        subword_to_code(h.subword), 1 if h.centered else 0, int(h.coset),
        h.width, h.height, h.aw.x0, h.aw.y0, h.aw.w, h.aw.h,
        h.fps_num, h.fps_den, h.frame_count, 0)
    return head50 + struct.pack("<I", _crc32(head50))


def _t3v_old_frame_bytes(frame) -> bytes:
    """Per-frame record: n u32 | 9n symbol bytes | chained crc
    (old/include/t3v_io.hpp:128-142: crc32(bytes) ^ (crc32(n_le)*16777619))."""
    syms = _as_sym_frames(frame)
    n_le = struct.pack("<I", syms.shape[0])
    buf = syms.tobytes()
    crc = _crc32(buf) ^ ((_crc32(n_le) * 16777619) & 0xFFFFFFFF)
    return n_le + buf + struct.pack("<I", crc)


def t3v_old_write(path: str, header: T3VOldHeader, frames: Sequence) -> None:
    """Header + frame stream (old/include/t3v_io.hpp:97-142)."""
    hdr = dataclasses.replace(header, frame_count=len(frames))
    with open(path, "wb") as f:
        f.write(_t3v_old_header_bytes(hdr))
        for fr in frames:
            f.write(_t3v_old_frame_bytes(fr))


def t3v_old_append_frame(path: str, frame) -> None:
    """Append-friendly frame write; header frame_count is finalized by the
    caller re-writing the header (old/include/t3v_io.hpp:55 'may be 0 until
    finalize')."""
    with open(path, "ab") as f:
        f.write(_t3v_old_frame_bytes(frame))


def t3v_old_finalize_header(path: str, frame_count: int) -> None:
    """Rewrite the in-place header with the final frame_count (+ fresh CRC).

    The reference leaves frame_count 'may be 0 until finalize'
    (old/include/t3v_io.hpp:55); this is the finalize step, enabling
    append-then-finalize and resume-after-interrupt workflows
    (SURVEY.md section 5 checkpoint/resume)."""
    hdr = t3v_old_read_header(path)
    new = dataclasses.replace(hdr, frame_count=frame_count)
    with open(path, "r+b") as f:
        f.write(_t3v_old_header_bytes(new))


def t3v_old_resume_scan(path: str) -> Tuple[List[int], int]:
    """Scan a (possibly interrupted) T3V1-old file for COMPLETE frames.

    Returns (offsets, resume_pos): byte offsets of every frame whose length
    and CRC check out, and the position just after the last good frame --
    the point to truncate to and append from.  Unlike t3v_scan_and_index
    (old/include/t3v_indexed_io.hpp:70-108), a truncated or corrupt tail
    frame ends the scan instead of raising: that is exactly the state an
    interrupted encode job leaves behind."""
    t3v_old_read_header(path)  # validates magic + crc
    offsets: List[int] = []
    with open(path, "rb") as f:
        f.seek(_T3VOLD_SIZE)
        good_end = f.tell()
        while True:
            pos = f.tell()
            n_le = f.read(4)
            if len(n_le) < 4:
                break
            (n,) = struct.unpack("<I", n_le)
            buf = f.read(n * 9)
            crc_raw = f.read(4)
            if len(buf) != n * 9 or len(crc_raw) < 4:
                break
            (crc_file,) = struct.unpack("<I", crc_raw)
            crc = _crc32(buf) ^ ((_crc32(n_le) * 16777619) & 0xFFFFFFFF)
            if crc != crc_file:
                break
            offsets.append(pos)
            good_end = f.tell()
    return offsets, good_end


def t3v_old_read_header(path: str) -> T3VOldHeader:
    """old/include/t3v_io.hpp:120-126."""
    with open(path, "rb") as f:
        raw = f.read(_T3VOLD_SIZE)
    if len(raw) < _T3VOLD_SIZE:
        raise ContainerError("t3v-old: truncated header")
    (mg, ver, ftype, prof, sub_code, centered, coset,
     w, h, x0, y0, aww, awh, fn, fd, fc, _rsv, hdr_crc) = struct.unpack(
        _T3VOLD_FMT, raw)
    if mg != b"T3V1":
        raise ContainerError("t3v-old: bad magic")
    if _crc32(raw[:_T3VOLD_SIZE - 4]) != hdr_crc:
        raise ContainerError("t3v-old: header crc mismatch")
    return T3VOldHeader(ftype, ProfileID(prof), code_to_subword(sub_code),
                        bool(centered), CosetID(coset), w, h,
                        ActiveWindow(x0, y0, aww, awh), fn, fd, fc)


def t3v_old_read_frames(path: str, max_frames: Optional[int] = None
                        ) -> Tuple[T3VOldHeader, List[np.ndarray]]:
    """Sequential frame reads with per-frame CRC verification
    (old/include/t3v_io.hpp:143-159)."""
    hdr = t3v_old_read_header(path)
    frames: List[np.ndarray] = []
    with open(path, "rb") as f:
        f.seek(_T3VOLD_SIZE)
        while max_frames is None or len(frames) < max_frames:
            n_le = f.read(4)
            if len(n_le) < 4:
                break
            (n,) = struct.unpack("<I", n_le)
            buf = f.read(n * 9)
            crc_raw = f.read(4)
            if len(buf) != n * 9 or len(crc_raw) < 4:
                raise ContainerError("t3v-old: truncated frame")
            (crc_file,) = struct.unpack("<I", crc_raw)
            crc = _crc32(buf) ^ ((_crc32(n_le) * 16777619) & 0xFFFFFFFF)
            if crc != crc_file:
                raise ContainerError("t3v-old: frame crc mismatch")
            frames.append(np.frombuffer(buf, dtype=np.uint8)
                          .reshape(n, 9).astype(np.int8))
    return hdr, frames


# ---------------------------------------------------------------------------
# F7: T3VI index sidecar
# ---------------------------------------------------------------------------

_T3VI_FMT = "<4sBIII"  # 17 bytes packed
_T3VI_SIZE = struct.calcsize(_T3VI_FMT)
assert _T3VI_SIZE == 17


def t3vi_write(idx_path: str, offsets: Sequence[int]) -> None:
    """old/include/t3v_indexed_io.hpp:25-39."""
    head13 = struct.pack("<4sBII", b"T3VI", 1, len(offsets), 0)
    with open(idx_path, "wb") as f:
        f.write(head13 + struct.pack("<I", _crc32(head13)))
        f.write(np.asarray(offsets, dtype="<u8").tobytes())


def t3vi_read(idx_path: str) -> List[int]:
    """old/include/t3v_indexed_io.hpp:40-68."""
    with open(idx_path, "rb") as f:
        raw = f.read(_T3VI_SIZE)
        if len(raw) < _T3VI_SIZE:
            raise ContainerError("t3vi: truncated header")
        mg, ver, fc, _rsv, hdr_crc = struct.unpack(_T3VI_FMT, raw)
        if mg != b"T3VI":
            raise ContainerError("t3vi: bad magic")
        if _crc32(raw[:_T3VI_SIZE - 4]) != hdr_crc:
            raise ContainerError("t3vi: header crc mismatch")
        buf = f.read(fc * 8)
        if len(buf) != fc * 8:
            raise ContainerError("t3vi: truncated offsets")
    return list(np.frombuffer(buf, dtype="<u8"))


def t3v_scan_and_index(t3v_path: str, idx_path: str) -> int:
    """Rebuild the frame-offset index by scanning a T3V1-old file
    (old/include/t3v_indexed_io.hpp:70-108).  Returns frame count."""
    t3v_old_read_header(t3v_path)  # validates magic + crc
    offsets: List[int] = []
    with open(t3v_path, "rb") as f:
        f.seek(_T3VOLD_SIZE)
        while True:
            pos = f.tell()
            n_le = f.read(4)
            if len(n_le) < 4:
                break
            (n,) = struct.unpack("<I", n_le)
            f.seek(n * 9, 1)
            if len(f.read(4)) < 4:  # crc record
                break
            offsets.append(pos)
    t3vi_write(idx_path, offsets)
    return len(offsets)


# ---------------------------------------------------------------------------
# F5: T3PT (.t3proto) lab container
# ---------------------------------------------------------------------------


class ProtoProfile(enum.IntEnum):
    """include/codec_profiles.hpp prototype selector (io_t3proto.hpp:15)."""
    NONE = 0
    HAAR_TERNARY = 1
    ANISO_RC = 2


F_PACK_PRESENT = 1 << 0
F_BAL_PRESENT = 1 << 1


def meta_find_int(meta: str, key: str) -> Optional[int]:
    """Naive JSON-lite uint lookup (include/io_t3proto.hpp:125-145)."""
    pos = meta.find(f'"{key}"')
    if pos < 0:
        return None
    pos = meta.find(":", pos)
    if pos < 0:
        return None
    pos += 1
    while pos < len(meta) and meta[pos] in " \t":
        pos += 1
    digits = ""
    while pos < len(meta) and meta[pos].isdigit():
        digits += meta[pos]
        pos += 1
    return int(digits) if digits else None


def infer_ntrits_from_meta(w: int, h: int, meta: str, packed_bytes: int) -> int:
    """n_trits inference chain (include/io_t3proto.hpp:148-183):
    n_trits -> len_tiles+len_sketch -> trits_per_block*blocks -> tail_trits
    -> 5*bytes upper bound."""
    v = meta_find_int(meta, "n_trits")
    if v:
        return v
    lt = meta_find_int(meta, "len_tiles")
    ls = meta_find_int(meta, "len_sketch")
    if lt is not None or ls is not None:
        s = (lt or 0) + (ls or 0)
        if s > 0:
            return s
    tpb = meta_find_int(meta, "trits_per_block")
    blk = meta_find_int(meta, "block")
    if tpb is not None and blk:
        bx = -(-w // blk)
        by = -(-h // blk)
        if tpb * bx * by > 0:
            return tpb * bx * by
    tail = meta_find_int(meta, "tail_trits")
    if tail is not None:
        if packed_bytes == 0:
            return 0
        if tail == 0:
            return packed_bytes * 5
        if tail <= 5:
            return (packed_bytes - 1) * 5 + tail
    return packed_bytes * 5


def t3proto_write(path: str, profile: ProtoProfile, w: int, h: int,
                  balanced_trits=None, packed_bytes=None,
                  meta_json: str = "") -> None:
    """include/io_t3proto.hpp:186-254.  balanced trits are {-1,0,1} int8,
    stored on disk as unbalanced bytes {0,1,2}."""
    bal = (np.asarray(balanced_trits, dtype=np.int8).reshape(-1)
           if balanced_trits is not None else np.zeros(0, np.int8))
    pack = (np.asarray(packed_bytes, dtype=np.uint8).reshape(-1)
            if packed_bytes is not None else np.zeros(0, np.uint8))
    has_bal, has_pack = bal.size > 0, pack.size > 0
    flags = (F_PACK_PRESENT if has_pack else 0) | (F_BAL_PRESENT if has_bal else 0)
    meta = meta_json.encode("utf-8")
    n_trits = (bal.size if has_bal
               else (infer_ntrits_from_meta(w, h, meta_json, pack.size)
                     if has_pack else 0))
    with open(path, "wb") as f:
        f.write(b"T3PT")
        f.write(struct.pack("<BBHII", 1, int(profile), flags, w, h))
        f.write(struct.pack("<QQI", n_trits, pack.size, len(meta)))
        f.write(meta)
        if has_bal:
            # strict balanced->unbalanced: bal+1 with clamp
            f.write((np.clip(bal, -1, 1) + 1).astype(np.uint8).tobytes())
        if has_pack:
            f.write(pack.tobytes())


def t3proto_peek(path: str) -> Tuple[ProtoProfile, int, int, int, int, int,
                                     str]:
    """Header-only peek -> (profile, w, h, flags, n_trits, n_bytes, meta).

    Reads the fixed header + meta JSON and never touches the payload
    streams -- O(header + meta) like the reference's header-peek path
    (src/t3proto_tool.cpp info subcommand), not O(file)."""
    with open(path, "rb") as f:
        if f.read(4) != b"T3PT":
            raise ContainerError("t3proto: bad magic")
        ver, prof, flags, w, h = struct.unpack("<BBHII", f.read(12))
        if ver != 1:
            raise ContainerError("t3proto: unsupported version")
        n_trits, n_bytes, meta_len = struct.unpack("<QQI", f.read(20))
        raw_meta = f.read(meta_len) if meta_len else b""
        if len(raw_meta) != meta_len:
            raise ContainerError("t3proto: truncated meta")
        try:
            meta = raw_meta.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ContainerError(f"t3proto: bad meta encoding: {e}")
    return ProtoProfile(prof), w, h, flags, n_trits, n_bytes, meta


def t3proto_read(path: str, want_balanced: bool = True, want_packed: bool = True
                 ) -> Tuple[ProtoProfile, int, int,
                            Optional[np.ndarray], Optional[np.ndarray], str]:
    """include/io_t3proto.hpp:257-352 ->
    (profile, w, h, balanced|None, packed|None, meta_json)."""
    with open(path, "rb") as f:
        if f.read(4) != b"T3PT":
            raise ContainerError("t3proto: bad magic")
        ver, prof, flags, w, h = struct.unpack("<BBHII", f.read(12))
        if ver != 1:
            raise ContainerError("t3proto: unsupported version")
        n_trits, n_bytes, meta_len = struct.unpack("<QQI", f.read(20))
        raw_meta = f.read(meta_len) if meta_len else b""
        if len(raw_meta) != meta_len:
            raise ContainerError("t3proto: truncated meta")
        try:
            meta = raw_meta.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ContainerError(f"t3proto: bad meta encoding: {e}")
        bal = pack = None
        if flags & F_BAL_PRESENT:
            buf = f.read(n_trits)
            if len(buf) != n_trits:
                raise ContainerError("t3proto: truncated balanced stream")
            if want_balanced:
                u = np.frombuffer(buf, dtype=np.uint8).astype(np.int16)
                # unbalanced->balanced: u-1, out-of-range -> 0
                # (include/codec_profiles.hpp:73-81 semantics)
                u = np.where(u > 2, 1, u)
                bal = (u - 1).astype(np.int8)
        if flags & F_PACK_PRESENT:
            buf = f.read(n_bytes)
            if len(buf) != n_bytes:
                raise ContainerError("t3proto: truncated packed stream")
            if want_packed:
                pack = np.frombuffer(buf, dtype=np.uint8).copy()
    return ProtoProfile(prof), w, h, bal, pack, meta
