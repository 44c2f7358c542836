"""Production serving path: device codec <-> T3V6 containers on disk.

The port of the JAX package's ``io/serve.py``.  This is the layer the
reference ships as its product -- files on disk
(src/io_t3p_t3v.cpp:220-389) -- wired to the card's codec with the host
kept off the hot byte path:

  encode serve:  RAW chunks -> [device] stream encode + base-243 wire
                 pack (ops/wirepack.py) -> ONE D2H per frame -> host
                 CRC32 + sequential container write
  decode serve:  indexed, approve-gated frame read + CRC32 check -> ONE
                 H2D per frame -> [device] unpack + check decode (K1,
                 its beacon and P5 specialisations on those layouts)

Both directions run through runtime/executor.StreamExecutor, so host IO
of frame i+1 overlaps device work on frame i.

The T3V6 layout is byte-exact with io/containers.py (same struct packs,
same CRC32 conventions, same meta-approval gate semantics: per-frame
meta must be approved BEFORE any payload byte is read,
include/io_t3p_t3v.hpp:35-55).  Every frame of a serve stream has the
same payload size, so the index is written up front (no second pass).
"""
from __future__ import annotations

import json
import struct
from typing import Optional

import torch

from ..codec import codec_for
from ..config import SubwordMode
from ..ops import wirepack
from .containers import (ApproveMetaFn, ContainerError, T3VFrameIndex,
                         _crc32, _t3v_hdr_crc)


class T3V6StreamWriter:
    """Streaming T3V6 writer for fixed-size frames (index up front).

    write_frame(i, payload_bytes) may be called once per i in any order
    (offsets are precomputed); payload length must equal frame_bytes.
    """

    def __init__(self, path: str, sub: SubwordMode, w: int, h: int,
                 n_frames: int, frame_bytes: int, meta_global: str = "",
                 meta_per_frame: str = ""):
        if frame_bytes % 4:
            raise ContainerError("serve frame payload must be 4-aligned "
                                 "(uint32 word ABI)")
        self.n_frames = n_frames
        self.frame_bytes = frame_bytes
        self._meta_f = meta_per_frame.encode("utf-8")
        metag = meta_global.encode("utf-8")
        self._f = open(path, "wb")
        f = self._f
        f.write(b"T3V6")
        f.write(struct.pack("<BBHHQI", 6, int(sub), w, h, n_frames,
                            len(metag)))
        f.write(struct.pack(
            "<I", _t3v_hdr_crc(6, int(sub), w, h, n_frames, len(metag))))
        f.write(metag)
        idx_pos = f.tell()
        data_start = idx_pos + 20 * n_frames
        rec = len(self._meta_f) + frame_bytes + 4
        self._offsets = [data_start + i * rec for i in range(n_frames)]
        for off in self._offsets:
            f.write(struct.pack("<QQI", off, frame_bytes // 4,
                                len(self._meta_f)))
        self._written = 0

    def write_frame(self, idx: int, payload) -> None:
        """payload: any contiguous buffer (bytes, memoryview, uint8
        ndarray, a pinned host tensor's ``.numpy()``) of length <=
        frame_bytes; the remainder is zero-padded.  Buffer-protocol input
        spares a per-frame tobytes() copy of the whole frame."""
        mv = memoryview(payload).cast("B")
        if len(mv) > self.frame_bytes:
            raise ContainerError("serve frame payload size mismatch")
        pad = self.frame_bytes - len(mv)
        f = self._f
        f.seek(self._offsets[idx])
        f.write(self._meta_f)
        f.write(mv)
        crc = _crc32(mv)
        if pad:
            zeros = b"\0" * pad
            f.write(zeros)
            crc = _crc32(zeros, crc)
        f.write(struct.pack("<I", crc & 0xFFFFFFFF))
        self._written += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class T3V6StreamReader:
    """Indexed T3V6 frame reader: header parsed ONCE, per-frame
    approve-gated payload reads (containers.t3v_read_frame re-parses the
    whole header + index per call -- fine for random access, wrong shape
    for serving N frames)."""

    def __init__(self, path: str,
                 approve_meta: Optional[ApproveMetaFn] = None,
                 check_header_crc: bool = True):
        self._f = open(path, "rb")
        f = self._f
        if f.read(4) != b"T3V6":
            raise ContainerError("t3v: bad magic")
        ver, sub, w, h, fc, mg = struct.unpack("<BBHHQI", f.read(18))
        (hdr_crc,) = struct.unpack("<I", f.read(4))
        if check_header_crc and _t3v_hdr_crc(ver, sub, w, h, fc, mg) != hdr_crc:
            raise ContainerError("t3v: header crc mismatch")
        self.sub, self.w, self.h = SubwordMode(sub), w, h
        self.meta_global = f.read(mg).decode("utf-8") if mg else ""
        self.frame_count = fc
        self.index = []
        for _ in range(fc):
            off, words, ml = struct.unpack("<QQI", f.read(20))
            self.index.append(T3VFrameIndex(off, words, ml))
        self._approve = approve_meta

    def _approved_frame(self, i: int) -> T3VFrameIndex:
        """Seek to frame i's meta, read and approve it; the file is left
        at the first payload byte, none of which has been read."""
        if i >= self.frame_count:
            raise ContainerError("t3v: frame idx OOB")
        fi = self.index[i]
        f = self._f
        f.seek(fi.offset)
        meta = f.read(fi.meta_len).decode("utf-8") if fi.meta_len else ""
        if self._approve is not None and not self._approve(meta):
            raise ContainerError(
                "t3v: meta not approved -- frame payload not read")
        return fi

    def _check_crc(self, fi: T3VFrameIndex, payload, check_crc: bool) -> None:
        (pl_crc,) = struct.unpack("<I", self._f.read(4))
        if check_crc and pl_crc != (_crc32(payload) if fi.words else 0):
            raise ContainerError("t3v: frame payload crc mismatch")

    def read_frame_bytes(self, i: int, check_crc: bool = True) -> bytes:
        fi = self._approved_frame(i)
        payload = self._f.read(fi.words * 4)
        if len(payload) != fi.words * 4:
            raise ContainerError("t3v: truncated frame payload")
        self._check_crc(fi, payload, check_crc)
        return payload

    def read_frame_into(self, i: int, out, check_crc: bool = True
                        ) -> memoryview:
        """``read_frame_bytes`` into a caller's writable contiguous buffer
        (a pinned host tensor's ``.numpy()`` for a non-blocking H2D) of at
        least the frame's payload size; returns the payload's view of it."""
        fi = self._approved_frame(i)
        n = fi.words * 4
        mv = memoryview(out).cast("B")
        if len(mv) < n:
            raise ContainerError(f"t3v: buffer of {len(mv)} bytes for a "
                                 f"{n}-byte frame payload")
        mv = mv[:n]
        if self._f.readinto(mv) != n:
            raise ContainerError("t3v: truncated frame payload")
        self._check_crc(fi, mv, check_crc)
        return mv

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# device serve codecs
# ---------------------------------------------------------------------------


def checksum(planes: torch.Tensor) -> torch.Tensor:
    """Order-sensitive fold of (n, ...) planes to a 0-d int32 tensor (a
    plain sum is permutation-blind): sum(x * ((column % 8191) + 1)) over
    the flattened rows, wrapped to int32 as the reference's int32 sum
    wraps.  torch sums int32 into int64, so the exact sum is taken mod
    2^32 and read back as a signed int32."""
    x = planes.reshape(planes.shape[0], -1)
    w = torch.arange(x.shape[1], dtype=torch.int32, device=x.device) % 8191 + 1
    s = (x.to(torch.int32) * w).sum(dtype=torch.int64)
    return ((s + 2**31) % 2**32 - 2**31).to(torch.int32)


def serve_codec_fns(cfg, n_raw: int, sf_batch: int = 128, device=None):
    """Build (enc_serve, dec_serve, geometry) for one (config, frame size)
    on ``device`` (default: the current CUDA device; raises without one).

    enc_serve: (n_sf, sf, 9) int8 RAW chunks -> ((n_sf, sf_bytes) uint8
               packed wire bytes, checksum of the wire planes)
    dec_serve: (n_sf, >= sf_bytes) uint8 -> (ok, wire checksum, out
               checksum): unpack, check decode (on the card K1, one
               launch for the frame, where one of its specialisations
               covers the layout, else the plain grid check; and the
               header byte compare) and the
               exactness checksums; the decoded planes stay on the device,
               the checksum pins them
    Checksums are 0-d int32 tensors, ok a 0-d bool tensor, all on the
    device; nothing here waits for the device.
    """
    codec = codec_for(cfg, device)
    sf = cfg.superframe_words
    n_sf = -(-n_raw // sf)
    total = codec.layout.total_words
    nbytes = wirepack.sf_bytes(total)

    def enc_serve(chunks):
        w = codec.encode(chunks, sf_batch)
        return wirepack.pack_wire(w), checksum(w)

    def dec_serve(by):
        w = wirepack.unpack_wire(by.to(codec.device), total)
        out, ok = codec.check(w, sf_batch)
        return ok.all(), checksum(w), checksum(out)

    geom = {"n_sf": n_sf, "total_words": total, "sf_bytes": nbytes,
            "frame_bytes": -(-n_sf * nbytes // 4) * 4,
            "n_out_words": codec.dlayout.n_out_words}
    return enc_serve, dec_serve, geom


def serve_meta_global(cfg, n_raw: int, w: int, h: int,
                      extra: Optional[dict] = None) -> str:
    d = {"codec": "t3tpu-profile-wire-v1", "profile": int(cfg.profile),
         "n_raw": n_raw, "sf_words": cfg.superframe_words,
         "width": w, "height": h}
    if extra:
        d.update(extra)
    return json.dumps(d)
