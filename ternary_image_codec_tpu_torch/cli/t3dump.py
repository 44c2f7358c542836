"""t3dump — .t3p / .t3v inspector + PNG frame extraction.

Parity with src/t3dump.cpp:5-31 (flags) and :160-306 (report fields):
  t3dump file.t3p [--json]
  t3dump file.t3p --extract-png 0 --out out.png
  t3dump file.t3v --extract-png all --outdir ./frames

Signatures: CRC-12(0x80F) and mod-3 parity over the raw 4-byte-LE Word27
payload bytes; t3v combines per-frame CRCs by XOR and parities by mod-3 sum
(src/t3dump.cpp:239-247).  PNG extraction decodes on ``--device``
(default: the current CUDA device).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..codec import resolve_device
from ..config import SubwordMode
from ..io import containers as C
from ..io import image as I
from . import add_device_arg
from .sigs import crc12_0x80F, parity_mod3


def _mname(sub: SubwordMode) -> str:
    return {SubwordMode.S27: "S27", SubwordMode.S24: "S24",
            SubwordMode.S21: "S21", SubwordMode.S18: "S18",
            SubwordMode.S15: "S15"}.get(sub, "S27")


def _raw_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype="<u4").tobytes()


def _dump_t3p(args) -> int:
    sub, w, h, meta, _n = C.t3p_read_header(args.path,
                                            check_header_crc=False)
    words = C.t3p_read_payload(args.path, check_header_crc=False)
    raw = _raw_bytes(words)
    crc = crc12_0x80F(raw)
    p3 = parity_mod3(raw)
    if args.json:
        print(json.dumps({"t3p": {
            "file": args.path, "mode": _mname(sub), "w": w, "h": h,
            "words": int(words.size), "crc12_raw": f"{crc:03X}",
            "parity3": p3, "meta_len": len(meta)}}, indent=2))
    else:
        print(f"== .t3p ==\nfile: {args.path}\nmode: {_mname(sub)}\n"
              f"size: {w} x {h}\nwords: {words.size} (bytes={len(raw)})\n"
              f"crc12(raw): 0x{crc:03X}\nparity3(raw): {p3}\n"
              f"meta: {len(meta)} bytes")
    if args.extract is not None:
        if args.extract != "all" and int(args.extract) != 0:
            print("[t3dump] .t3p has only frame 0", file=sys.stderr)
            return 1
        out = (os.path.join(args.outdir, "frame_0000.png")
               if args.extract == "all" else args.out)
        I.words_to_image_subword(words, sub, w, h, out, device=args.device)
        if not args.json:
            print(f"extracted -> {out}")
    return 0


def _dump_t3v(args) -> int:
    sub, w, h, metag, fc, index = C.t3v_read_header(args.path,
                                                    check_header_crc=False)
    frames = [C.t3v_read_frame(args.path, i, check_header_crc=False)
              for i in range(fc)]
    total_words = sum(int(f.size) for f in frames)
    total_bytes = total_words * 4
    crc_glob, p3_glob = 0, 0
    for f in frames:
        raw = _raw_bytes(f)
        crc_glob ^= crc12_0x80F(raw)
        p3_glob = (p3_glob + parity_mod3(raw)) % 3
    fps = 0.0  # T3V6 has no fps field; kept for report-shape parity
    if args.json:
        print(json.dumps({"t3v": {
            "file": args.path, "mode": _mname(sub), "w": w, "h": h,
            "frames": fc, "fps": fps, "words_total": total_words,
            "bytes_total": total_bytes,
            "crc12_concat_xor": f"{crc_glob:03X}",
            "parity3_sum": p3_glob, "meta_len": len(metag)}}, indent=2))
    else:
        print(f"== .t3v ==\nfile: {args.path}\nmode: {_mname(sub)}  fps: {fps}\n"
              f"size: {w} x {h}\nframes: {fc}\n"
              f"words_total: {total_words}  bytes_total: {total_bytes}\n"
              f"crc12(concat^): 0x{crc_glob:03X}\nparity3(sum): {p3_glob}\n"
              f"meta: {len(metag)} bytes")
    if args.extract is not None:
        if args.extract == "all":
            os.makedirs(args.outdir, exist_ok=True)
            for i, f in enumerate(frames):
                name = os.path.join(args.outdir, f"frame_{i:04d}.png")
                I.words_to_image_subword(f, sub, w, h, name,
                                         device=args.device)
            if not args.json:
                print(f"extracted {fc} frames -> {args.outdir}/frame_####.png")
        else:
            idx = min(max(int(args.extract), 0), fc - 1)
            I.words_to_image_subword(frames[idx], sub, w, h, args.out,
                                     device=args.device)
            if not args.json:
                print(f"extracted frame {idx} -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="t3dump", description=".t3p/.t3v info + PNG extraction")
    ap.add_argument("path")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--extract-png", dest="extract", default=None,
                    metavar="IDX|all")
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--outdir", default=".")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.path.endswith(".t3p"):
        return _dump_t3p(args)
    if args.path.endswith(".t3v"):
        return _dump_t3v(args)
    print("[t3dump] unsupported extension (expect .t3p or .t3v)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
