"""minitest_t3containers — .t3p/.t3v container tests with a JSON report
(reference parity: src/minitest_t3containers.cpp:100-185).

Per subword mode: synthesize a checkerboard frame, encode to RAW words,
CRC-12(0x80F) signature over the raw little-endian word bytes (the
reference signs `words.data()` bytes, src/minitest_t3containers.cpp:123-125),
T3P6 write -> read -> equality.  Then a 3-frame S21 .t3v sequence
(src/minitest_t3containers.cpp:153-180).  fps travels in the global meta
JSON: the reference CLI calls a `t3v_read(..., fps, ...)` overload that no
longer exists in its own T3Container API (API drift, SURVEY.md §0.2 /
§2.7 B4); T3V6 has no fps header field, so the JSON meta carries it.

Exit status 0 on PASS, 1 on CHECK (same as the reference binary).  The
frames are encoded on ``--device`` (default: the current CUDA device).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..codec import resolve_device
from ..config import SubwordMode, std_res_for
from ..io import containers as C
from ..io import image as I
from . import add_device_arg
from .sigs import crc12_0x80F

_ALL_MODES = ("S27", "S24", "S21", "S18", "S15")


def make_rgb_pattern(w: int, h: int) -> np.ndarray:
    """8x8 checkerboard, the reference's make_rgb_pattern
    (src/minitest_t3containers.cpp:56-65)."""
    y, x = np.mgrid[0:h, 0:w]
    a = ((x // 8 + y // 8) % 2) == 0
    c1 = np.array([220, 40, 50], np.uint8)
    c2 = np.array([30, 210, 230], np.uint8)
    return np.where(a[..., None], c1, c2).astype(np.uint8)


def make_words_for(sub: SubwordMode, device):
    w, h = std_res_for(sub)
    rgb = make_rgb_pattern(w, h)
    words, (ww, hh) = I.rgb_to_words(rgb, sub, centered=False, codec="word13",
                                     device=device)
    return words.cpu().numpy().astype(np.uint32), ww, hh


def _t3p_case(sub: SubwordMode, outdir: str, device) -> dict:
    words, w, h = make_words_for(sub, device)
    raw = words.astype("<u4").tobytes()
    crc12 = crc12_0x80F(raw)
    path = os.path.join(outdir, f"test_{sub.name}.t3p")
    ok_write = ok_read = ok_eq = False
    try:
        C.t3p_write(path, sub, w, h, words, '{"gen":"minitest"}')
        ok_write = True
        sub_r, wr, hr, _meta, _n = C.t3p_read_header(path)
        back = C.t3p_read_payload(path)
        ok_read = True
        ok_eq = (sub_r == sub and wr == w and hr == h
                 and np.array_equal(back, words))
    except C.ContainerError:
        pass
    return {"mode": sub.name, "w": w, "h": h, "words": int(words.size),
            "crc12_raw": f"{crc12:03X}", "write": ok_write,
            "read": ok_read, "equal": ok_eq}


def _t3v_case(outdir: str, device, n_frames: int = 3) -> dict:
    sub = SubwordMode.S21
    frames, w, h = [], 0, 0
    for _ in range(n_frames):
        words, w, h = make_words_for(sub, device)
        frames.append(words)
    path = os.path.join(outdir, "test_S21.t3v")
    fps_w, fps_r = 25.0, 0.0
    ok_write = ok_read = ok_frames = False
    try:
        C.t3v_write(path, sub, w, h, frames,
                    json.dumps({"seq": "minitest", "fps": fps_w}))
        ok_write = True
        sub_r, wr, hr, metag, fc, _idx = C.t3v_read_header(path)
        back = [C.t3v_read_frame(path, i) for i in range(fc)]
        ok_read = True
        fps_r = float(json.loads(metag).get("fps", 0.0)) if metag else 0.0
        ok_frames = (sub_r == sub and wr == w and hr == h
                     and len(back) == len(frames)
                     and all(np.array_equal(a, b)
                             for a, b in zip(back, frames)))
    except (C.ContainerError, ValueError):
        pass
    return {"mode": sub.name, "w": w, "h": h, "frames": len(frames),
            "write": ok_write, "read": ok_read, "equal": ok_frames,
            "fps_w": fps_w, "fps_r": fps_r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minitest_t3containers")
    ap.add_argument("--modes", default=",".join(_ALL_MODES),
                    help="comma-separated subword modes to sweep")
    ap.add_argument("--outdir", default=None,
                    help="where to write test containers (default: tmpdir)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    modes = [SubwordMode[m.strip()] for m in args.modes.split(",") if m.strip()]

    def run(outdir: str) -> int:
        t3p = [_t3p_case(sub, outdir, dev) for sub in modes]
        t3v = _t3v_case(outdir, dev)
        all_ok = (all(t["write"] and t["read"] and t["equal"] for t in t3p)
                  and t3v["write"] and t3v["read"] and t3v["equal"])
        print(json.dumps({"t3containers": {
            "available": True, "t3p": t3p, "t3v": t3v,
            "final_status": "PASS" if all_ok else "CHECK"}}, indent=2))
        return 0 if all_ok else 1

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        return run(args.outdir)
    with tempfile.TemporaryDirectory(prefix="t3containers_") as d:
        return run(d)


if __name__ == "__main__":
    raise SystemExit(main())
