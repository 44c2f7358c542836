"""minitest_codec — image-pipeline integration tests A/B/C with a JSON
report (src/minitest_codec.cpp:28-214).

A: RAW-N roundtrip with RGB tolerance +-4.
B: centered canvas — 16-px black borders around the embedded inner window.
C: centered-window consistency (the reference's upscale comparison could
   never hold; the preserved invariant is center-window equality with the
   direct encode, as the JAX package's tool checks it).

The bridge runs on ``--device`` (default: the current CUDA device).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..codec import resolve_device
from ..config import SubwordMode, std_res_for
from ..io import image as I
from ..ops import quant as Q
from ..ops import wordcodec as WC
from . import add_device_arg


def make_rgb_pattern(w, h, c1=(32, 200, 64), c2=(200, 32, 220)):
    y, x = np.mgrid[0:h, 0:w]
    a = ((x // 8 + y // 8) % 2) == 0
    return np.where(a[..., None], np.array(c1, np.uint8),
                    np.array(c2, np.uint8)).astype(np.uint8)


def test_a(sub: SubwordMode, codec: str, device) -> dict:
    w, h = std_res_for(sub)
    rgb = torch.as_tensor(make_rgb_pattern(w, h), device=device)
    words, (ww, hh) = I.rgb_to_words(rgb, sub, centered=False, codec=codec,
                                     device=device)
    out = I.words_to_rgb(words, sub, ww, hh, codec=codec, device=device)
    diff = int((out.to(torch.int32) - rgb.to(torch.int32)).abs().max())
    return {"mode": sub.name, "max_diff": diff, "ok": diff <= 4}


def _canvas_words(rgb: torch.Tensor, outer: SubwordMode):
    wout, hout = std_res_for(outer)
    canvas = Q.blit_center(rgb, hout, wout)
    q = Q.rgb_to_quant(canvas).reshape(-1, 3)
    return WC.encode_raw_pixels_to_words_subword(q, outer), wout, hout


def test_b(outer: SubwordMode, inner: SubwordMode, device) -> dict:
    win, hin = std_res_for(inner)
    rgb_in = torch.as_tensor(make_rgb_pattern(win, hin, (255, 0, 0),
                                              (0, 0, 255)), device=device)
    words, wout, hout = _canvas_words(rgb_in, outer)
    out = I.words_to_rgb(words, outer, wout, hout, device=device)
    m = 16
    borders_black = bool((out[:m] == 0).all() and (out[-m:] == 0).all()
                         and (out[:, :m] == 0).all()
                         and (out[:, -m:] == 0).all())
    return {"outer": outer.name, "inner": inner.name,
            "borders_black": borders_black, "ok": borders_black}


def test_c(small: SubwordMode, big: SubwordMode, device) -> dict:
    ws, hs = std_res_for(small)
    rgb = torch.as_tensor(make_rgb_pattern(ws, hs, (20, 200, 40),
                                           (210, 30, 230)), device=device)
    direct_words, _ = I.rgb_to_words(rgb, small, centered=False,
                                     device=device)
    direct = I.words_to_rgb(direct_words, small, ws, hs, device=device)
    words, wb, hb = _canvas_words(rgb, big)
    out = I.words_to_rgb(words, big, wb, hb, device=device)
    y0, x0 = (hb - hs) // 2, (wb - ws) // 2
    ok = bool(torch.equal(out[y0:y0 + hs, x0:x0 + ws], direct))
    return {"small": small.name, "big": big.name,
            "center_equals_direct": ok, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minitest_codec")
    ap.add_argument("--codec", default="word13", choices=["word13", "word9"])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    a = [test_a(SubwordMode.S15, args.codec, dev)]
    b = [test_b(SubwordMode.S18, SubwordMode.S15, dev)]
    c = [test_c(SubwordMode.S15, SubwordMode.S18, dev)]
    all_ok = all(t["ok"] for t in a + b + c)
    print(json.dumps({"report": {
        "A_rawN_roundtrip": a,
        "B_centered_canvas": b,
        "C_centered_consistency": c,
        "final_status": "PASS" if all_ok else "CHECK"}}, indent=2))
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
