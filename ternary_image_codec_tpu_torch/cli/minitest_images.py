"""minitest_images — image-pipeline tests on a REAL input image, with a
--matrix sweep over (subword, codec) and CRC-12 payload signatures
(src/minitest_images.cpp:66-206).  The bridge runs on ``--device``
(default: the current CUDA device); the signatures are host code."""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..codec import resolve_device
from ..config import SubwordMode
from ..io import image as I
from ..ops import quant as Q
from . import add_device_arg
from .sigs import crc12_0x80F, parity_mod3


def _run_one(rgb: torch.Tensor, sub: SubwordMode, codec: str, tol: int,
             device) -> dict:
    words, (w, h) = I.rgb_to_words(rgb, sub, centered=False, codec=codec,
                                   device=device)
    out = I.words_to_rgb(words, sub, w, h, codec=codec, device=device)
    wn = words.cpu().numpy()
    raw = (wn.astype("<u4").tobytes() if codec == "word13"
           else wn.astype(np.uint8).tobytes())
    # roundtrip fidelity vs the (resized) source, like the reference's
    # tolerance check (src/minitest_images.cpp Test A semantics)
    src = Q.resize_nn(rgb, h, w)
    diff = int((out.to(torch.int32) - src.to(torch.int32)).abs().max())
    # the signatures cover the whole payload (src/minitest_images.cpp:160-206)
    return {
        "mode": sub.name, "codec": codec, "w": w, "h": h,
        "words": int(wn.shape[0]),
        "crc12": f"{crc12_0x80F(raw):03X}",
        "parity3": parity_mod3(raw),
        "max_diff": diff,
        "ok": diff <= tol,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minitest_images")
    ap.add_argument("--in", dest="infile", required=True)
    ap.add_argument("--matrix", action="store_true",
                    help="sweep all subword modes x codecs")
    ap.add_argument("--mode", default="S15")
    ap.add_argument("--codec", default="word13", choices=["word13", "word9"])
    ap.add_argument("--tol", type=int, default=4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rgb = torch.as_tensor(I.load_image_rgb8(args.infile), device=dev)
    if args.matrix:
        # every subword mode x both word codecs (the reference's --matrix
        # covers its whole mode set, src/minitest_images.cpp:160-206)
        combos = [(s, c) for s in (SubwordMode.S15, SubwordMode.S18,
                                   SubwordMode.S21, SubwordMode.S24,
                                   SubwordMode.S27)
                  for c in ("word13", "word9")]
    else:
        combos = [(SubwordMode[args.mode], args.codec)]
    tests = [_run_one(rgb, s, c, args.tol, dev) for s, c in combos]
    all_ok = all(t["ok"] for t in tests)
    print(json.dumps({"report": {
        "input": args.infile, "tests": tests,
        "final_status": "PASS" if all_ok else "CHECK"}}, indent=2))
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
