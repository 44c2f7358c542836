"""main — image -> RAW word9 -> P2 profile encode -> .t3v (old rich) frame +
PNG roundtrip (old/src/main.cpp:11-30).  The quantization, the profile
encode and decode (P2 with a 64x64 tile and a beacon; the decode is the
paged corrector, K2 for the header chain and every band's repair) run on
``--device`` (default: the current CUDA device)."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..codec import resolve_device
from ..config import (EncoderConfig, ProfileID, SparseBeaconCfg, SubwordMode,
                      Tile2D, centered_window, std_res_for)
from ..io import image as I
from ..io import legacy_containers as LC
from ..ops import pipeline as PL
from ..ops import quant as Q
from ..ops import wordcodec as WC
from . import add_device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="main",
                                 description="image -> profile .t3v + "
                                             "roundtrip PNG")
    ap.add_argument("input")
    ap.add_argument("output", help="out .t3v path")
    ap.add_argument("--roundtrip-png", default="roundtrip.png")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rgb = torch.as_tensor(I.load_image_rgb8(args.input), device=dev)
    h, w = rgb.shape[0], rgb.shape[1]
    raw = WC.quant_to_words9(Q.rgb_to_quant(rgb).reshape(-1, 3))  # 2 px/word

    cfg = EncoderConfig(profile=ProfileID.P2_RS26_22, tile=Tile2D(64, 64),
                        beacon=SparseBeaconCfg(26, 2, True))
    prof = PL.encode_profile_from_raw(raw, cfg, device=dev).cpu().numpy()

    sw, sh = std_res_for(SubwordMode.S27)
    hdr = LC.T3VOldHeader(file_type=0, profile=cfg.profile,
                          subword=cfg.subword, centered=cfg.centered,
                          coset=cfg.coset, width=sw, height=sh,
                          aw=centered_window(SubwordMode.S27), fps_num=0,
                          fps_den=1)
    LC.t3v_old_write(args.output, hdr, [prof])

    # roundtrip for visual check (old/src/main.cpp:25-28)
    _hdr2, frames = LC.t3v_old_read_frames(args.output)
    raw2, _sfhdr, ok = PL.decode_profile_to_raw(
        np.asarray(frames[0], dtype=np.int8), device=dev)
    if not ok:
        print("decode failed")
        return 1
    qs = WC.words9_to_quant(raw2, n_pixels=w * h)
    I.save_image_png(args.roundtrip_png, Q.quant_to_rgb(qs).reshape(h, w, 3))
    print(f"OK. wrote {args.output} and {args.roundtrip_png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
