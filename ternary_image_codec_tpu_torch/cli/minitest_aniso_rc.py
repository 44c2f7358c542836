"""minitest_aniso_rc — AnisoRC encode -> pack -> reconstruct QA with
PSNR-Y / bpp report (src/minitest_aniso_rc.cpp:80-130).  The prototype,
its reconstruction and the grey PNG's colour conversion run on
``--device`` (default: the current CUDA device)."""
from __future__ import annotations

import argparse
import json

import torch

from .. import profiles as PR
from ..codec import resolve_device
from ..io import image as I
from ..ops import proto as P
from ..ops import quant as Q
from . import add_device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minitest_aniso_rc")
    ap.add_argument("--in", dest="infile", required=True)
    ap.add_argument("--png", default="aniso_recon.png")
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--angles", type=int, default=8)
    ap.add_argument("--z", type=float, default=1.2)
    ap.add_argument("--json", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rgb = torch.as_tensor(I.load_image_rgb8(args.infile), device=dev)
    params = P.AnisoRCParams(block=args.block, angles=args.angles,
                             tern_thresh_z=args.z)
    art = P.proto_aniso_rc_encode(rgb, params, dev)
    packed = PR.pack_base243_from_balanced(art.trits.cpu().numpy())
    yrec = P.proto_aniso_rc_reconstruct(art, params, device=dev)

    # grey RGB PNG of the reconstructed Y plane (Cb = Cr = 128)
    grey = torch.full_like(yrec, 128)
    I.save_image_png(args.png, Q.ycbcr_to_rgb(torch.stack([yrec, grey, grey],
                                                          dim=-1)))

    # reference Y at the padded size
    padded, _w, _h = P._pad_to_tiles_nn(rgb, params.block)
    psnr = P.psnr_y(Q.rgb_to_ycbcr(padded)[..., 0], yrec)
    bpp = packed.size * 8.0 / (art.W * art.H)
    n_trits = art.trits.numel()

    if args.json:
        print(json.dumps({"aniso_rc": {
            "input": args.infile, "W": art.W, "H": art.H,
            "block": params.block, "angles": art.angles_used,
            "proj_len": art.proj_len, "trits": n_trits,
            "packed_bytes": int(packed.size), "bpp": round(bpp, 3),
            "psnrY": round(psnr, 2), "png": args.png}}, indent=2))
    else:
        print(f"== aniso_rc ==\nimage: {args.infile}\n"
              f"dims: {art.W} x {art.H}  block={params.block}\n"
              f"angles: {art.angles_used}  proj_len={art.proj_len}\n"
              f"trits: {n_trits}  packed_bytes={packed.size}  "
              f"bpp={bpp:.3f}\nPSNR(Y): {psnr:.2f} dB\nout PNG: {args.png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
