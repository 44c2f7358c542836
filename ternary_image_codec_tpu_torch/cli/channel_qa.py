"""channel_qa — recovery / flagged / miscorrection rates per RS profile
under random symbol errors (the JAX package's tools/channel_qa.py).

Per RS(26, k), k in 24, 22, 20, 18, and error count 0 .. 2t+1 over
``--blocks`` random codewords:

  exact    -- decoded == sent and ok=True
  flagged  -- ok=False (failure detected)
  miscorr  -- ok=True but decoded != sent (inside another codeword's
              decode sphere; inherent to RS)

The data, error positions and error values come from the reference's
numpy generator in its draw order, so the report is the reference's; the
decode is ``rs.decode_dig`` on ``--device`` (K2 on the card, one launch a
(k, error count); its plain twin on the CPU).  The reference's ``--chip``
(the TPU backend) is ``--device`` here.

Usage: python -m ternary_image_codec_tpu_torch.cli.channel_qa
           [--blocks 2048] [--seed 0] [--json] [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..codec import resolve_device
from ..ops import rs
from . import add_device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="channel_qa")
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    r = np.random.default_rng(args.seed)
    B = args.blocks
    report = {}
    for k in (24, 22, 20, 18):
        t = (26 - k) // 2
        rows = {}
        data = r.integers(0, 27, size=(B, k))
        cw = rs.np_encode(data, k)
        exp = np.stack([data % 3, data // 3 % 3, data // 9 % 3],
                       axis=-1).astype(np.int8)
        for ne in range(0, 2 * t + 2):
            recv = cw.copy()
            for i in range(B):
                pos = r.choice(26, ne, replace=False)
                recv[i, pos] = (recv[i, pos]
                                + r.integers(1, 27, size=ne)) % 27
            dig = np.stack([recv % 3, recv // 3 % 3, recv // 9 % 3],
                           axis=-1).astype(np.int8)
            out, ok = rs.decode_dig(torch.as_tensor(dig, device=device), k)
            okn = ok.cpu().numpy()
            exact = okn & np.all(out.cpu().numpy() == exp, axis=(1, 2))
            rows[ne] = {
                "exact": round(float(exact.mean()), 4),
                "flagged": round(float((~okn).mean()), 4),
                "miscorr": round(float((okn & ~exact).mean()), 4),
            }
            if not args.json:
                print(f"RS(26,{k}) ne={ne}: {rows[ne]}", flush=True)
        report[f"RS(26,{k}) t={t}"] = rows

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for prof, rows in report.items():
            print(f"== {prof}")
            print("  errs  exact  flagged  miscorr")
            for ne, m in rows.items():
                print(f"  {ne:4d}  {m['exact']:.3f}  {m['flagged']:7.3f}"
                      f"  {m['miscorr']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
