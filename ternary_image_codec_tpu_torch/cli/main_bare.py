"""main_bare — self-test runner + minimal demo (src/main_bare.cpp:12-36).

Runs the core self-tests (RS unit + API roundtrip; both FAIL in the
reference because of its RS encoder bug, SURVEY.md §0.3, and must PASS
here), then writes demo_s21.t3v (word9 frame) and demo_s21.t3p (N=21
subword trit stream), like the reference binary.  The codec work runs on
``--device`` (default: the current CUDA device): the RS unit test's
decode is the K2 kernel on the card, and so are the API roundtrip's
header decode and paged repair.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..codec import resolve_device
from ..config import EncoderConfig, ProfileID, uep_luma_priority
from ..io import legacy_containers as LC
from ..ops import pipeline as PL
from ..ops import rs as RS
from ..ops import subword as SW
from ..ops import wordcodec as WC
from . import add_device_arg


def selftest_rs_unit(verbose: bool = False, device=None) -> bool:
    """RS encode -> inject exactly t symbol errors -> decode-compare, all
    four profiles (old/include/ternary_image_codec_v6_min.hpp:1172-1207),
    on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    for k in (24, 22, 20, 18):
        t = (26 - k) // 2
        data = np.array([(i * 5 + 7) % 27 for i in range(k)], dtype=np.int8)
        code = RS.encode(torch.as_tensor(data[None, :], device=dev), k)
        recv = code.cpu().numpy()[0]
        pos = rng.choice(26, size=t, replace=False)
        for p in pos:
            recv[p] = (recv[p] + 1 + rng.integers(0, 26)) % 27
        dec, ok = RS.decode(torch.as_tensor(recv[None, :], device=dev), k)
        if not bool(ok[0]):
            return False
        if not np.array_equal(dec.cpu().numpy()[0, :k], data):
            return False
        if verbose:
            print(f"  RS(26,{k}): corrected {t} errors OK")
    return True


def selftest_api_roundtrip(verbose: bool = False, device=None) -> bool:
    """64 synthetic pixels -> RAW word9 -> P2 profile with luma-priority UEP
    -> decode -> exact compare (old/...hpp:1208-1230), on ``device``."""
    dev = resolve_device(device)
    q = np.stack([np.arange(64) * 11 % 243,
                  np.arange(64) % 81 - 40,
                  np.arange(64) * 2 % 81 - 40], axis=-1).astype(np.int32)
    raw = WC.quant_to_words9(torch.as_tensor(q, device=dev))
    cfg = EncoderConfig(profile=ProfileID.P2_RS26_22, uep=uep_luma_priority())
    prof = PL.encode_profile_from_raw(raw, cfg, device=dev)
    out, _hdr, ok = PL.decode_profile_to_raw(prof, device=dev)
    if not ok:
        return False
    same = torch.equal(out[:raw.shape[0]], raw)
    if verbose and same:
        print("  API roundtrip: 64 px via P2 + luma-UEP OK")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="main_bare",
                                 description="core self-tests + demo files")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--verbose", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)

    ok_rs = selftest_rs_unit(args.verbose, dev)
    ok_api = selftest_api_roundtrip(args.verbose, dev)
    print(f"RS unit: {'OK' if ok_rs else 'FAIL'}")
    print(f"API roundtrip: {'OK' if ok_api else 'FAIL'}")
    if not (ok_rs and ok_api):
        return 1

    # 10 synthetic pixels -> RAW-N S21 words (src/main_bare.cpp:21-33)
    i = np.arange(10)
    q = np.stack([(i * 11) % 243, i % 81 - 40, (i * 2) % 81 - 40],
                 axis=-1).astype(np.int32)
    words9 = WC.quant_to_words9(torch.as_tensor(q, device=dev))
    LC.t3v1_write(f"{args.outdir}/demo_s21.t3v", [words9.cpu().numpy()])
    ut = SW.extract_subword_stream(words9, 21)
    LC.t3p1_write(f"{args.outdir}/demo_s21.t3p", ut.cpu().numpy())
    print("Wrote demo_s21.t3v and demo_s21.t3p")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
