"""main_video_t3v — PNG list -> per-frame profile encode -> T3V1-old
container + T3VI index sidecar + per-frame PNG exports + optional mp4
(old/src/main_video_t3v.cpp:16-40).  The frames are quantized, encoded
and decoded for the PNG exports on ``--device`` (default: the current CUDA
device), pipelined by runtime/executor.py's StreamExecutor."""
from __future__ import annotations

import argparse
import os

import torch

from ..codec import resolve_device
from ..config import (EncoderConfig, ProfileID, SubwordMode, Tile2D,
                      centered_window, std_res_for)
from ..io import image as I
from ..io import legacy_containers as LC
from ..io import video as V
from ..ops import pipeline as PL
from ..ops import quant as Q
from ..ops import wordcodec as WC
from . import add_device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="main_video_t3v")
    ap.add_argument("inputs", nargs="+", help="input PNGs... then out.t3v")
    ap.add_argument("--frames-dir", default=".")
    ap.add_argument("--mp4", default=None,
                    help="optionally assemble an mp4 from the PNG exports")
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted encode: keep the complete "
                         "frames already in out.t3v, re-encode from the "
                         "first missing one (frame-granularity checkpoint "
                         "via the container index, SURVEY.md section 5)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if len(args.inputs) < 2:
        ap.error("need at least one input image and the output .t3v")
    inputs, out = args.inputs[:-1], args.inputs[-1]

    cfg = EncoderConfig(profile=ProfileID.P2_RS26_22, tile=Tile2D(64, 64))
    sw, sh = std_res_for(SubwordMode.S27)
    hdr = LC.T3VOldHeader(file_type=1, profile=cfg.profile,
                          subword=cfg.subword, centered=True,
                          coset=cfg.coset, width=sw, height=sh,
                          aw=centered_window(SubwordMode.S27),
                          fps_num=30000, fps_den=1001,
                          frame_count=len(inputs))

    os.makedirs(args.frames_dir, exist_ok=True)
    offsets, start = [], 0
    if args.resume and os.path.exists(out):
        prev = LC.t3v_old_read_header(out)
        if (prev.profile, prev.subword, prev.width, prev.height) != \
                (hdr.profile, hdr.subword, hdr.width, hdr.height):
            ap.error(f"--resume: {out} was written with a different config")
        offsets, good_end = LC.t3v_old_resume_scan(out)
        start = len(offsets)
        with open(out, "r+b") as f:
            f.truncate(good_end)  # drop a partial tail frame, if any
        print(f"resuming {out}: {start} complete frame(s) kept")
    mode = "r+b" if start else "wb"
    with open(out, mode) as f:
        if start:
            f.seek(0, os.SEEK_END)
        else:
            f.write(LC._t3v_old_header_bytes(hdr))

        # pipelined executor: host PNG decode of frame i+1, device encode
        # of frame i, and container/PNG serialization of frame i-1 run
        # concurrently (runtime/executor.py) -- the sequential reference
        # loop (old/src/main_video_t3v.cpp:16-40) has no such overlap.
        from ..runtime.executor import StreamExecutor

        def load(path):
            rgb = torch.as_tensor(I.load_image_rgb8(path)).to(dev)
            h, w = rgb.shape[0], rgb.shape[1]
            q = Q.rgb_to_quant(rgb).reshape(-1, 3)
            return WC.quant_to_words9(q), w, h

        def device(x):
            raw, w, h = x
            prof = PL.encode_profile_from_raw(raw, cfg, device=dev)
            qs = WC.words9_to_quant(raw, n_pixels=w * h)
            rgb2 = Q.quant_to_rgb(qs)
            return prof, rgb2, w, h

        def write(fi, y):
            prof, rgb2, w, h = y
            offsets.append(f.tell())
            f.write(LC._t3v_old_frame_bytes(prof.cpu().numpy()))
            # per-frame RAW PNG export (old/src/main_video_t3v.cpp:31)
            I.save_image_png(os.path.join(args.frames_dir,
                                          f"frame_{fi:05d}.png"),
                             rgb2.reshape(h, w, 3))

        StreamExecutor(load, device, write, device=dev).run(inputs,
                                                            start=start)
    LC.t3v_old_finalize_header(out, len(inputs))
    LC.t3vi_write(out + ".t3vi", offsets)

    if args.mp4:
        pattern = os.path.join(args.frames_dir, "frame_%05d.png")
        if V.ffmpeg_from_png_pattern(pattern, args.mp4, fps=30000 / 1001):
            print(f"assembled {args.mp4}")
        else:
            print("ffmpeg unavailable; skipped mp4 assembly")
    print(f"Wrote {out} with {len(inputs)} frames.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
