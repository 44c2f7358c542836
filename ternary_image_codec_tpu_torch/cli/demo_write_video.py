"""demo_write_video — 60 synthetic 256x144 frames -> S21 words -> mp4
(src/demo_write_video.cpp:14-49).  Falls back to a PNG sequence when ffmpeg
is unavailable (runtime analog of the reference's compile gate).  Frames
are made and decoded on ``--device`` (default: the current CUDA device)."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..codec import resolve_device
from ..config import SubwordMode
from ..io import video as V
from ..ops import wordcodec as WC
from . import add_device_arg


def make_frames(w: int = 256, h: int = 144, n: int = 60, device=None):
    """Synthetic quant pattern (src/demo_write_video.cpp:20-31) -> S21
    word13 frames on ``device``."""
    dev = resolve_device(device)
    y, x = np.mgrid[0:h, 0:w]
    frames = []
    for f in range(n):
        q = np.stack([(x + f) % 243,
                      (y - f) % 81 - 40,
                      (x + y + f) % 81 - 40], axis=-1).astype(np.int32)
        frames.append(WC.encode_raw_pixels_to_words_subword(
            torch.as_tensor(q.reshape(-1, 3), device=dev), SubwordMode.S21))
    return frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="demo_write_video")
    ap.add_argument("--out", default="demo_s21.mp4")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--png-dir", default="demo_s21_frames",
                    help="fallback PNG sequence directory")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    W, H = 256, 144
    frames = make_frames(W, H, args.frames, dev)
    cfg = V.FFVideoConfig(codec_name="libx264", width=W, height=H, fps=30.0,
                          crf=20, preset="veryfast", gop=60)
    st = V.write_video_from_words_sequence(args.out, cfg, frames,
                                           SubwordMode.S21, W, H, device=dev)
    if st is not None:
        print(f"Wrote {args.out}, frames={st.frames_written}, "
              f"packets={st.packets}")
        return 0
    paths = V.write_png_sequence_from_words(args.png_dir, frames,
                                            SubwordMode.S21, W, H, device=dev)
    print(f"ffmpeg unavailable; wrote PNG sequence: {len(paths)} frames -> "
          f"{args.png_dir}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
