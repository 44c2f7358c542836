"""Full-mode decode of one 8K frame on the port (the JAX package's
``tools/full_mode_bench.py``).

``strategy="full"`` runs the whole correction chain on every block, as
the reference always does (old/.../v6_min.hpp:948-993): it serves
adversarially dense damage.  On the card that is K2 over every block, one
launch a group of bands and one for the header chain.  One 8K frame (P2,
luma-priority UEP, bench.py's RAW words) is encoded once, then decoded
``--iters`` times clean and ``--iters`` times under the benchmark's damage
model (``damage.damage``, one frame); the least time of each is reported.
Every decode must be ok and give back the frame's RAW words exactly.

The JAX tool times its ``T3_FULL_V3`` on/off A/B; that knob is not ported
(the port has one full-mode program), so there is one row a leg.

Prints one JSON line last: ``metric``, ``ms_per_frame``, ``fps`` and
``peak_bytes`` (clean, dirty), ``k1_launches``/``k2_launches`` per leg,
``backend``, ``device``.

Usage: python -m ternary_image_codec_tpu_torch.bench.full_mode_bench
           [--iters 4] [--wh 7680x4320] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from ..cli import add_device_arg
from ..codec import resolve_device
from ..ops import pipeline
from . import damage as dmg
from . import peak_bytes, require, run_main
from .headline import base_chunks, bench_cfg, counted, smi_line, sync

SF_BATCH = 128


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="full_mode_bench")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--wh", default="7680x4320")
    add_device_arg(ap)
    return ap.parse_args(argv)


def run(argv=None, keep=None) -> dict:
    """The benchmark's result dict; raises ``BenchFailure`` when a check
    fails.  ``keep(leg)`` (a context manager) wraps each leg's first,
    untimed decode."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = bench_cfg("p2", "", False)
    w, h = map(int, args.wh.split("x"))
    n_raw = w * h // 2
    chunks = torch.as_tensor(base_chunks(n_raw, cfg.superframe_words,
                                         np.random.default_rng(0)))
    raw = chunks.reshape(-1, 9)[:n_raw].to(dev)
    words = pipeline.encode_stream_superframes(raw, cfg, SF_BATCH, device=dev)
    n_sf, total_w = words.shape[:2]
    ev, _dirty = dmg.damage(n_sf, total_w, frames=1)
    dirty = dmg.apply(words.transpose(1, 2)[None], ev)[0].transpose(1, 2)

    def decode(wds, leg):
        out, ok = pipeline.decode_stream_superframes(
            wds, cfg, n_raw, SF_BATCH, strategy="full", device=dev)
        require(bool(ok) and torch.equal(out, raw),
                f"full decode, {leg}: not exact")

    launches, ms, peaks = {}, {}, {}
    for leg, wds in (("clean", words), ("dirty", dirty)):
        best = float("inf")
        with counted(launches, leg), peak_bytes(peaks, leg, dev):
            with keep(f"full {leg}") if keep else contextlib.nullcontext():
                decode(wds, leg)                 # the first call: untimed
            for _ in range(args.iters):
                sync(dev)
                t0 = time.perf_counter()
                decode(wds, leg)
                best = min(best, time.perf_counter() - t0)
        ms[leg] = best * 1e3
    return {"metric": "full_mode_decode", "ms_per_frame": ms,
            "peak_bytes": peaks,
            "fps": {leg: 1e3 / t for leg, t in ms.items()},
            "dirty_model": {"D": min(20, n_sf), "E": 8, "overcap": 0.0,
                            "hdr": 0.25},
            "wh": args.wh, "iters": args.iters,
            "backend": f"torch-{dev.type}", "device": smi_line(dev),
            "k1_launches": {k: n["check_decode"] for k, n in launches.items()},
            "k2_launches": {k: n["rs_correct"] for k, n in launches.items()}}


def main(argv=None, keep=None) -> int:
    return run_main(run, argv, keep=keep)


if __name__ == "__main__":
    raise SystemExit(main())
