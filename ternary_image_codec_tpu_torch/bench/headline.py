"""Headline benchmark of the port: 8K-frame encode + decode throughput on
one card (the JAX package's ``bench.py``).

One 8K frame (7680x4320, 2 px per word9: 16,588,800 RAW words, 2,025
superframes of 8,192 words), P2 with ``uep_luma_priority()`` by default.
Three legs, each with its own exactness checks:

* clean: three host-staged batches of ``--iters`` distinct frames (frame i
  of batch b is the base frame + ``iters * b + i`` mod 27) through
  ``roundtrip_stream(rs_mode="check", fold=sum)`` over the flattened
  frames x superframes axis, one call a batch; the first batch warms up.
  The time is the host clock around a call ending in a sync on the folded
  scalar, the least of the timed batches, per frame.  Every batch must be
  all ok, and its checksum must equal the sum of its input words mod 2^32
  with band 8 taken mod 9 (trit 26 is not carried);
* e2e: seeded RGB (n_sf, 3, 2, sf) uint8 plus a per-frame uint8 offset
  through ``roundtrip_stream(raw_wire="planes", feed=ingest9,
  fold=egress9-sum)``; the checksum must equal the no-codec oracle
  ``egress9(ingest9(frame))`` summed over the same frames;
* dirty: ``--dirty-iters`` frames encoded, damaged by ``damage.damage``
  and decoded by ``decode_frames_fused`` (one check, one repair window of
  ``--repair-cap`` superframes, by default every dirty one); the clean sets
  decode under ``auto``.  Without overcap the repair must be ok and the
  whole first frame exact; with overcap ok must be False.
  ``dirty_fps = 1 / (t_clean_roundtrip - t_clean_decode + t_dirty_decode)``
  and ``dirty_over_clean_decode = t_dirty_decode / t_clean_decode``.

Differences from bench.py: the window's capacity is its own argument
(bench.py reuses ``T3_REPAIR_SFB``); a failed leg fails the run (bench.py
catches a failed dirty phase and prints the headline anyway); no
``vs_baseline`` (its 30 fps is another device's target); ``unit`` is per
card; the A/B knobs ``T3_BENCH_STRUCT``, ``T3_DIRTY_STRATEGY`` and
``T3_DIRTY_OUTLAYOUT`` are not ported.  ``--stage device`` builds each
micro-batch on the card from one staged frame (the port's ``feed`` builds
a micro-batch, not one superframe).

The last line of output is one JSON object: ``metric``, ``value`` (clean
frames/s), ``unit``, ``e2e_fps``, ``dirty_fps``,
``dirty_over_clean_decode``, ``dirty_model``, ``backend``, ``device``
(the ``nvidia-smi`` name and power limit), ``k1_launches`` and
``k2_launches`` per leg, ``ms_per_frame`` and ``peak_bytes`` (the most
device memory allocated, kept inputs included when a caller keeps them)
per leg and the legs' ``checksums``.

Usage: python -m ternary_image_codec_tpu_torch.bench.headline
           [--wh 7680x4320] [--iters 24] [--sf-batch 128] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import time

import numpy as np
import torch

from ..cli import add_device_arg
from ..codec import codec_for, resolve_device
from ..config import (EncoderConfig, ProfileID, SparseBeaconCfg, Tile2D,
                      uep_luma_priority)
from ..ops import pipeline
from ..ops import wordcodec as wc
from ..runtime import build, tracing
from . import damage as dmg
from . import peak_bytes, require, run_main

METRIC = "8k_frame_encode_decode_throughput"
N_BATCHES = 3          # the first warms up


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="headline")
    ap.add_argument("--profile", choices=("p2", "p5"), default="p2")
    ap.add_argument("--tile", default="26x26", help="P5 tile WxH")
    ap.add_argument("--beacon", action="store_true",
                    help="a period-13 beacon in band 4 (the flagship "
                    "streaming layout)")
    ap.add_argument("--wh", default="7680x4320")
    ap.add_argument("--sf-batch", type=int, default=128)
    ap.add_argument("--raw-wire", choices=("words", "planes"),
                    default="words")
    ap.add_argument("--iters", type=int, default=24,
                    help="frames a clean and e2e batch")
    ap.add_argument("--stage", choices=("host", "device"), default="host")
    ap.add_argument("--dirty-d", type=int, default=20,
                    help="dirty superframes a frame")
    ap.add_argument("--dirty-e", type=int, default=8,
                    help="symbol errors a dirty superframe (at most 9)")
    ap.add_argument("--dirty-overcap", type=float, default=0.0)
    ap.add_argument("--dirty-hdr", type=float, default=0.25)
    ap.add_argument("--dirty-iters", type=int, default=8,
                    help="frames a dirty set (at most --iters)")
    ap.add_argument("--repair-cap", type=int, default=None,
                    help="the fused window (default: every dirty "
                    "superframe of a set)")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--skip-dirty", action="store_true")
    ap.add_argument("--trace-dir", default=None,
                    help="torch.profiler traces of the timed calls, one "
                    "subdirectory a leg")
    add_device_arg(ap)
    return ap.parse_args(argv)


def bench_cfg(profile: str, tile: str, beacon: bool) -> EncoderConfig:
    """bench.py's layouts: P2 + luma UEP, or P5 with a ``tile`` (WxH)
    2-D interleave; a period-13 beacon in band 4 with ``beacon``."""
    bc = SparseBeaconCfg(13, 4, True) if beacon else SparseBeaconCfg()
    if profile == "p5":
        tw, th = map(int, tile.split("x"))
        return EncoderConfig(profile=ProfileID.P5_RS26_22_2D,
                             uep=uep_luma_priority(), beacon=bc,
                             tile=Tile2D(tw, th))
    return EncoderConfig(profile=ProfileID.P2_RS26_22,
                         uep=uep_luma_priority(), beacon=bc)


def smi_line(dev: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the device type."""
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(dev.index)],
                         capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def counted(into: dict, leg: str):
    """K1 and K2 launches of the block, added to ``into[leg]``."""
    before = build.launches.copy()
    try:
        yield
    finally:
        n = into.setdefault(leg, {"check_decode": 0, "rs_correct": 0})
        for kernel in n:
            n[kernel] += build.launches[kernel] - before[kernel]


def base_chunks(n_raw: int, sf: int, rng: np.random.Generator):
    """bench.py's frame: RAW words from ``rng`` (trit 26 zero), zero-padded
    to whole superframes, (n_sf, sf, 9) int8."""
    t = rng.integers(0, 3, size=(n_raw, 27)).astype(np.int8)
    t[:, 26] = 0
    t = t.reshape(n_raw, 9, 3)
    raw = t[..., 0] + 3 * t[..., 1] + 9 * t[..., 2]
    n_sf = -(-n_raw // sf)
    out = np.zeros((n_sf * sf, 9), dtype=np.int8)
    out[:n_raw] = raw
    return out.reshape(n_sf, sf, 9)


def band_hists(base: torch.Tensor, band_axis: int):
    """Value counts (27,) of bands 0-7 and of band 8 of the frame ``base``,
    a few superframes at a time."""
    hist = torch.zeros(27, dtype=torch.int64)
    hist8 = torch.zeros(27, dtype=torch.int64)
    for part in base.split(64):
        p = part.to(torch.int64)
        hist += torch.bincount(p.reshape(-1), minlength=27)
        hist8 += torch.bincount(p.select(band_axis, 8).reshape(-1),
                                minlength=27)
    return hist - hist8, hist8


def variant_sum(hists, cs) -> int:
    """Sum of the frames ``(base + c) mod 27`` for c in ``cs`` from the
    base frame's ``band_hists``, band 8 taken mod 9 (what a decode returns:
    trit 26 is not carried)."""
    hist, hist8 = hists
    k = torch.arange(27)
    return sum(int((hist * ((k + c) % 27)).sum()
                   + (hist8 * ((k + c) % 9)).sum()) for c in cs)


def host_batch(base: torch.Tensor, cs) -> torch.Tensor:
    """Frames ``(base + c) mod 27`` for c in ``cs`` on the host, flattened
    to (len(cs) * n_sf, ...)."""
    n = base.shape[0]
    out = torch.empty((len(cs) * n,) + tuple(base.shape[1:]), dtype=torch.int8)
    for i, c in enumerate(cs):
        torch.remainder(base + c % 27, 27, out=out[i * n:(i + 1) * n])
    return out


def clean_leg(args, cfg, base, dev, keep):
    """(s per frame, checksums per batch, launches) of the clean leg."""
    n_sf, iters, planes = base.shape[0], args.iters, args.raw_wire == "planes"
    band_axis = 1 if planes else 2
    fold = lambda out: out.to(torch.int32).sum((1, 2))
    hists = band_hists(base, band_axis)
    cs = [[iters * b + i for i in range(1, iters + 1)]
          for b in range(N_BATCHES)]
    if args.stage == "device":
        base_d = base.to(dev)
        m = torch.tensor([27] * 8 + [9], dtype=torch.int16, device=dev)
        m = m[:, None] if planes else m

        def make(src, sidx, v):
            return ((src[sidx].to(torch.int16) + v[:, None, None]) % m) \
                .to(torch.int8)

        def call(b):
            sidx = torch.arange(n_sf, device=dev).repeat(iters)
            v = torch.as_tensor(cs[b], device=dev).repeat_interleave(n_sf) % 27
            return pipeline.roundtrip_stream(
                (sidx, v.to(torch.int16)), cfg, args.sf_batch,
                rs_mode="check", fold=fold, device=dev,
                raw_wire=args.raw_wire, feed=(base_d, make))
        batches = list(range(N_BATCHES))
    else:
        batches = [host_batch(base, c).to(dev) for c in cs]

        def call(b):
            return pipeline.roundtrip_stream(
                b, cfg, args.sf_batch, rs_mode="check", fold=fold,
                device=dev, raw_wire=args.raw_wire)
    sync(dev)
    launches, sums, best = {}, [], float("inf")
    for b, batch in enumerate(batches):
        ctx = keep("clean") if b == 0 and keep else contextlib.nullcontext()
        trace = args.trace_dir and b == 1
        with counted(launches, "clean"), ctx, tracing.device_trace(
                os.path.join(args.trace_dir, "clean") if trace else None):
            t0 = time.perf_counter()
            chks, ok = call(batch)
            s, ok_all = torch.stack([chks.sum(dtype=torch.int64),
                                     ok.all().to(torch.int64)]).tolist()
            dt = time.perf_counter() - t0
        require(ok_all == 1, f"clean batch {b}: a superframe is not ok")
        want = variant_sum(hists, cs[b])
        require((s - want) % (1 << 32) == 0,
                f"clean batch {b}: checksum {s} != input sum {want}")
        sums.append(s % (1 << 32))
        if b:
            best = min(best, dt / iters)
    return best, sums, launches["clean"]


def e2e_leg(args, cfg, rng, dev, keep):
    """(s per frame, checksums per batch, launches) of the e2e leg."""
    sf, iters = cfg.superframe_words, args.iters
    n_raw = _n_raw(args.wh)
    n_sf = -(-n_raw // sf)
    rgb_np = rng.integers(0, 256, size=(n_sf * sf, 3, 2)).astype(np.uint8)
    rgb = torch.as_tensor(np.ascontiguousarray(
        rgb_np.reshape(n_sf, sf, 3, 2).transpose(0, 2, 3, 1)), device=dev)
    del rgb_np

    def make(src, sidx, v):                       # (b,) rows -> (b, 9, sf)
        return wc.ingest9_planes(src[sidx] + v[:, None, None, None])

    def fold(out):                                # (b, 9, n_out) -> (b,)
        return wc.egress9_planes(out[:, :, :sf]).to(torch.int32).sum((1, 2, 3))

    def rows(b):
        v = (np.repeat(np.arange(1, iters + 1), n_sf) + iters * b) % 256
        return (torch.arange(n_sf, device=dev).repeat(iters),
                torch.as_tensor(v.astype(np.uint8), device=dev))

    def oracle(v):                                # no codec: egress(ingest)
        return sum(int(wc.egress9_planes(wc.ingest9_planes(rgb + c))
                       .sum(dtype=torch.int64))
                   for c in v.view(iters, n_sf)[:, 0].tolist())

    launches, sums, best = {}, [], float("inf")
    for b in range(N_BATCHES):
        sidx, v = rows(b)
        sync(dev)
        ctx = keep("e2e") if b == 0 and keep else contextlib.nullcontext()
        trace = args.trace_dir and b == 1
        with counted(launches, "e2e"), ctx, tracing.device_trace(
                os.path.join(args.trace_dir, "e2e") if trace else None):
            t0 = time.perf_counter()
            chks, ok = pipeline.roundtrip_stream(
                (sidx, v), cfg, args.sf_batch, rs_mode="check", fold=fold,
                device=dev, raw_wire="planes", feed=(rgb, make))
            s, ok_all = torch.stack([chks.sum(dtype=torch.int64),
                                     ok.all().to(torch.int64)]).tolist()
            dt = time.perf_counter() - t0
        require(ok_all == 1, f"e2e batch {b}: a superframe is not ok")
        want = oracle(v)
        require((s - want) % (1 << 32) == 0,
                f"e2e batch {b}: checksum {s} != no-codec oracle {want}")
        sums.append(s % (1 << 32))
        if b:
            best = min(best, dt / iters)
    return best, sums, launches["e2e"]


def dirty_leg(args, cfg, base, dev, keep):
    """(t_clean, t_dirty) s per frame and the launches of the dirty leg."""
    codec = codec_for(cfg, dev)
    planes = args.raw_wire == "planes"
    words = (base.transpose(1, 2) if planes else base).to(dev)  # (n_sf, sf, 9)
    n_sf, sf = words.shape[:2]
    F = min(args.iters, args.dirty_iters)
    total_w = codec.layout.total_words
    ev, (fi_sf, _si_sf) = dmg.damage(
        n_sf, total_w, F, D=args.dirty_d, E=args.dirty_e,
        overcap=args.dirty_overcap, hdr=args.dirty_hdr)
    over = int(round(args.dirty_overcap * len(fi_sf)))
    cap = args.repair_cap or len(fi_sf)

    def clean_dec(ws):                            # auto over all frames
        return codec.decode(ws.flatten(0, 1), "auto", sf_batch=args.sf_batch)

    def dirty_dec(ws):
        return pipeline.decode_frames_fused(ws, cfg, args.sf_batch, cap,
                                            wire="planes", device=dev)

    def timed(fn, ws):
        sync(dev)
        t0 = time.perf_counter()
        _out, ok = fn(ws)
        ok = bool(ok)
        sync(dev)
        return (time.perf_counter() - t0) / F, ok

    launches = {}
    t_clean = t_dirty = float("inf")
    with counted(launches, "dirty"):
        for b in range(2):
            w = torch.stack([codec.encode((words + (F * b + i) % 27) % 27,
                                          args.sf_batch)
                             for i in range(1, F + 1)])   # (F, n_sf, 9, total)
            wd = dmg.apply(w, ev)
            if b == 0:
                with keep("dirty") if keep else contextlib.nullcontext():
                    out, ok = dirty_dec(wd)
                    ok = bool(ok)
                if over:
                    require(not ok, "dirty repair: overcap damage came back "
                            "ok")
                else:
                    require(ok, "dirty repair failed")
                    want = (words.transpose(1, 2) + 1) % 27
                    want[:, 8] %= 9
                    require(torch.equal(out[0, :, :, :sf], want),
                            "dirty repair: the first frame is not exact")
                del out
            tc, ok_c = timed(clean_dec, w)
            require(ok_c, f"dirty set {b}: the clean frames are not ok")
            t_clean = min(t_clean, tc)
            trace = args.trace_dir and b == 1
            with tracing.device_trace(
                    os.path.join(args.trace_dir, "dirty") if trace else None):
                td, ok_d = timed(dirty_dec, wd)
            require(ok_d == (not over), f"dirty set {b}: ok is {ok_d}")
            t_dirty = min(t_dirty, td)
            del w, wd
    return t_clean, t_dirty, launches["dirty"], cap


def _n_raw(wh: str) -> int:
    w, h = map(int, wh.split("x"))
    return w * h // 2                             # word9: 2 px a word


def run(argv=None, keep=None) -> dict:
    """The benchmark's result dict; raises ``BenchFailure`` when a check
    fails.  ``keep(leg)``, when given, is a context manager entered around
    one untimed call of each leg (the clean and e2e warm-up batches, the
    dirty leg's checked decode)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = bench_cfg(args.profile, args.tile, args.beacon)
    sf = cfg.superframe_words
    n_raw = _n_raw(args.wh)
    rng = np.random.default_rng(0)
    base = torch.as_tensor(base_chunks(n_raw, sf, rng))   # (n_sf, sf, 9)
    if args.raw_wire == "planes":
        base = base.transpose(1, 2).contiguous()
    codec_for(cfg, dev)                           # tables outside the clock
    peaks = {}
    with peak_bytes(peaks, "clean", dev):
        t_rt, sums, n_clean = clean_leg(args, cfg, base, dev, keep)
    fps = 1.0 / t_rt
    res = {"metric": METRIC, "value": fps, "unit": "frames/s/card"}
    k1 = {"clean": n_clean["check_decode"]}
    k2 = {"clean": n_clean["rs_correct"]}
    ms = {"clean_roundtrip": t_rt * 1e3}
    checks = {"clean": sums}
    e2e_fps = None
    if not args.skip_e2e:
        with peak_bytes(peaks, "e2e", dev):
            t_e2e, e_sums, n_e2e = e2e_leg(args, cfg, rng, dev, keep)
        e2e_fps = 1.0 / t_e2e
        k1["e2e"], k2["e2e"] = n_e2e["check_decode"], n_e2e["rs_correct"]
        ms["e2e_roundtrip"] = t_e2e * 1e3
        checks["e2e"] = e_sums
    dirty_fps = ratio = None
    E = min(args.dirty_e, 9)
    cap = None
    if not args.skip_dirty:
        with peak_bytes(peaks, "dirty", dev):
            t_clean, t_dirty, n_dirty, cap = dirty_leg(args, cfg, base, dev,
                                                       keep)
        dirty_fps = 1.0 / (t_rt - t_clean + t_dirty)
        ratio = t_dirty / t_clean
        k1["dirty"] = n_dirty["check_decode"]
        k2["dirty"] = n_dirty["rs_correct"]
        ms["clean_auto_decode"] = t_clean * 1e3
        ms["dirty_fused_decode"] = t_dirty * 1e3
    res.update({
        "e2e_fps": e2e_fps, "dirty_fps": dirty_fps,
        "dirty_over_clean_decode": ratio,
        "dirty_model": {"D": min(args.dirty_d, -(-n_raw // sf)), "E": E,
                        "overcap": args.dirty_overcap, "hdr": args.dirty_hdr},
        "backend": f"torch-{dev.type}", "device": smi_line(dev),
        "k1_launches": k1, "k2_launches": k2, "ms_per_frame": ms,
        "peak_bytes": peaks,
        "checksums": checks, "frames": args.iters, "wh": args.wh,
        "profile": args.profile, "beacon": args.beacon,
        "sf_batch": args.sf_batch, "raw_wire": args.raw_wire,
        "stage": args.stage, "repair_cap": cap})
    return res


def main(argv=None, keep=None) -> int:
    return run_main(run, argv, keep=keep)


if __name__ == "__main__":
    raise SystemExit(main())
