"""Timed serving benchmark of the port (the JAX package's
``tools/serve_bench.py``): 8K RAW frames into a real T3V6 file and back.

  write: staged RAW frames (host memory, pinned on a card) -> H2D ->
         [device] ``enc_serve`` (stream encode and base-243 wire pack) ->
         D2H -> host CRC32 and T3V6 write (index, per-frame meta), fsync
  read:  approval-gated indexed frame read and CRC32 check -> H2D ->
         [device] ``dec_serve`` (unpack, K1 check decode, checksums)

Both directions run through ``runtime/executor.StreamExecutor``
(``prefetch`` 2: host IO of one item overlaps device work on the next),
an item being ``--group`` frames; container records stay per frame.  The
frames are the JAX tool's: bench.py's RAW words plus ``i + 1`` mod 27 for
frame i, ``--frames`` rounded up to whole groups.  Every frame read back
must be ok with the wire checksum its encode gave.

Prints one JSON line last with the JAX tool's keys: ``serve_write_fps``,
``serve_read_fps``, ``serve_fps``, ``frames``, ``group``, ``frame_mb``,
``disk_write_gbps``, ``crc_gbps``, ``enc_split_s`` (stage_h2d, dispatch,
d2h, crc, io) and ``dec_split_s`` (read, h2d, dispatch); the port adds
``device`` seconds to both splits (CUDA events around the device work),
``fsync`` to the write's and splits ``read`` into ``crc`` and ``io``, plus
``k1_launches``/``k2_launches`` and ``peak_bytes`` per direction,
``backend`` and ``device``.  ``h2d``,
``d2h`` and ``device`` are CUDA-event times on a card, the rest host clock.

``--probe`` times H2D, D2H, CRC32 and file IO alone; ``--host-only`` times
the host serve station alone (CRC32 and T3V6 write, gated read and CRC
check of synthetic bytes) at ``--path`` and, with ``--tmpfs DIR``, on a
memory file system.  The JAX tool's ``--cpu`` is ``--device cpu`` here; the
file goes to the temporary directory by default and is removed unless
``--keep-file``.

Usage: python -m ternary_image_codec_tpu_torch.bench.serve_bench
           [--frames 24] [--group 4] [--sfb 128] [--wh 7680x4320]
           [--path FILE] [--probe] [--host-only] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from ..cli import add_device_arg
from ..codec import resolve_device
from ..config import EncoderConfig, ProfileID, SubwordMode, uep_luma_priority
from ..io import serve
from ..runtime.executor import StreamExecutor
from ..security import policy
from . import peak_bytes, require, run_main
from .headline import base_chunks, counted, smi_line, sync

META = '{"domain":"acme/video/serve","build_hash":"ab12"}'
PREFETCH = 2           # executor queue depth
FRAME_BYTES_8K = 112_406_528


@contextlib.contextmanager
def timed_crc(split):
    """Inside the block, every container CRC of the serve module adds its
    host ms to ``split["crc"]``."""
    crc = serve._crc32

    def timed(data, init=0):
        t0 = time.perf_counter()
        out = crc(data, init)
        split["crc"] += (time.perf_counter() - t0) * 1e3
        return out
    serve._crc32 = timed
    try:
        yield
    finally:
        serve._crc32 = crc


@contextlib.contextmanager
def _span(spans, key):
    """CUDA timing events around the block on the current stream, kept in
    ``spans`` as (key, start, end); nothing when ``spans`` is None (a run
    on the CPU)."""
    if spans is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    spans.append((key, start, end))


def _span_ms(spans, split):
    """Device ms of the kept spans, summed by key into ``split``."""
    if spans:
        torch.cuda.synchronize()
    for key, start, end in spans or ():
        split[key] = split.get(key, 0.0) + start.elapsed_time(end)
    return split


def _groups(n: int, group: int):
    return [range(a, min(a + group, n)) for a in range(0, n, group)]


def serve_write(cfg, n_raw, frames, path, dev, w, h, meta=META,
                prefetch=PREFETCH, group=1, sf_batch=128, fsync=False):
    """The serve loop's write direction through ``StreamExecutor``: per
    item of ``group`` frames, H2D of the host chunks on the loader's
    stream, ``enc_serve`` (encode and wire pack) dispatched on the caller's,
    then per frame D2H of the packed bytes into one pinned buffer on the
    writer's and the T3V6 writer (CRC and file write) straight from that
    buffer; with ``fsync`` the file is synced before the clock stops.
    Returns (wire checksums per frame, ms split: h2d, device, d2h (device
    time by CUDA events), crc, io, dispatch and with ``fsync`` fsync (host
    clock), wall ms of the loop with the file's close)."""
    enc, _dec, geom = serve.serve_codec_fns(cfg, n_raw, sf_batch, device=dev)
    cuda = dev.type == "cuda"
    host = torch.empty((geom["n_sf"], geom["sf_bytes"]), dtype=torch.uint8,
                       pin_memory=cuda)
    cks, spans = [None] * len(frames), [] if cuda else None
    split = {"crc": 0.0, "write_frame": 0.0}

    def load(g):
        with _span(spans, "h2d"):
            return g, [frames[i].to(dev, non_blocking=True) for i in g]

    def device_fn(x):
        g, chunks = x
        with _span(spans, "device"):
            return g, [enc(c) for c in chunks]

    def write(_index, y):
        g, outs = y
        for i, (by, ck) in zip(g, outs):
            with _span(spans, "d2h"):
                host.copy_(by, non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(dev).synchronize()   # this stream
            cks[i] = int(ck)
            t0 = time.perf_counter()
            wtr.write_frame(i, host.numpy())
            split["write_frame"] += (time.perf_counter() - t0) * 1e3

    with timed_crc(split):
        t0 = time.perf_counter()
        wtr = serve.T3V6StreamWriter(
            path, cfg.subword, w, h, len(frames), geom["frame_bytes"],
            meta_global=serve.serve_meta_global(cfg, n_raw, w, h),
            meta_per_frame=meta)
        with wtr:
            stats = StreamExecutor(load, device_fn, write, prefetch,
                                   device=dev).run(_groups(len(frames), group))
            if fsync:
                t1 = time.perf_counter()
                wtr._f.flush()
                os.fsync(wtr._f.fileno())
                split["fsync"] = (time.perf_counter() - t1) * 1e3
        wall = (time.perf_counter() - t0) * 1e3
    split["io"] = split.pop("write_frame") - split["crc"]
    split["dispatch"] = stats.dispatch_s * 1e3
    return cks, _span_ms(spans, split), wall


def serve_read(cfg, n_raw, path, dev, approve, prefetch=PREFETCH, group=1,
               sf_batch=128):
    """The serve loop's read direction through ``StreamExecutor``: per
    item of ``group`` frames, the gated read of each payload (``approve``
    sees the meta first) and its CRC check into a pinned buffer, then H2D
    on the loader's stream, ``dec_serve`` (unpack, K1 check decode,
    checksums) on the caller's, the results read on the writer's.  Returns
    ({frame: (ok, wire checksum, out checksum)}, ms split: h2d, device
    (CUDA events), crc, io, dispatch (host clock), wall ms of the loop)."""
    _enc, dec, geom = serve.serve_codec_fns(cfg, n_raw, sf_batch, device=dev)
    n_sf, nb = geom["n_sf"], geom["sf_bytes"]
    cuda = dev.type == "cuda"
    results, spans = {}, [] if cuda else None
    split = {"crc": 0.0, "read": 0.0}

    def load(g):
        bufs = []
        for i in g:
            buf = torch.empty(geom["frame_bytes"], dtype=torch.uint8,
                              pin_memory=cuda)
            t0 = time.perf_counter()
            rd.read_frame_into(i, buf.numpy())
            split["read"] += (time.perf_counter() - t0) * 1e3
            bufs.append(buf)
        with _span(spans, "h2d"):
            return g, [b[:n_sf * nb].view(n_sf, nb).to(dev, non_blocking=True)
                       for b in bufs]

    def device_fn(x):
        g, bys = x
        with _span(spans, "device"):
            return g, [dec(by) for by in bys]

    def write(_index, y):
        g, outs = y
        for i, (ok, wck, ock) in zip(g, outs):
            results[i] = (bool(ok), int(wck), int(ock))

    with timed_crc(split):
        t0 = time.perf_counter()
        with serve.T3V6StreamReader(path, approve_meta=approve) as rd:
            stats = StreamExecutor(load, device_fn, write, prefetch,
                                   device=dev).run(
                _groups(rd.frame_count, group))
        wall = (time.perf_counter() - t0) * 1e3
    split["io"] = split.pop("read") - split["crc"]
    split["dispatch"] = stats.dispatch_s * 1e3
    return results, _span_ms(spans, split), wall


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="serve_bench")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--group", type=int, default=4,
                    help="frames an executor item (container records stay "
                    "per frame)")
    ap.add_argument("--sfb", type=int, default=128)
    ap.add_argument("--wh", default="7680x4320")
    ap.add_argument("--path", default=os.path.join(tempfile.gettempdir(),
                                                   "serve_bench.t3v"))
    ap.add_argument("--keep-file", action="store_true",
                    help="leave the T3V6 file at --path")
    ap.add_argument("--probe", action="store_true",
                    help="H2D/D2H, CRC32 and file IO alone")
    ap.add_argument("--host-only", action="store_true",
                    help="the host serve station alone (CRC32 and T3V6 "
                    "write, gated read and CRC check), no device work")
    ap.add_argument("--tmpfs", default=None,
                    help="with --host-only: a directory on a memory file "
                    "system to time beside --path")
    add_device_arg(ap)
    return ap.parse_args(argv)


def serve_cfg() -> EncoderConfig:
    return EncoderConfig(profile=ProfileID.P2_RS26_22, uep=uep_luma_priority())


def stage_frames(cfg, n_raw, n_frames, dev):
    """The JAX tool's frames as host (n_sf, sf, 9) int8 chunks, pinned when
    ``dev`` is a card: bench.py's RAW words + (i + 1) mod 27 for frame i."""
    base = torch.as_tensor(base_chunks(n_raw, cfg.superframe_words,
                                       np.random.default_rng(0)))
    out = []
    for i in range(n_frames):
        host = torch.empty(base.shape, dtype=torch.int8,
                           pin_memory=dev.type == "cuda")
        out.append(torch.remainder(base + (i + 1) % 27, 27, out=host))
    return out


def run(argv=None, keep=None) -> dict:
    """The benchmark's result dict; raises ``BenchFailure`` when a check
    fails.  ``keep(leg)`` (a context manager) wraps the read pass."""
    args = parse(argv)
    dev = resolve_device(args.device)
    if args.host_only:
        return host_only(args)
    W, H = map(int, args.wh.split("x"))
    n_raw = W * H // 2
    cfg = serve_cfg()
    G = args.group
    N = -(-args.frames // G) * G
    enc, dec, geom = serve.serve_codec_fns(cfg, n_raw, args.sfb, device=dev)
    fb = geom["frame_bytes"]
    print(f"frame: {geom['n_sf']} sf x {geom['sf_bytes']} B = {fb / 1e6:.1f} "
          f"MB payload; {N} frames in {N // G} groups of {G}", flush=True)
    frames = stage_frames(cfg, n_raw, N, dev)
    if args.probe:
        return probe(dev, geom, frames[0], args.path)
    launches, peaks = {}, {}
    with counted(launches, "warmup"):             # frame 0, discarded
        by, ck = enc(frames[0].to(dev))
        ok, wck, _ock = dec(by)
        require(bool(ok) and int(wck) == int(ck), "warm-up serve round trip")
    with counted(launches, "write"), peak_bytes(peaks, "write", dev):
        cks, ws, wall_w = serve_write(cfg, n_raw, frames, args.path, dev, W,
                                      H, group=G, sf_batch=args.sfb,
                                      fsync=True)
    admit = policy.t3v_approve_with_policy(
        policy.Policy(memberships=[policy.Membership("acme/")]))
    with counted(launches, "read"), peak_bytes(peaks, "read", dev), \
            keep("serve read") if keep else contextlib.nullcontext():
        res, rs_, wall_r = serve_read(cfg, n_raw, args.path, dev, admit,
                                      group=G, sf_batch=args.sfb)
    if not args.keep_file:
        os.remove(args.path)
    require(sorted(res) == list(range(N)), f"serve read: frames {sorted(res)}")
    fails = [i for i, (ok, wck, _o) in sorted(res.items())
             if not ok or wck != cks[i]]
    require(not fails, f"serve decode failed frames {fails[:8]}")
    t_enc, t_dec = wall_w / 1e3, wall_r / 1e3
    s = lambda d, k: d.get(k, 0.0) / 1e3
    return {"serve_write_fps": N / t_enc, "serve_read_fps": N / t_dec,
            "serve_fps": N / (t_enc + t_dec), "frames": N, "group": G,
            "frame_mb": fb / 1e6,
            "disk_write_gbps": N * fb / s(ws, "io") / 1e9
            if ws["io"] else None,
            "crc_gbps": N * fb / s(ws, "crc") / 1e9 if ws["crc"] else None,
            "enc_split_s": {"stage_h2d": s(ws, "h2d"),
                            "dispatch": s(ws, "dispatch"),
                            "device": s(ws, "device"), "d2h": s(ws, "d2h"),
                            "crc": s(ws, "crc"), "io": s(ws, "io"),
                            "fsync": s(ws, "fsync")},
            "dec_split_s": {"read": s(rs_, "crc") + s(rs_, "io"),
                            "crc": s(rs_, "crc"), "io": s(rs_, "io"),
                            "h2d": s(rs_, "h2d"),
                            "dispatch": s(rs_, "dispatch"),
                            "device": s(rs_, "device")},
            "peak_bytes": peaks,
            "backend": f"torch-{dev.type}", "device": smi_line(dev),
            "k1_launches": {k: n["check_decode"] for k, n in launches.items()},
            "k2_launches": {k: n["rs_correct"] for k, n in launches.items()}}


def host_only(args) -> dict:
    """The host serve station alone: N frames of synthetic wire bytes
    through CRC32 and the T3V6 writer (fsync), then the gated read with its
    CRC check, at ``--path`` and, with ``--tmpfs``, in that directory."""
    W, H = map(int, args.wh.split("x"))
    fb = FRAME_BYTES_8K if args.wh == "7680x4320" else 4 * (W * H // 2)
    fb = -(-fb // 4) * 4
    N = args.frames
    base = np.random.default_rng(0).integers(0, 243, fb, dtype=np.uint8)
    paths = [("disk", args.path)]
    if args.tmpfs:
        paths.insert(0, ("tmpfs", os.path.join(args.tmpfs, "serve_host.t3v")))
    out = {}
    for name, path in paths:
        wtr = serve.T3V6StreamWriter(path, SubwordMode.S27, W, H, N, fb,
                                     meta_per_frame='{"domain":"acme/x"}')
        t0 = time.perf_counter()
        for i in range(N):
            base[:8] = np.frombuffer(np.int64(i).tobytes(), np.uint8)
            wtr.write_frame(i, base)
        wtr._f.flush()
        os.fsync(wtr._f.fileno())
        t_w = time.perf_counter() - t0
        wtr.close()
        rd = serve.T3V6StreamReader(path, approve_meta=lambda m: True)
        t0 = time.perf_counter()
        for i in range(N):
            rd.read_frame_bytes(i)                # includes the CRC check
        rd.close()
        t_r = time.perf_counter() - t0
        os.remove(path)
        out[name] = {"write_fps": N / t_w, "read_fps": N / t_r,
                     "write_gbps": N * fb / t_w / 1e9,
                     "read_gbps": N * fb / t_r / 1e9}
    return {"host_only": out, "frames": N, "frame_mb": fb / 1e6}


def probe(dev, geom, frame0, path) -> dict:
    """H2D and D2H (with one add on the device) of a frame's wire bytes and
    of its RAW chunks, CRC32 of the bytes, and file write and read."""
    bytes_host = torch.as_tensor(np.random.default_rng(1).integers(
        0, 243, size=(geom["n_sf"], geom["sf_bytes"]), dtype=np.uint8))
    out = {}
    for name, arr in (("u8 bytes", bytes_host), ("int8 chunks", frame0)):
        arr.to(dev)                               # cold H2D
        sync(dev)
        nxt = arr + 1
        t0 = time.perf_counter()
        d = nxt.to(dev)
        sync(dev)
        h2d = time.perf_counter() - t0
        t0 = time.perf_counter()
        (d + 1).cpu()
        d2h = time.perf_counter() - t0
        nb = arr.numel()
        out[name] = {"mb": nb / 1e6, "h2d_gbps": nb / h2d / 1e9,
                     "d2h_plus_one_op_gbps": nb / d2h / 1e9}
        print(f"{name}: {out[name]}", flush=True)
    buf = bytes_host.numpy().tobytes()
    t0 = time.perf_counter()
    serve._crc32(buf)
    out["crc32_gbps"] = len(buf) / (time.perf_counter() - t0) / 1e9
    probe_path = path + ".probe"
    t0 = time.perf_counter()
    with open(probe_path, "wb") as f:
        f.write(buf)
    out["file_write_gbps"] = len(buf) / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    with open(probe_path, "rb") as f:
        f.read()
    out["file_read_gbps"] = len(buf) / (time.perf_counter() - t0) / 1e9
    os.remove(probe_path)
    return {"probe": out, "backend": f"torch-{dev.type}",
            "device": smi_line(dev)}


def main(argv=None, keep=None) -> int:
    return run_main(run, argv, keep=keep)


if __name__ == "__main__":
    raise SystemExit(main())
