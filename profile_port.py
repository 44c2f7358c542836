"""Per-stage times of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments, after ``chip_smoke.py`` has
shown the port correct on the card:

    python3 profile_port.py

On one 8K frame (the ``chip_smoke.py`` frame: P2 with luma-priority UEP,
2,025 superframes) it prints the host time of each stage, synchronised on
both sides, over five warm repetitions: encode at three ``sf_batch``
values, and decode under each strategy, clean and under ``bench.py``'s
damage model; then the pixel path on the ``chip_smoke.py`` RGB frame:
``ingest9_planes``, ``egress9_planes``, the e2e roundtrip (``feed`` and
``fold``), and the frames-batched fused decode of two damaged frames in
one call; then the serve path (``io/serve.py``): ``pack_wire`` and
``unpack_wire`` of one frame, ``enc_serve`` and ``dec_serve`` of one
frame, and ``chip_smoke.py``'s serve loop, write and read, over its 4
frames and a T3V6 file in a temporary directory (ms per frame; the file
is read back from the page cache); then the flagship streaming layout
(``chip_smoke.flagship_cfg``: P5 26x26, luma-priority UEP, a period-13
beacon in band 4) on the same frames: encode, check and fused clean and
dirty, full dirty, the e2e roundtrip; then the transform prototypes on
``chip_smoke.py``'s 8K RGB frame (``proto_stages``: Haar tiles, their
reconstruction, the spectral sketch, AnisoRC encode and reconstruction).
Then ``torch.profiler`` tables (self device time by op) for encode, the
fused and full dirty decodes, the e2e roundtrip, ``enc_serve``,
``dec_serve``, the flagship's encode, clean check, fused and full dirty
decodes and e2e, and each prototype stage, with the device busy share of
each: the device time of all its kernels over the median host time of the
same stage with the profiler off.
"""
import os
import tempfile
import time

import numpy as np

from chip_smoke import (H8K, REPAIR_CAP, SERVE_FRAMES, SF_BATCH, W8K,
                        damaged, flagship_cfg, pixel_roundtrip, proto_image,
                        proto_stages, rgb_frame, serve_frames, serve_read,
                        serve_write, wall_ms)

REPS = 5


def _frame(torch, dev):
    n_raw = W8K * H8K // 2
    t = np.random.default_rng(0).integers(0, 3, size=(n_raw, 27)).astype(np.int8)
    t[:, 26] = 0
    t = t.reshape(n_raw, 9, 3)
    return torch.as_tensor(t[..., 0] + 3 * t[..., 1] + 9 * t[..., 2], device=dev)


def _self_device_key(events):
    """The name of the self device time field in this torch version."""
    return ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    import ternary_image_codec_tpu_torch as port

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = port.EncoderConfig(profile=port.ProfileID.P2_RS26_22,
                             uep=port.uep_luma_priority())
    raw = _frame(torch, dev)
    n_raw = raw.shape[0]
    words = port.encode_stream_superframes(raw, cfg, sf_batch=SF_BATCH)
    n_sf = words.shape[0]
    dirty = damaged(torch, words)

    def dec(w, strategy):
        return lambda: port.decode_stream_superframes(
            w, cfg, n_raw, sf_batch=SF_BATCH, strategy=strategy,
            repair_cap=REPAIR_CAP)

    stages = [(f"encode, sf_batch {b}", lambda b=b:
               port.encode_stream_superframes(raw, cfg, sf_batch=b))
              for b in (SF_BATCH, 256, n_sf)]
    stages += [(f"decode {s}, clean", dec(words, s))
               for s in ("check", "auto", "fused")]
    stages += [(f"decode {s}, clean", dec(words, s)) for s in ("full", "none")]
    stages += [(f"decode {s}, dirty", dec(dirty, s))
               for s in ("auto", "fused", "full")]

    from ternary_image_codec_tpu_torch.ops import wordcodec as wc
    frame = rgb_frame(torch, dev)
    planes = wc.ingest9_planes(frame)
    pair = torch.stack([dirty, damaged(torch, words, seed=2)])
    e2e = pixel_roundtrip(torch, cfg, frame)

    stages += [("ingest9_planes", lambda: wc.ingest9_planes(frame)),
               ("egress9_planes", lambda: wc.egress9_planes(planes)),
               ("e2e roundtrip (feed, fold)", e2e),
               ("frames-batched fused dirty, F=2 (2 frames)",
                lambda: port.decode_frames_fused(pair, cfg, sf_batch=SF_BATCH,
                                                 repair_cap=REPAIR_CAP))]

    from ternary_image_codec_tpu_torch.io import serve
    from ternary_image_codec_tpu_torch.ops import wirepack
    from ternary_image_codec_tpu_torch.security import policy
    enc_serve, dec_serve, geom = serve.serve_codec_fns(cfg, n_raw, device=dev)
    frames = serve_frames(torch, cfg, n_raw, SERVE_FRAMES, dev)
    chunks = frames[0].to(dev)
    serve_planes = port.SuperframeCodec(cfg, device=dev).encode(chunks, 128)
    serve_by = enc_serve(chunks)[0]
    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "serve.t3v")
    admit = policy.t3v_approve_with_policy(
        policy.Policy(memberships=[policy.Membership("acme/")]))
    serve_write(torch, cfg, n_raw, frames, path, dev)
    stages += [
        ("pack_wire", lambda: wirepack.pack_wire(serve_planes)),
        ("unpack_wire", lambda: wirepack.unpack_wire(
            serve_by, geom["total_words"])),
        ("enc_serve (encode, pack, checksum)", lambda: enc_serve(chunks)),
        ("dec_serve (unpack, K1 check, checksums)",
         lambda: dec_serve(serve_by)),
        (f"serve write, {SERVE_FRAMES} frames a call",
         lambda: serve_write(torch, cfg, n_raw, frames, path, dev)),
        (f"serve read, {SERVE_FRAMES} frames a call",
         lambda: serve_read(torch, cfg, n_raw, path, dev, admit))]

    # the flagship streaming layout (P5 26x26, luma UEP, beacon 13 in band
    # 4) on the same RAW frame and pixel frame
    fcfg = flagship_cfg(port.config)
    fwords = port.encode_stream_superframes(raw, fcfg, sf_batch=SF_BATCH)
    fdirty = damaged(torch, fwords)
    fe2e = pixel_roundtrip(torch, fcfg, frame)

    def fdec(w, strategy):
        return lambda: port.decode_stream_superframes(
            w, fcfg, n_raw, sf_batch=SF_BATCH, strategy=strategy,
            repair_cap=REPAIR_CAP)

    flagship = [("flagship encode", lambda: port.encode_stream_superframes(
                    raw, fcfg, sf_batch=SF_BATCH)),
                ("flagship decode check, clean", fdec(fwords, "check")),
                ("flagship decode fused, clean", fdec(fwords, "fused")),
                ("flagship decode check, dirty", fdec(fdirty, "check")),
                ("flagship decode fused, dirty", fdec(fdirty, "fused")),
                ("flagship decode full, dirty", fdec(fdirty, "full")),
                ("flagship e2e roundtrip (feed, fold)", fe2e)]
    stages += flagship
    proto_calls, _ = proto_stages(proto_image(torch, dev, W8K, H8K), dev)
    protos = [(f"prototype {name}", fn) for name, fn in proto_calls.items()]
    stages += protos

    lines = [f"one 8K frame: {n_raw} RAW words, {n_sf} superframes; "
             f"{torch.cuda.get_device_name(0)}; host ms over {REPS} "
             f"warm repetitions"]
    median = {}
    for name, fn in stages:
        fn()                                         # warm-up
        ms = [wall_ms(torch, fn)[0] for _ in range(REPS)]
        median[name] = float(np.median(ms))
        lines.append(f"{name}: " + " ".join(f"{m:.2f}" for m in ms))
    for name, fn in ((stages[0][0], stages[0][1]),
                     ("decode fused, dirty", dec(dirty, "fused")),
                     ("decode full, dirty", dec(dirty, "full")),
                     ("e2e roundtrip (feed, fold)", e2e),
                     ("enc_serve (encode, pack, checksum)",
                      lambda: enc_serve(chunks)),
                     ("dec_serve (unpack, K1 check, checksums)",
                      lambda: dec_serve(serve_by)),
                     *(flagship[i] for i in (0, 1, 4, 5, 6)), *protos):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = [e for e in events if getattr(e, "device_type", None)
                   == torch.autograd.DeviceType.CUDA]
        key = _self_device_key(events)
        busy = sum(getattr(e, key) for e in kernels) / 1e3
        lines.append(f"--- profile: {name}: device {busy:.3f} ms; host "
                     f"{host:.2f} ms with the profiler on, median "
                     f"{median[name]:.2f} ms without; busy share "
                     f"{busy / median[name]:.3f}")
        lines.append(events.table(sort_by=key, row_limit=15))
    tmp.cleanup()
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
