"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one output line each:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: both CUDA kernels from ``ternary_image_codec_tpu_torch/csrc``;
3. K2 (RS correction chain) against its plain torch twin on the card, bit
   for bit on every block, for k in {18, 20, 22, 24}: 262,144 codewords
   each (a third with <= t errors, a third with t+1, the rest clean), again
   at the sizes the main path launches it with and at a size that is not a
   multiple of a block, on digits outside 0..2 (which count mod 3), and
   on a synthetic copy of the fused window (k=22, 6,144 codewords, most
   warps clean, one warp dirty in its last lane only); its times by CUDA
   events over calls one by one (``ms``) and from a CUDA graph
   (``device_ms``) at 262,144, at the path sizes and on the window;
4. K1 (check decode) against its plain twin, max_abs_err 0 and equal ok
   flags: 8K superframes (every 8th damaged) as the encoder's strided
   view and as a contiguous copy, at 2,025 and at the roundtrip's 64;
   random bytes over all 256 values; a second layout (P1, k = 24, 512
   words) at 1,001 superframes; P2 at 16,384 words (300 superframes), too
   large for the kernel's shared-memory stage; then its times at 2,025 and
   64 superframes (and at 16,384 words) against the memory bound, by CUDA
   events over calls one by one and as device time from a CUDA graph;
5. the main path at full size through the port's public stream API: one
   8K frame (7680x4320, 2 px per word: 16,588,800 RAW words, 2,025
   superframes, P2 with luma-priority UEP) encoded and decoded with the
   fused strategy, clean and under the benchmark's damage model (fused and
   auto), also from contiguous (n_sf, total, 9) words (every strategy
   clean, fused dirty), then an overcap copy that must fail safe; both
   kernels' launch counters must rise; K2's real repair windows of the
   dirty decode (dirty warps counted beside the synthetic copy's, held
   bit-equal to the twin, the k=22 one timed); encode, clean and dirty
   decode ms per frame.

Then a JSON line with each kernel's numbers (``device_ms`` is the
CUDA-graph time; K2's ``at_path_sizes`` holds its path-size times), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Any failed check exits nonzero before that line is printed.
Tolerance everywhere: zero (the codec is integer arithmetic).
"""
import json
import subprocess
import sys
import time

import numpy as np

W8K, H8K = 7680, 4320
SF_BATCH = 64          # superframes per plain-torch micro-batch
REPAIR_CAP = 64        # fused repair window
K2_BLOCKS = 262_144
# K2's launch sizes on the main path: per k-group of body bands, 16 blocks
# x 6 pages x the superframes repaired (64 in the fused window, 20 for the
# damaged ones under auto); header blocks, 2 per superframe repaired.  The
# tail size leaves the kernel's last block partly empty.
K2_PATH_BLOCKS = {18: (128, 40), 20: (6144, 1920), 22: (6144, 1920)}
K2_TAIL_BLOCKS = 1000
K2_PAGE = 16           # blocks per page of the paged corrector
K2_WINDOW_PAGES = 6    # page slots per superframe in the k=22 window
K2_WINDOW_DIRTY = 20   # damaged superframes of the dirty frame
K2_LAST_LANE_SLOT = 40  # a clean slot whose first warp gets one dirty lane
K1_SMALL_SF = 64       # the roundtrip's micro-batch: fewer superframes than SMs
K1_RANDOM_SF = 300
K1_P1_SF = 1001        # second layout's count, no multiple of the grid
K1_BIG_WORDS = 16384   # a superframe too large for K1's shared-memory stage
K1_BIG_SF = 300        # more superframes than the kernel's persistent grid
# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory, int8 tensor cores
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Device time of fn, captured reps times into one CUDA graph and
    replayed (after one warm-up call and one warm-up replay): the host's
    per-call work stays out of the reading."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn):
    """Host time of fn, synchronised on both sides; returns (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_device(torch):
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible; "
          f"nvidia-smi: {smi_line}", flush=True)
    return name, smi_line


def phase_build():
    """Both kernels at once: one nvcc process per source."""
    from concurrent.futures import ThreadPoolExecutor
    from ternary_image_codec_tpu_torch.runtime import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(build.load, ("check_decode", "rs_correct")))
    print(f"[2 build] check_decode.cu, rs_correct.cu with nvcc for sm_90a, "
          f"in parallel: {time.perf_counter() - t0:.1f} s", flush=True)


def _k2_codewords(torch, k, nerr, rng):
    """(data digits (3, k, B), received digits (3, 26, B)) of B = len(nerr)
    random codewords; codeword b carries nerr[b] symbol errors."""
    from ternary_image_codec_tpu_torch.ops import gf27, rs
    B = len(nerr)
    data = rng.integers(0, 27, size=(B, k))
    to_pm = lambda s: np.ascontiguousarray(
        gf27.np_sym_to_dig(s).transpose(2, 1, 0)).astype(np.int8)
    cw_pm = rs.encode_pm(torch.as_tensor(to_pm(data)), k).numpy()
    cw = gf27.np_dig_to_sym(cw_pm.transpose(2, 1, 0))
    rank = np.argsort(rng.random((B, 26)), axis=1).argsort(axis=1)
    err = np.where(rank < nerr[:, None], rng.integers(1, 27, (B, 26)), 0)
    recv = gf27.tables()["add"][cw, err]
    return to_pm(data), to_pm(recv)


def _k2_spread(k, B):
    """Errors per codeword, spread over every warp: b % 3 == 0 carries
    1..t errors, b % 3 == 1 carries t + 1, the rest none."""
    t = (26 - k) // 2
    b = np.arange(B)
    return np.where(b % 3 == 0, 1 + (b // 3) % t, np.where(b % 3 == 1, t + 1, 0))


def _k2_window(k):
    """Errors per codeword of the fused repair window as ``paged_body``
    hands it to K2 for one k-group: REPAIR_CAP superframe slots x 6 page
    slots x 16 blocks.  The first 20 slots (the damaged superframes) carry
    one damaged codeword (1..t errors) in each of their first 5 pages, the
    other slots are clean, but for the last lane of the first warp of slot
    K2_LAST_LANE_SLOT."""
    t = (26 - k) // 2
    rng = np.random.default_rng(k)
    nerr = np.zeros((REPAIR_CAP, K2_WINDOW_PAGES, K2_PAGE), dtype=np.int64)
    for s in range(K2_WINDOW_DIRTY):
        for p in range(K2_WINDOW_PAGES - 1):
            nerr[s, p, rng.integers(K2_PAGE)] = 1 + (s + p) % t
    nerr = nerr.reshape(-1)
    nerr[K2_LAST_LANE_SLOT * K2_WINDOW_PAGES * K2_PAGE + 31] = 1
    return nerr


def k2_bound_ms(k, B):
    """K2's least time on B codewords: received digits (3, 26, B) read once,
    data digits (3, k, B) and ok flags written once, over the HBM rate (the
    chain's integer work is data-dependent and not counted)."""
    return (3 * 26 + 3 * k + 1) * B / HBM_BPS * 1e3


def phase_k2(torch, dev):
    """K2 against its plain twin, bit-equal on every block (failed ones
    included) with equal ok flags, and every block with <= t errors back
    to its data; then its times: ``ms`` by CUDA events over calls one by
    one (the wrapper's host work included), ``device_ms`` from a CUDA graph
    of back-to-back launches (left out)."""
    from ternary_image_codec_tpu_torch.ops import rs, rs_cuda
    rng = np.random.default_rng(3)
    worst, held, times = 0, [], {}

    def equal(k, recv, what):
        nonlocal worst
        got, got_ok = rs_cuda.rs_correct(recv, k)
        want, want_ok = rs.correct_pm_ref(recv, k)
        torch.cuda.synchronize()
        require(torch.equal(got_ok, want_ok), f"K2 {what}: ok flags differ")
        require(torch.equal(got, want), f"K2 {what}: data differs")
        worst = max(worst, int((got.to(torch.int16)
                                - want.to(torch.int16)).abs().max()))
        held.append(what)
        return got, got_ok, want_ok

    def hold(k, nerr, what, moved=False):
        data_np, recv_np = _k2_codewords(torch, k, nerr, rng)
        if moved:   # every digit moved by a multiple of 3, out of 0..2
            recv_np = (recv_np + 3 * rng.integers(-42, 42, recv_np.shape)
                       ).astype(np.int8)
        data = torch.as_tensor(data_np, device=dev)
        recv = torch.as_tensor(recv_np, device=dev)
        what = f"k={k} {what}"
        got, got_ok, want_ok = equal(k, recv, what)
        within = torch.as_tensor(nerr <= (26 - k) // 2, device=dev)
        require(bool(got_ok[within].all()), f"K2 {what}: a <= t block failed")
        require(torch.equal(torch.remainder(got[:, :, within], 3),
                            data[:, :, within]),
                f"K2 {what}: a <= t block did not decode to its data")
        return recv, float(want_ok.float().mean())

    def timed(key, recv, k, reps, plain=False):
        run = lambda: rs_cuda.rs_correct(recv, k)
        times[key] = {"ms": cuda_ms(torch, run, reps),
                      "device_ms": graph_ms(torch, run, reps),
                      "bound_ms": k2_bound_ms(k, recv.shape[-1])}
        if plain:
            times[key]["plain_ms"] = cuda_ms(
                torch, lambda: rs.correct_pm_ref(recv, k), 3)

    for k in (18, 20, 22, 24):
        for B in (K2_BLOCKS,) + K2_PATH_BLOCKS.get(k, ()) + (K2_TAIL_BLOCKS,):
            recv, ok_rate = hold(k, _k2_spread(k, B), f"B={B}")
            if B == K2_BLOCKS:
                timed(f"k={k} B={B}", recv, k, 20, plain=True)
                times[f"k={k} B={B}"]["ok_rate"] = ok_rate
            elif B != K2_TAIL_BLOCKS:
                timed(f"k={k} B={B}", recv, k, 100)
        # digits outside 0..2 count as their value mod 3
        hold(k, _k2_spread(k, K2_TAIL_BLOCKS), f"B={K2_TAIL_BLOCKS} digits "
             "moved by multiples of 3", moved=True)
        noise = torch.randint(-128, 128, (3, 26, K2_TAIL_BLOCKS), device=dev,
                              dtype=torch.int8, generator=torch.Generator(
                                  device=dev).manual_seed(k))
        noise.view(-1)[:256] = (torch.arange(256, device=dev) - 128
                                ).to(torch.int8)
        equal(k, noise, f"k={k} random int8 digits B={K2_TAIL_BLOCKS}")
    nerr = _k2_window(22)
    recv, _ = hold(22, nerr, f"fused window B={len(nerr)}")
    timed(f"k=22 window B={len(nerr)}", recv, 22, 100)
    print(f"[3 K2 rs_correct vs plain] bit-equal (max_abs_err {worst}, ok "
          f"flags equal) on {len(held)} inputs: {'; '.join(held)}; times "
          "(ms by events one by one, device ms from a CUDA graph, bound ms): "
          + "; ".join(f"{key}: " + ", ".join(f"{n} {v:.4f}" for n, v in
                                             t.items())
                      for key, t in times.items()), flush=True)
    return times, worst


def k1_bound(layout, n_sf):
    """(bound ms, "bytes" or "operations", bytes moved) of K1 on n_sf
    superframes: the wire bodies read once, the RAW planes and ok flags
    written once, over the HBM rate; the syndrome products that the bands'
    r rows need (int8 multiply-adds, 2 operations each) over the int8
    tensor-core rate."""
    g = layout.geom
    moved = n_sf * (9 * g.H + 9 * layout.n_out_words + 1)
    ops = n_sf * g.blocks[0] * sum(2 * 3 * (26 - k) * 78 for k in g.ks)
    t_bytes, t_ops = moved / HBM_BPS * 1e3, ops / INT8_TC_OPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (moved,)


def _k1_equal(torch, body, codec, what):
    """K1 against its plain twin on one input; returns (max_abs_err, ok)."""
    from ternary_image_codec_tpu_torch.ops import dec_cuda
    got, got_ok = dec_cuda.check_decode(body, codec.dlayout)
    want, want_ok = dec_cuda.check_decode_ref(body, codec.tables())
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"K1 {what}: outputs differ from plain")
    require(torch.equal(got_ok, want_ok), f"K1 {what}: ok flags differ")
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max()), got_ok


def _k1_words(torch, dev, codec, n_sf, seed):
    """Encoded wire planes (n_sf, 9, 6 + H) with every 8th superframe
    damaged in one body cell."""
    g = torch.Generator(device=dev).manual_seed(seed)
    chunks = torch.randint(0, 27, (n_sf, codec.cfg.superframe_words, 9),
                           generator=g, device=dev, dtype=torch.int8)
    words = codec.encode(chunks, sf_batch=SF_BATCH)
    hit = torch.arange(0, n_sf, 8, device=dev)
    col = 6 + codec.dlayout.geom.H // 2
    words[hit, 4, col] = (words[hit, 4, col] + 1) % 27
    return words


def phase_k1(torch, dev, codec, n_sf):
    """K1 against its plain twin: the encoder's strided bodies and their
    contiguous copies at n_sf and at the roundtrip's 64, clean and damaged
    superframes; bodies of random bytes over all 256 values; a second
    layout (P1, k = 24, 512 words) at a superframe count that is no
    multiple of the grid; P2 at 16,384 words, too large for shared memory
    (the kernel reads it in global memory).  Then its times: ``ms`` by CUDA
    events over calls one by one (the wrapper's host work included),
    ``device_ms`` from a CUDA graph of back-to-back launches (left out)."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.ops import dec_cuda
    checked, worst = [], 0

    def equal(body, cod, what, flagged_every=None):
        nonlocal worst
        err, ok = _k1_equal(torch, body, cod, what)
        if flagged_every:
            i = torch.arange(ok.numel(), device=dev)
            require(torch.equal(ok, i % flagged_every != 0),
                    f"K1 {what}: wrong superframes flagged")
        worst = max(worst, err)
        checked.append(what)

    words = _k1_words(torch, dev, codec, n_sf, seed=2)
    body = words[:, :, 6:]                                 # strided view
    dl = codec.dlayout
    plans = {"8K": dec_cuda.plan(body, dl)}
    require(plans["8K"]["staged"] == 1, f"8K plan not staged: {plans}")
    equal(body, codec, "8K view", 8)
    body_c = body.contiguous()
    equal(body_c, codec, "8K contiguous", 8)
    equal(body[:K1_SMALL_SF], codec, f"8K view n_sf={K1_SMALL_SF}", 8)
    equal(body_c[:K1_SMALL_SF], codec, f"8K contiguous n_sf={K1_SMALL_SF}", 8)
    g = torch.Generator(device=dev).manual_seed(5)
    noise = torch.randint(-128, 128, (K1_RANDOM_SF, 9, 6 + dl.geom.H),
                          generator=g, device=dev, dtype=torch.int8)
    noise.view(-1)[:256] = (torch.arange(256, device=dev) - 128).to(torch.int8)
    equal(noise[:, :, 6:], codec, "random bytes, view")
    equal(noise[:, :, 6:].contiguous(), codec, "random bytes, contiguous")
    del noise

    p1 = port.SuperframeCodec(port.EncoderConfig(
        profile=port.ProfileID.P1_RS26_24, uep=port.uep_uniform(0),
        superframe_words=512), device=dev)
    w1 = _k1_words(torch, dev, p1, K1_P1_SF, seed=3)
    plans["P1/512"] = dec_cuda.plan(w1[:, :, 6:], p1.dlayout)
    require(K1_P1_SF % plans["P1/512"]["grid"] != 0, f"P1 n_sf {K1_P1_SF} "
            f"is a multiple of the grid {plans['P1/512']['grid']}")
    equal(w1[:, :, 6:], p1, "P1/512 view", 8)
    equal(w1[:, :, 6:].contiguous(), p1, "P1/512 contiguous", 8)
    r1 = torch.randint(-128, 128, (K1_P1_SF, 9, 6 + p1.dlayout.geom.H),
                       generator=g, device=dev, dtype=torch.int8)
    equal(r1[:, :, 6:], p1, "P1/512 random bytes")
    del w1, r1, body_c

    big = port.SuperframeCodec(port.EncoderConfig(
        profile=port.ProfileID.P2_RS26_22, uep=port.uep_luma_priority(),
        superframe_words=K1_BIG_WORDS), device=dev)
    wb = _k1_words(torch, dev, big, K1_BIG_SF, seed=4)
    body_b = wb[:, :, 6:]
    plans["P2/16384"] = dec_cuda.plan(body_b, big.dlayout)
    require(plans["P2/16384"]["staged"] == 0
            and K1_BIG_SF > plans["P2/16384"]["grid"],
            f"P2/{K1_BIG_WORDS}: expected an unstaged plan with more "
            f"superframes than blocks, got {plans['P2/16384']}")
    equal(body_b, big, f"P2/{K1_BIG_WORDS} view", 8)
    equal(body_b.contiguous(), big, f"P2/{K1_BIG_WORDS} contiguous", 8)
    bl = big.dlayout
    ms_big = cuda_ms(torch, lambda: dec_cuda.check_decode(body_b, bl), 10)
    dev_big = graph_ms(torch, lambda: dec_cuda.check_decode(body_b, bl), 10)
    bound_big = k1_bound(bl, K1_BIG_SF)[0]
    del wb, body_b

    T = codec.tables()
    small = body[:K1_SMALL_SF]
    ms = cuda_ms(torch, lambda: dec_cuda.check_decode(body, dl), 20)
    ms_small = cuda_ms(torch, lambda: dec_cuda.check_decode(small, dl), 100)
    dev_ms = graph_ms(torch, lambda: dec_cuda.check_decode(body, dl), 20)
    dev_small = graph_ms(torch, lambda: dec_cuda.check_decode(small, dl), 100)
    plain = cuda_ms(torch, lambda: dec_cuda.check_decode_ref(body, T), 3)
    bound, bound_by, moved = k1_bound(dl, n_sf)
    bound_small = k1_bound(dl, K1_SMALL_SF)[0]
    print(f"[4 K1 check_decode vs plain] bit-equal (max_abs_err {worst}, ok "
          f"flags equal) on {len(checked)} inputs: {'; '.join(checked)}; "
          f"plans {plans}; at {n_sf} superframes, one by one (CUDA events): "
          f"kernel {ms:.4f} ms = {moved / ms / 1e6:.1f} GB/s, "
          f"{bound / ms:.3f} of the {bound:.4f} ms bound ({bound_by}); "
          f"device time (CUDA graph) {dev_ms:.4f} ms, {bound / dev_ms:.3f} "
          f"of the bound; plain {plain:.4f} ms; at {K1_SMALL_SF}: one by one "
          f"{ms_small:.4f} ms, device {dev_small:.4f} ms, bound "
          f"{bound_small:.4f} ms; P2/{K1_BIG_WORDS} unstaged at {K1_BIG_SF}: "
          f"one by one {ms_big:.4f} ms, device {dev_big:.4f} ms, bound "
          f"{bound_big:.4f} ms", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": worst}


def bench_damage(n_sf, total_w):
    """bench.py's dirty model for one frame: D=20 dirty superframes, E=8
    symbol errors each in distinct bands of the body, and 2 header-cell
    errors on the last 25% of them (same generator and draw order)."""
    D, E = min(20, n_sf), 8
    r2 = np.random.default_rng(1)
    si_sf = np.stack([r2.choice(n_sf, D, replace=False)]).reshape(-1)
    si = np.repeat(si_sf, E)
    bi = np.stack([r2.choice(9, E, replace=False) for _ in range(D)]).reshape(-1)
    pi = np.stack([6 + r2.choice(total_w - 6, E, replace=False)
                   for _ in range(D)]).reshape(-1)
    dlt = r2.integers(1, 27, size=si.shape)
    n_hdr = int(round(0.25 * D))
    sel = np.arange(D)[::-1][:n_hdr]
    hc = np.stack([r2.choice(52, 2, replace=False) for _ in range(n_hdr)])
    si = np.concatenate([si, np.repeat(si_sf[sel], 2)])
    bi = np.concatenate([bi, (hc % 9).reshape(-1)])
    pi = np.concatenate([pi, (hc // 9).reshape(-1)])
    dlt = np.concatenate([dlt, r2.integers(1, 27, size=2 * n_hdr)])
    return si_sf, (si, bi, pi, dlt)


def _dirty_warps(torch, dirty):
    """(dirty warps, warps) of a flag per codeword, 32 codewords a warp."""
    pad = torch.nn.functional.pad(dirty, (0, -dirty.numel() % 32))
    return int(pad.reshape(-1, 32).any(1).sum()), pad.numel() // 32


def k2_real_windows(torch, windows):
    """K2's inputs from one fused dirty decode: for each, k, codewords and
    dirty warps (a codeword with a nonzero syndrome makes its warp dirty);
    the k=22 window held bit-equal to the plain twin and timed."""
    from ternary_image_codec_tpu_torch.ops import rs, rs_cuda
    seen = []
    for recv, k in windows:
        nz = (rs.syndromes_pm(recv, k) != 0).flatten(0, 1).any(0)
        seen.append((k, recv.shape[-1], "%d/%d" % _dirty_warps(torch, nz)))
        got, got_ok = rs_cuda.rs_correct(recv, k)
        want, want_ok = rs.correct_pm_ref(recv, k)
        require(torch.equal(got, want) and torch.equal(got_ok, want_ok),
                f"K2 on the real k={k} window: differs from plain")
    recv = max((w for w, k in windows if k == 22), key=lambda w: w.shape[-1])
    run = lambda: rs_cuda.rs_correct(recv, 22)
    synth = torch.as_tensor(_k2_window(22) > 0)
    return {"windows": seen,
            "synthetic": "%d/%d" % _dirty_warps(torch, synth),
            "times": {"B": recv.shape[-1], "ms": cuda_ms(torch, run, 100),
                      "device_ms": graph_ms(torch, run, 100),
                      "bound_ms": k2_bound_ms(22, recv.shape[-1])}}


def phase_main(torch, dev, cfg):
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.ops import dec_cuda, gf27, rs_cuda

    # one 8K frame of RAW words, trit 26 zero (bench.py's generator)
    n_raw = W8K * H8K // 2
    r = np.random.default_rng(0)
    t = r.integers(0, 3, size=(n_raw, 27)).astype(np.int8)
    t[:, 26] = 0
    t = t.reshape(n_raw, 9, 3)
    raw_np = t[..., 0] + 3 * t[..., 1] + 9 * t[..., 2]
    del t
    raw = torch.as_tensor(raw_np, device=dev)
    sfw = cfg.superframe_words
    n_sf = -(-n_raw // sfw)

    def enc():
        return port.encode_stream_superframes(raw, cfg, sf_batch=SF_BATCH)

    def dec(words, strategy="fused"):
        return port.decode_stream_superframes(
            words, cfg, n_raw, sf_batch=SF_BATCH, strategy=strategy,
            repair_cap=REPAIR_CAP)

    dec_cuda.launches = 0
    rs_cuda.launches = 0
    ms_enc, words = wall_ms(torch, enc)
    total_w = words.shape[1]
    require(tuple(words.shape) == (n_sf, total_w, 9),
            f"encode shape {tuple(words.shape)}")
    ms_clean, (out, ok) = wall_ms(torch, lambda: dec(words))
    require(bool(ok), "clean fused decode: ok is False")
    require(torch.equal(out, raw), "clean fused decode differs from input")
    # the documented input layout as a file or another encoder hands it
    # over: contiguous (n_sf, total, 9), not a view of the encoder's planes
    words_c = words.contiguous()
    for strategy in ("check", "paged", "auto", "fused"):
        out, ok = dec(words_c, strategy)
        require(bool(ok) and torch.equal(out, raw),
                f"clean {strategy} decode of contiguous words failed")
    del words_c

    words_T = words.transpose(1, 2)                   # (n_sf, 9, total)
    si_sf, (si, bi, pi, dlt) = bench_damage(n_sf, total_w)
    idx = tuple(torch.as_tensor(a, device=dev) for a in (si, bi, pi))
    dirty_T = words_T.clone()
    dirty_T[idx] = ((dirty_T[idx].to(torch.int16)
                     + torch.as_tensor(dlt, device=dev)) % 27).to(torch.int8)
    dirty = dirty_T.transpose(1, 2)
    ms_dirty, (out, ok) = wall_ms(torch, lambda: dec(dirty))
    require(bool(ok), "dirty fused decode: ok is False")
    require(torch.equal(out, raw), "dirty fused decode differs from input")
    ms_auto, (out, ok) = wall_ms(torch, lambda: dec(dirty, "auto"))
    require(bool(ok), "dirty auto decode: ok is False")
    require(torch.equal(out, raw), "dirty auto decode differs from input")
    # K2's inputs of this decode are kept: the real repair windows
    windows, rs_correct = [], rs_cuda.rs_correct

    def keep(recv, k):
        windows.append((recv.clone(), k))
        return rs_correct(recv, k)
    rs_cuda.rs_correct = keep
    try:
        out, ok = dec(dirty.contiguous())
    finally:
        rs_cuda.rs_correct = rs_correct
    require(bool(ok) and torch.equal(out, raw),
            "dirty fused decode of contiguous words failed")

    # overcap: 3 GF(27) errors in one k=22 codeword (band 1, block 2) of 2
    # superframes outside the dirty set; the repair must flag them
    clean_sf = np.setdiff1d(np.arange(n_sf), si_sf)[:2]
    over_T = dirty_T.clone()
    cols = 6 + 2 * 26 + torch.arange(3, device=dev)
    for sf in clean_sf:
        cell = over_T[int(sf), 1, cols]
        e = torch.tensor([1, 1, 2], dtype=torch.int8, device=dev)
        over_T[int(sf), 1, cols] = gf27.dig_to_sym(
            gf27.mod3(gf27.sym_to_dig(cell).to(torch.int16)
                      + gf27.sym_to_dig(e)))
    _, ok = dec(over_T.transpose(1, 2))
    require(not bool(ok), "overcap damage: ok is True")
    launches = {"check_decode": dec_cuda.launches,
                "rs_correct": rs_cuda.launches}
    require(all(v > 0 for v in launches.values()),
            f"a kernel never ran on the main path: {launches}")
    real = k2_real_windows(torch, windows)

    # agreement with the plain CPU path on a small input: four superframes,
    # two of them damaged
    pick = torch.as_tensor(np.concatenate([si_sf[:2], clean_sf]), device=dev)
    cpu = port.SuperframeCodec(cfg, device="cpu")
    gpu = port.SuperframeCodec(cfg, device=dev)
    chunks = torch.nn.functional.pad(raw, (0, 0, 0, n_sf * sfw - n_raw)) \
        .reshape(n_sf, sfw, 9)[pick]
    require(torch.equal(gpu.encode(chunks).cpu(), cpu.encode(chunks.cpu())),
            "small input: card encode differs from the CPU path")
    small = dirty_T[pick]
    g_out, g_ok = gpu.decode(small, strategy="fused", repair_cap=4)
    c_out, c_ok = cpu.decode(small.cpu(), strategy="fused", repair_cap=4)
    require(torch.equal(g_out.cpu(), c_out) and bool(g_ok) == bool(c_ok)
            and bool(c_ok), "small input: card decode differs from the CPU path")

    # warm timings (the first pass above includes one-time table builds)
    ms_enc2, _ = wall_ms(torch, enc)
    ms_clean2, _ = wall_ms(torch, lambda: dec(words))
    ms_dirty2, _ = wall_ms(torch, lambda: dec(dirty))
    print(f"[5 main path, one 8K frame: {n_raw} RAW words, {n_sf} superframes, "
          f"P2 luma UEP] exact round trip clean (fused; and all four strategies "
          f"on contiguous words), dirty D=20 E=8 hdr=25% (fused, auto, fused "
          f"on contiguous words), overcap flagged; launches {launches}; K2's "
          f"real windows (k, codewords, dirty warps of warps): {real['windows']}, "
          f"bit-equal to plain, synthetic k=22 window {real['synthetic']}; "
          f"K2 on the real k=22 window: {real['times']}; ms/frame first "
          f"pass: encode {ms_enc:.1f}, clean decode {ms_clean:.1f}, dirty decode "
          f"{ms_dirty:.1f}, dirty auto {ms_auto:.1f}; warm: encode "
          f"{ms_enc2:.1f}, clean decode {ms_clean2:.1f}, dirty decode "
          f"{ms_dirty2:.1f}", flush=True)
    return launches, real


def main():
    import torch
    name, smi_line = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    import ternary_image_codec_tpu_torch as port
    phase_build()
    k2, k2_err = phase_k2(torch, dev)
    cfg = port.EncoderConfig(profile=port.ProfileID.P2_RS26_22,
                             uep=port.uep_luma_priority())
    codec = port.SuperframeCodec(cfg, device=dev)
    n_sf = -(-(W8K * H8K // 2) // cfg.superframe_words)
    k1 = phase_k1(torch, dev, codec, n_sf)
    launches, real = phase_main(torch, dev, cfg)
    k2_big = k2[f"k=22 B={K2_BLOCKS}"]
    t = dict(real["times"])
    k2[f"k=22 real window B={t.pop('B')}"] = t
    # no single PyTorch call computes either function: library_ms is null
    kernels = [
        {"name": "check_decode", "route": "cuda",
         "source": "ternary_image_codec_tpu_torch/csrc/check_decode.cu",
         "replaces": "ternary_image_codec_tpu/ops/dec_pallas.py:116",
         "launches": launches["check_decode"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "rs_correct", "route": "cuda",
         "source": "ternary_image_codec_tpu_torch/csrc/rs_correct.cu",
         "replaces": "ternary_image_codec_tpu/ops/rs_pallas.py:199",
         "launches": launches["rs_correct"], "max_abs_err": k2_err,
         "ms": k2_big["ms"], "device_ms": k2_big["device_ms"],
         "plain_ms": k2_big["plain_ms"], "bound_ms": k2_big["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "at_path_sizes": {key: t for key, t in k2.items()
                           if f"B={K2_BLOCKS}" not in key}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
