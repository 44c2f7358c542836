"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one output line each:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the four CUDA sources from ``ternary_image_codec_tpu_torch/csrc``
   and the native host library (``runtime/src/t3native.cpp``);
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
4b. K3 (superframe encode) against its plain twin on the card, bit for
   bit: one 8K frame of ``p2_8k_luma`` (2,025 superframes) as the main
   path sends it, at n = 1, 3 and 64 and from a transposed (strided) input,
   the flagship P5 + beacon frame, the UEP grouping (0,1,2,2,1,0,1,1,2)
   and ``entry()``'s 720p superframe (460,800 words); one launch a call;
   its times at 2,025 superframes by CUDA events and from a CUDA graph
   beside the 0.1005 ms memory bound and the twin's time;
5. the main path at full size through the port's public stream API: one
   8K frame (7680x4320, 2 px per word: 16,588,800 RAW words, 2,025
   superframes, P2 with luma-priority UEP) encoded and decoded with the
   fused strategy, clean and under the benchmark's damage model (fused and
   auto), also from contiguous (n_sf, total, 9) words (every strategy
   clean, fused dirty), then an overcap copy that must fail safe; both
   kernels' launch counters must rise; K2's real repair windows of the
   dirty decode (dirty warps counted beside the synthetic copy's, held
   bit-equal to the twin, the k=22 one timed); encode, clean and dirty
   decode ms per frame;
6. the pixel path at full size: ``ingest9_planes`` on all 2^24 RGB
   triples and ``egress9_planes`` on all 243*81*81 pixel codes, each equal
   on the card to the port's CPU run; one 8K RGB frame (seed 0,
   (3, 2, 16,588,800) uint8) through ``roundtrip_stream(raw_wire="planes",
   feed=ingest, fold=egress)``, then encoded and decoded under full, none
   and fused, and full under the damage model, every output equal to
   egress9(ingest9(frame)) and the words to ingest9(frame); two damaged
   frames through ``decode_frames_fused``; a profile round trip at
   100,003 RAW words with 8 body errors; both kernels' launch counters
   must rise during that run, and every K1 and K2 input of it is kept and
   then held bit-equal to the kernel's twin (every launch size of the
   pixel path: the e2e's micro-batches, 2,025 and 4,050 superframes for
   K1; the full decode's ~7.3M codewords, the header chains and
   ``decode_header_from_words``'s 2 codewords for K2); after the run the
   frames-batched decode is held equal to two fused decodes; K2 timed on
   the damaged full decode's inputs (k=22, k=20 and the k=18 header
   chain), K1 on the frames-batched decode's 4,050 superframes; K4 and
   K5 (the frame bridges) against their twins on the card on every case of
   ``bridge_cases`` (every RGB triple and pixel code, random int8 words,
   1x1 and 3x5 frames, unaligned and strided inputs, one 8K frame each
   way), one launch a case; the same frame as (H, W, 3) through
   ``encode_rgb``/``decode_rgb(..., "auto")``, its launches counted alone
   (one K4, K3, K1 and K5 each, no K2), its counters in a profiler session
   (``t3.ingest.k4`` and ``t3.egress.k5`` once), its K1 input held to the
   twin, its wire and pixels equal to the stream's and the CPU's; K4 and
   K5 timed at 8K beside their 0.0743 ms bound and their twins; ingest,
   egress, e2e, full, none and frames-batched dirty decode ms per frame;
7. the serve path at full size: the native CRC library must build; 4
   seeded 8K frames (pinned host memory) through ``StreamExecutor``
   (prefetch 2): H2D, ``enc_serve`` (encode and base-243 wire pack), D2H
   and the T3V6 writer (CRC, file write) into a temporary file of ~450 MB,
   then read back behind a security policy that admits the domain (gated
   read and CRC check into pinned memory, H2D, ``dec_serve``: unpack, K1
   check decode, checksums); every frame ok with the encode's wire
   checksum, frame 0 decoded exactly and its file bytes equal to
   ``np_pack_wire`` of its wire planes, a flipped payload byte raises the
   CRC error, a denying policy raises before any payload byte is read; K1
   launched once a frame and K2 never, every K1 input held bit-equal to
   the twin; a second, warm pass; ms per frame of both directions and
   their split into device, H2D, D2H (CUDA events), CRC and file IO (host
   clock).

8. the layouts off the main path (``phase_layouts``): the flagship
   streaming layout (P5 26x26, luma-priority UEP, a period-13 beacon in
   band 4; bench.py's T3_BENCH_PROFILE=p5 T3_BENCH_BEACON=1) on one 8K
   frame: encode, check, auto and fused clean and under the damage model,
   full clean and damaged, none, an overcap copy that must fail safe,
   damaged beacon cells that must read as clean, 5 dirty pages of the
   beacon band in one superframe (flagged: the repair holds 4 a
   superframe) beside 4 in the next (repaired), equal to the CPU path, and
   the pixel round trip with ``feed``/``fold``; P2 with the same beacon
   and P5 26x26 without one on 64 superframes, fused clean and damaged;
   the UEP layout (0,1,2,2,1,0,1,1,2), whose k-groups are no residue
   classes, on one 8K frame through check and a damaged fused decode.  K1
   must launch on every leg (on the beacon and P5 legs its beacon and P5
   specialisations, the grid route's check) and K2 on every leg; every K1
   and K2 input of the phase is held bit-equal to the twin (the plain grid
   check on the grid route); K1's grid route also held on the flagship
   frame clean and damaged and on ``GRID_K1_CASES`` (small layouts with
   partial P5 tiles, beacons in bands 0, 4 and 8, one unstaged) and timed
   on the flagship frame against its bound and the plain grid check; K1
   timed on the UEP frame against its bound; ms per frame of each step
   and the peak device memory of the flagship's check and full decodes.
9. the transform prototypes and the CLI tools (``phase_protos``): whether
   PIL and ffmpeg are on the host (one JSON line); Haar ternary tiles, their
   reconstruction, the spectral sketch, AnisoRC encode and reconstruction
   on one 8K RGB frame (``rgb_frame``'s pixels) and one 1920x1080 frame
   (1080 rows take AnisoRC's 32-row resize pad), each equal to the port's
   CPU path on the same input (every integer output bit-equal, the sketch
   in at least 62 of its 64 trits), timed warm by CUDA events beside its
   memory bound, with its peak device memory; both prototype profiles at
   8K through ``profiles.encode_prototype_ternary`` into .t3proto files,
   read back and equal to the CPU run; the CLI tools on the card
   (``tool_legs``: main_bare, minitest_trits, minitest_codec, t3proto_tool
   on the 8K .t3proto, and where PIL is there t3proto_tool encode, main
   and minitest_aniso_rc on a PNG of the 1080p frame); K1 and K2 launches
   read per tool (the profile decode is the paged corrector: K2 for the
   header chain and the repair, K1 on no tool's path), every K1 and K2
   input of the tools held bit-equal to the kernel's twin.

10. multi-device (``phase_mesh``) through ``parallel/`` on the card, the
   kernels built once by phase 2 and only loaded by the ranks: (a) one
   NCCL rank: ``roundtrip_superframes_dp`` of one 8K frame (P2 + luma UEP,
   2,025 superframes) exact and equal to the single-device
   ``roundtrip_stream(rs_mode="paged")``; ``decode_superframes_fused_dp``
   of it under ``bench_damage`` at ``REPAIR_CAP`` exact and equal to the
   single-device fused decode, the superframes with damaged header cells
   flagged by the check and repaired, an overcap copy failing safe;
   frame-DP on 1920x1080 frames (one profile each, 2 a rank:
   ``roundtrip_step_dp``, ``decode_frames_dp`` of injected errors) and
   ``encode_stream_sharded`` of one of them; (b) two gloo ranks sharing
   the card: the same legs, equal to (a), and ``roundtrip_pipeline_pp``
   of the 8K frame's superframes as 5 microbatches of 405 frames, clean,
   with correctable link damage and beyond the paged capacity in one
   frame (exactly that frame flagged); (c) ``dryrun_multichip``'s legs on
   four gloo ranks sharing the card; (d) NCCL with one rank a card where
   there are two or more cards (otherwise one line says it did not run);
   (e) ``cli/channel_qa.py --device cuda --json`` equal to its CPU run, K2
   launched once a (k, error count).  K1/K2 launches are read per rank
   and leg (K1 only where a check decode runs, K2 wherever a paged decode
   does, nothing on PP's stage 0), every kernel input a rank launches is
   held bit-equal to the twin in that rank; ms per 8K frame by CUDA
   events (superframe-DP, fused-DP dirty, PP; the single-device calls
   beside them at world 1) and peak device memory per rank.
11. the benchmark entry points (``phase_bench``): ``bench/headline.py``
   (bench.py's clean, e2e and dirty legs on 8K frames), ``rs_bench``,
   ``full_mode_bench`` and ``serve_bench``, in-process at their defaults,
   the launch counters set to 0 before each and read after; each must
   exit 0 (its own exactness checks passed), K1 must launch in the
   headline's clean, e2e and dirty legs and in serve's read, K2 in the
   dirty leg, every k of rs_bench and both full-mode legs, the per-leg
   counts the tools print must add up to the counters, and every kernel
   input of the tools' kept calls is held bit-equal to the twin; each
   tool's JSON line is printed after its summary line.
12. the single-device entry step (``phase_entry``): ``entry.entry()`` on the card
   (the profile encode of one 720p frame, 460,800 RAW words, P2 with
   luma-priority UEP and a period-13 beacon in band 4), its build (host
   tables) by host clock, one cold and ten warm steps by CUDA events and
   the step's peak device memory; the (576868, 9) int8 output equal to the
   CPU step's on the same input and to a second call; the decode back on
   the card (``decode_profile_to_raw``: K2 for the header chain and the
   paged repair, which runs no check decode) exact clean and under a damage pattern
   fixed by its seed (at most t errors in codewords of three bands, the
   beacon band among them, one header cell, beacon cells), and an overcap
   copy flagged; K3 once in the step, K2 and never K1 in each decode,
   every K2 input held bit-equal to the twin.

Then a JSON line with each kernel's numbers (``device_ms`` is the
CUDA-graph time; ``at_path_sizes`` holds the times at the path's own
sizes, the full strategy's and the frames-batched decode's among them;
``launches`` counts phase 5's stream, ``launches_pixel_path`` phase 6's
run, ``launches_rgb_entry`` phase 6's ``encode_rgb``/``decode_rgb`` leg, ``launches_serve`` phase 7's first pass, ``launches_layouts`` phase
8's legs, ``launches_tools`` phase 9's tools, ``launches_mesh`` phase 10's
legs, a count per rank, ``launches_bench`` phase 11's tools by leg,
``launches_entry`` phase 12's step and decodes; K3's entry counts its
launches in each phase, ``launches_by_phase``, and a rank's in phase 10's
legs; ``bridge_ingest`` and ``bridge_egress`` are K4 and K5, their times
at 8K), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.  Any failed check exits nonzero before that line is printed.
Tolerance everywhere: zero (the codec is integer arithmetic), except the
spectral sketch's float32 DCT (at most 2 of 64 trits, as the reference's
own test allows against the C++).
"""
import contextlib
import functools
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
SMALL_SF = 64          # superframes of the P2-beacon and P5 legs
BEACON_PERIOD, BEACON_BAND = 13, 4   # bench.py's T3_BENCH_BEACON=1 layout
NONRESIDUE_UEP = (0, 1, 2, 2, 1, 0, 1, 1, 2)
SERVE_FRAMES = 4       # frames through the serve path's T3V6 file
SERVE_PREFETCH = 2     # executor queue depth
SERVE_META = '{"domain":"acme/video/serve","build_hash":"ab12"}'
# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory, int8 tensor cores
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


K12 = ("check_decode", "rs_correct")


def launch_counts():
    """A copy of the port's launch counter by kernel (``runtime/build.py``)."""
    from ternary_image_codec_tpu_torch.runtime import build
    return build.launches.copy()


def launches_since(before, kernels=K12):
    """Launches of ``kernels`` in this process since ``before``, a copy
    ``launch_counts`` took."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in kernels}


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
    """The kernels and the native host library at once: one nvcc process
    per kernel source, g++ for ``runtime/src/t3native.cpp``."""
    from concurrent.futures import ThreadPoolExecutor
    from ternary_image_codec_tpu_torch.runtime import build, native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        host = pool.submit(native.available)
        list(pool.map(build.load, ("check_decode", "rs_correct", "encode",
                                   "bridge")))
        require(host.result(), "g++ did not build runtime/src/t3native.cpp")
    print(f"[2 build] check_decode.cu, rs_correct.cu, encode.cu, bridge.cu "
          f"with nvcc for "
          f"sm_90a and t3native.cpp with g++, in parallel: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
    """K1 against its plain twin (``k1_twin``) on one input; returns
    (max_abs_err, ok)."""
    from ternary_image_codec_tpu_torch.ops import dec_cuda
    got, got_ok = dec_cuda.check_decode(body, codec.dlayout)
    want, want_ok = k1_twin(body, codec.dlayout, codec.tables())
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


def k3_bound_ms(n_sf, layout):
    """K3's memory bound: the RAW words read once, the wire planes written
    once, over the HBM rate."""
    moved = n_sf * 9 * (layout.n_raw_words + 6 + layout.geom.H)
    return moved / HBM_BPS * 1e3, moved


def phase_k3(torch, dev):
    """K3 against its plain twin (``encode_superframes_ref`` on the card),
    bit for bit: one 8K frame of the main path's layout at 2,025
    superframes, at 1, 3 and 64, from a transposed input; the flagship
    P5 + beacon frame; the UEP grouping (0,1,2,2,1,0,1,1,2); ``entry()``'s
    one 720p superframe.  Random RAW symbols 0..26, one superframe of each
    input over all 256 byte values.  One launch a call.  Then its times at
    2,025 superframes: ``ms`` by CUDA events over calls one by one (the
    wrapper's host work included), ``device_ms`` from a CUDA graph."""
    from ternary_image_codec_tpu_torch import config
    from ternary_image_codec_tpu_torch import entry as E
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.ops import enc_cuda, encode
    g = torch.Generator(device=dev).manual_seed(7)
    n8k = -(-(W8K * H8K // 2) // 8192)
    checked = []

    def chunks(n, n_raw):
        x = torch.randint(0, 27, (n, n_raw, 9), generator=g, device=dev,
                          dtype=torch.int8)
        x[0].view(-1)[:256] = (torch.arange(256, device=dev) - 128) \
            .to(torch.int8)
        return x

    def twin(x, codec):
        T = codec.tables()
        return torch.cat([encode.encode_superframes_ref(b, codec.layout, T)
                          for b in x.split(SF_BATCH)])

    def equal(x, codec, what):
        before = launch_counts()
        got = encode.encode_superframes(x, codec.layout, codec.tables())
        n = (launch_counts() - before)["superframe_encode"]
        require(n == 1, f"K3 {what}: {n} launches")
        require(torch.equal(got, twin(x, codec)),
                f"K3 {what}: wire planes differ from the twin")
        checked.append(what)

    luma = config.EncoderConfig(profile=config.ProfileID.P2_RS26_22,
                                uep=config.uep_luma_priority())
    codec = codec_for(luma, dev)
    x = chunks(n8k, 8192)
    equal(x, codec, f"p2_8k_luma n={n8k}")
    for n in (1, 3, 64):
        equal(x[:n].contiguous(), codec, f"p2_8k_luma n={n}")
    planes = x[:64].transpose(1, 2).contiguous()
    equal(planes.transpose(1, 2), codec, "p2_8k_luma n=64 transposed")
    del planes
    lay = codec.layout
    ms = cuda_ms(torch, lambda: enc_cuda.encode(x, lay), 20)
    dev_ms = graph_ms(torch, lambda: enc_cuda.encode(x, lay), 20)
    plain = cuda_ms(torch, lambda: twin(x, codec), 2)
    bound, moved = k3_bound_ms(n8k, lay)
    for name, cfg in (("flagship P5 + beacon", flagship_cfg(config)),
                      (f"uep {NONRESIDUE_UEP}", config.EncoderConfig(
                          profile=config.ProfileID.P2_RS26_22,
                          uep=config.UEPLayout(NONRESIDUE_UEP)))):
        equal(chunks(n8k, 8192), codec_for(cfg, dev),
              f"{name} n={n8k}")
    del x
    ecodec = codec_for(E.CFG, dev, E.N_RAW)
    equal(chunks(1, E.N_RAW), ecodec, f"entry 720p n=1 ({E.N_RAW} words)")
    plan = enc_cuda.plan(lay)
    print(f"[4b K3 superframe_encode vs plain] bit-equal, one launch a call, "
          f"on {len(checked)} inputs: {'; '.join(checked)}; plan {plan}; at "
          f"{n8k} superframes, one by one (CUDA events): kernel {ms:.4f} ms = "
          f"{moved / ms / 1e6:.1f} GB/s, {bound / ms:.3f} of the {bound:.4f} "
          f"ms bound (bytes); device time (CUDA graph) {dev_ms:.4f} ms, "
          f"{bound / dev_ms:.3f} of the bound; plain {plain:.2f} ms",
          flush=True)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "max_abs_err": 0}


def bench_damage(n_sf, total_w, seed=1):
    """bench.py's dirty model for one frame (``bench/damage.py``): D=20
    dirty superframes, E=8 symbol errors each in distinct bands of the body,
    and 2 header-cell errors on the last 25% of them.  Returns (dirty
    superframes, (si, bi, pi, dlt))."""
    from ternary_image_codec_tpu_torch.bench.damage import damage
    (_fi, si, bi, pi, dlt), (_fi_sf, si_sf) = damage(n_sf, total_w, frames=1,
                                                     seed=seed)
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
    from ternary_image_codec_tpu_torch.bench.headline import base_chunks
    from ternary_image_codec_tpu_torch.ops import gf27

    # one 8K frame of RAW words, trit 26 zero (bench.py's generator)
    n_raw = W8K * H8K // 2
    sfw = cfg.superframe_words
    raw = torch.as_tensor(base_chunks(n_raw, sfw, np.random.default_rng(0))
                          .reshape(-1, 9)[:n_raw], device=dev)
    n_sf = -(-n_raw // sfw)

    def enc():
        return port.encode_stream_superframes(raw, cfg, sf_batch=SF_BATCH)

    def dec(words, strategy="fused"):
        return port.decode_stream_superframes(
            words, cfg, n_raw, sf_batch=SF_BATCH, strategy=strategy,
            repair_cap=REPAIR_CAP)

    before = launch_counts()
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

    si_sf = bench_damage(n_sf, total_w)[0]
    dirty = damaged(torch, words)
    dirty_T = dirty.transpose(1, 2)                   # (n_sf, 9, total)
    ms_dirty, (out, ok) = wall_ms(torch, lambda: dec(dirty))
    require(bool(ok), "dirty fused decode: ok is False")
    require(torch.equal(out, raw), "dirty fused decode differs from input")
    ms_auto, (out, ok) = wall_ms(torch, lambda: dec(dirty, "auto"))
    require(bool(ok), "dirty auto decode: ok is False")
    require(torch.equal(out, raw), "dirty auto decode differs from input")
    # K2's inputs of this decode are kept: the real repair windows
    windows = []
    with kept_inputs([], windows):
        out, ok = dec(dirty.contiguous())
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
    launches = launches_since(before)
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


def damaged(torch, words, seed=1):
    """A copy of wire words (n_sf, total, 9) under ``bench_damage``."""
    from ternary_image_codec_tpu_torch.bench import damage as dmg
    n_sf, total_w = words.shape[:2]
    ev, _dirty = dmg.damage(n_sf, total_w, frames=1, seed=seed)
    return dmg.apply(words.transpose(1, 2)[None], ev)[0].transpose(1, 2)


def rgb_frame(torch, dev):
    """One 8K RGB frame, seed 0, plane-major (3, 2, W*H/2) uint8: channel,
    pixel of the pair, word."""
    m = W8K * H8K // 2
    rgb = np.random.default_rng(0).integers(0, 256, size=(3, 2, m),
                                            dtype=np.uint8)
    return torch.as_tensor(rgb, device=dev)


def pixel_roundtrip(torch, cfg, frame):
    """The e2e leg of one RGB frame (3, 2, m) uint8 as a call: per
    micro-batch of superframes, ``ingest9_planes`` of its pixels inside the
    pass (``feed``), encode, check decode and ``egress9_planes`` of the
    decoded planes (``fold``).  The call returns (RGB (n_sf, 3, 2, sfw),
    ok (n_sf,))."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.ops import wordcodec as wc
    sfw = cfg.superframe_words
    n_sf = frame.shape[-1] // sfw
    frame_sf = frame.view(3, 2, n_sf, sfw)

    def make(src, sidx):                              # (b,) -> (b, 9, sfw)
        return wc.ingest9_planes(src[:, :, sidx].permute(2, 0, 1, 3))

    def fold(out):                                    # (b, 9, n_out)
        return wc.egress9_planes(out[:, :, :sfw])

    return lambda: port.roundtrip_stream(
        torch.arange(n_sf, device=frame.device), cfg, sf_batch=SF_BATCH,
        raw_wire="planes", feed=(frame_sf, make), fold=fold)


def bridge_cases(torch, dev, full=True):
    """(name, kind, input) of the inputs K4 and K5 are held to their twins
    on: RGB (..., 3) uint8 for ``"ingest"``, word9 planes (..., 9, m) int8
    for ``"egress"``.  Small frames (1x1, 3x5, an odd frame at byte offsets
    1 and 13 of its buffer), every pixel code (243 * 81 * 81 words),
    random int8 words over all 256 values, strided planes (a slice, a word
    stride of 9, a superframe stride, an offset of 5 bytes); with ``full``
    also all 2^24 RGB triples and one seeded 8K frame each way, its planes
    as the decode's (n_sf, 9, words) view of (9, m)."""
    from ternary_image_codec_tpu_torch.ops import wordcodec as wc
    g = torch.Generator().manual_seed(21)

    def rnd(*shape, lo=0, hi=256, dtype=torch.uint8):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype).to(dev)
    flat = rnd(3 * 3001 + 16)
    yield "1x1", "ingest", rnd(1, 1, 3)
    yield "3x5", "ingest", rnd(3, 5, 3)
    yield "37x61", "ingest", rnd(37, 61, 3)
    for off in (1, 13):
        yield f"3001 px at offset {off}", "ingest", \
            flat[off:off + 3 * 3001].view(3001, 3)
    y, cb, cr = torch.meshgrid(torch.arange(243), torch.arange(81) - 40,
                               torch.arange(81) - 40, indexing="ij")
    codes = wc.quant_to_words9(torch.stack([y, cb, cr], -1).reshape(-1, 3))
    yield "every pixel code", "egress", codes.T.contiguous().to(dev)
    words = rnd(3, 9, 3001, lo=-128, hi=128, dtype=torch.int8)
    yield "random int8 (3, 9, 3001)", "egress", words
    yield "one word", "egress", words[:1, :, :1]
    yield "3x5's 8 words", "egress", words[0, :, :8]
    yield "sliced [:, :, 5:2990]", "egress", words[:, :, 5:2990]
    yield "word stride 9", "egress", \
        words.transpose(1, 2).contiguous().transpose(1, 2)
    yield "offset 5, superframe stride 3,100", "egress", \
        rnd(3 * 9 * 3100 + 8, lo=-128, hi=128, dtype=torch.int8)[5:] \
        [:3 * 9 * 3100].view(3, 9, 3100)[:, :, :3001]
    if full:
        v = torch.arange(1 << 24, dtype=torch.int32)
        yield "all 2^24 RGB triples", "ingest", torch.stack(
            [v >> 16, (v >> 8) & 255, v & 255], -1).to(torch.uint8).to(dev)
        del v
        frame = rgb_frame(torch, dev)
        img = frame.permute(2, 1, 0).reshape(H8K, W8K, 3)
        yield "8K frame", "ingest", img
        planes = wc.ingest9_ref(img, torch.empty(
            (H8K * W8K // 2, 9), dtype=torch.int8, device=dev)).T.contiguous()
        yield "8K frame's planes (2025, 9, 8192) view", "egress", \
            planes.view(9, -1, 8192).transpose(0, 1)


def hold_bridges(torch, dev, ingest, egress, full=True):
    """``ingest(rgb, out)`` and ``egress(planes)`` against ``wordcodec.
    ingest9_ref``/``egress9_ref`` on every ``bridge_cases`` input, bit for
    bit (the words written into a buffer of 99s); returns the cases'
    names."""
    from ternary_image_codec_tpu_torch.ops import wordcodec as wc
    names = []
    for name, kind, x in bridge_cases(torch, dev, full):
        if kind == "ingest":
            n = -(-x.numel() // 6)
            got = ingest(x, torch.full((n, 9), 99, dtype=torch.int8,
                                       device=dev))
            want = wc.ingest9_ref(x, torch.empty((n, 9), dtype=torch.int8,
                                                 device=dev))
        else:
            got, want = egress(x), wc.egress9_ref(x)
        require(got.shape == want.shape and torch.equal(got, want),
                f"{kind} bridge on {name}: differs from the twin")
        names.append(f"{kind} {name}")
    return names


def bridge_bound_ms(n_px):
    """Each bridge's memory bound: 3 bytes a pixel and 9 a word, each moved
    once, over the HBM rate (248,832,000 B at 8K: 0.0743 ms)."""
    moved = 3 * n_px + 9 * -(-n_px // 2)
    return moved / HBM_BPS * 1e3, moved


@contextlib.contextmanager
def kept_inputs(k1, k2):
    """Inside the block, a copy of every K1 input (body, layout) goes to
    ``k1`` and of every K2 input (recv, k) to ``k2`` before the kernel
    runs; the wrappers and their launch counts are unchanged."""
    from ternary_image_codec_tpu_torch.ops import dec_cuda, rs_cuda
    check_decode, rs_correct = dec_cuda.check_decode, rs_cuda.rs_correct

    def keep1(body, layout):
        k1.append((body.clone(), layout))
        return check_decode(body, layout)

    def keep2(recv, k):
        k2.append((recv.clone(), k))
        return rs_correct(recv, k)
    dec_cuda.check_decode, rs_cuda.rs_correct = keep1, keep2
    try:
        yield
    finally:
        dec_cuda.check_decode, rs_cuda.rs_correct = check_decode, rs_correct


def k1_twin(body, layout, T):
    """K1's plain twin for ``layout``: ``check_decode_ref`` on K1's own
    route, ``pipeline.grid_check`` on the grid route's (its beacon and P5
    specialisations)."""
    from ternary_image_codec_tpu_torch.ops import dec_cuda, pipeline
    if dec_cuda.supported(layout):
        return dec_cuda.check_decode_ref(body, T)
    return pipeline.grid_check(body, layout, T)


def hold_kept(torch, dev, k1_in, k2_in, what):
    """Every kept K1 and K2 input run again through the kernel and its
    plain twin: bit-equal outputs and flags."""
    from ternary_image_codec_tpu_torch.ops import dec_cuda, pipeline, rs, rs_cuda
    for body, layout in k1_in:
        _dl, T = pipeline._body_decoder_tables(
            pipeline.header_config(layout.hdr), layout.H, dev)
        got, got_ok = dec_cuda.check_decode(body, layout)
        want, want_ok = k1_twin(body, layout, T)
        require(torch.equal(got, want) and torch.equal(got_ok, want_ok),
                f"K1 on {what}'s n_sf={body.shape[0]} input: differs from "
                "plain")
    for recv, k in k2_in:
        got, got_ok = rs_cuda.rs_correct(recv, k)
        want, want_ok = rs.correct_pm_ref(recv, k)
        require(torch.equal(got, want) and torch.equal(got_ok, want_ok),
                f"K2 on {what}'s k={k} B={recv.shape[-1]} input: differs "
                "from plain")


def phase_pixel(torch, dev, cfg):
    """The pixel path at full size through the port's public entry points:
    the bridges against their CPU runs on every RGB triple and every pixel
    code; one 8K RGB frame round-tripped with ``feed``/``fold``, then
    encoded and decoded under full, none and fused (full also damaged),
    and two damaged frames through the frames-batched fused decode; one
    profile round trip.  Every K1 and K2 input of that run is then held
    against the kernel's twin, K2 timed on the full strategy's inputs and
    K1 on the frames-batched decode's.  K4 and K5 against their twins
    (``hold_bridges``), the RGB entry's launches and counters, K4 and K5
    timed at 8K.  Returns (launches, K1, K2, K4 and K5 times at those
    sizes, stage times)."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.ops import (bridge_cuda, dec_cuda, rs,
                                                   rs_cuda, wordcodec as wc)
    # every RGB triple (2^24 pixels) and every quantized pixel code
    # (243 * 81 * 81), card against CPU; the CPU run is the one tier-1
    # holds against the JAX package
    v = torch.arange(1 << 24, dtype=torch.int32)
    cube = torch.stack([v >> 16, (v >> 8) & 255, v & 255]).to(torch.uint8) \
        .reshape(3, 2, 1 << 23)
    require(torch.equal(wc.ingest9_planes(cube.to(dev)).cpu(),
                        wc.ingest9_planes(cube)),
            "ingest9_planes on the card differs from the CPU on the RGB cube")
    y, cb, cr = torch.meshgrid(torch.arange(243), torch.arange(81) - 40,
                               torch.arange(81) - 40, indexing="ij")
    codes = wc.quant_to_words9(torch.stack([y, cb, cr], -1).reshape(-1, 3)).T
    require(torch.equal(wc.egress9_planes(codes.to(dev)).cpu(),
                        wc.egress9_planes(codes)),
            "egress9_planes on the card differs from the CPU on every code")
    del v, cube, codes
    # K4 and K5 (the frame bridges on the card) against their twins on the
    # card, one launch a case
    before = launch_counts()
    bridge_checked = hold_bridges(torch, dev, wc.ingest9, wc.egress9)
    ran = launch_counts() - before
    for kind in ("ingest", "egress"):
        n = sum(c.startswith(kind) for c in bridge_checked)
        require(ran[f"bridge_{kind}"] == n,
                f"K4/K5: {ran[f'bridge_{kind}']} {kind} launches for {n} "
                "cases")
    torch.cuda.empty_cache()

    frame = rgb_frame(torch, dev)                     # (3, 2, m)
    m, sfw = frame.shape[-1], cfg.superframe_words
    n_sf = m // sfw
    require(n_sf * sfw == m, "8K frame is no whole number of superframes")
    planes = wc.ingest9_planes(frame)                 # (9, m)
    want_rgb = wc.egress9_planes(planes)
    raw = planes.T                                    # (m, 9) RAW words
    e2e = pixel_roundtrip(torch, cfg, frame)
    words = port.encode_stream_superframes(raw, cfg, sf_batch=SF_BATCH)
    dirty = damaged(torch, words)
    pair = torch.stack([dirty, damaged(torch, words, seed=2)])
    prof_raw = raw[:100_003]
    n_prof = prof_raw.shape[0]

    def dec(w, strategy):
        return port.decode_stream_superframes(
            w, cfg, m, sf_batch=SF_BATCH, strategy=strategy,
            repair_cap=REPAIR_CAP)

    # the pixel path's run: the launch counts and every kernel input are
    # read from here to the end of the profile round trip
    k1_in, k2_in, k2_full = [], [], []
    before = launch_counts()
    with kept_inputs(k1_in, k2_in):
        rgb_rt, ok = e2e()
        require(bool(ok.all()), "e2e roundtrip (feed, fold): ok is False")
        require(torch.equal(rgb_rt.permute(1, 2, 0, 3).reshape(3, 2, m),
                            want_rgb),
                "e2e roundtrip pixels differ from egress9(ingest9(frame))")
        for name, w, strategy in (("full", words, "full"),
                                  ("none", words, "none"),
                                  ("fused", words, "fused"),
                                  ("full, damaged", dirty, "full")):
            first = len(k2_in)
            out, ok = dec(w, strategy)
            require(bool(ok), f"{name} decode of the 8K pixel frame: ok is "
                    "False")
            require(torch.equal(out, raw), f"{name} decode: words differ")
            require(torch.equal(wc.egress9_planes(out.T), want_rgb),
                    f"{name} decode: pixels differ")
        k2_full = k2_in[first:]                       # the damaged full's
        both, ok2 = port.decode_frames_fused(pair, cfg, sf_batch=SF_BATCH,
                                             repair_cap=REPAIR_CAP)
        require(bool(ok2), "frames-batched fused decode (F=2): ok is False")
        prof = port.encode_profile_from_raw(prof_raw, cfg, frame_seq=7)
        prof_d = prof.clone()
        # 8 body errors in distinct codewords, 4 in each k-group's bands
        # (the paged corrector holds 6 dirty pages a group)
        rows = 6 + torch.arange(8, device=dev) * ((prof.shape[0] - 6) // 8) + 5
        bands = torch.as_tensor([0, 3, 6, 0, 1, 2, 4, 5], device=dev)
        prof_d[rows, bands] = (prof_d[rows, bands] + 1) % 27
        out, hdr, ok = port.decode_profile_to_raw(prof_d)
        require(ok and hdr.frame_seq == 7
                and torch.equal(out[:n_prof], prof_raw),
                f"profile round trip at {n_prof} words with 8 body errors "
                "failed")
    launches = launches_since(before)
    require(all(v > 0 for v in launches.values()),
            f"a kernel never ran on the pixel path: {launches}")
    require(launches == {"check_decode": len(k1_in), "rs_correct": len(k2_in)},
            f"launches {launches} but {len(k1_in)} K1 and {len(k2_in)} K2 "
            "inputs kept")

    # the frames-batched decode against two single-frame fused decodes
    for f in range(2):
        one, ok1 = codec_for(cfg, dev).decode(pair[f].transpose(1, 2),
                                              "fused", REPAIR_CAP, SF_BATCH)
        require(bool(ok1) and torch.equal(both[f], one),
                f"frames-batched decode, frame {f}: differs from one fused "
                "decode")
        require(torch.equal(both[f, :, :, :sfw].permute(0, 2, 1)
                            .reshape(m, 9), raw),
                f"frames-batched decode, frame {f}: words differ")
    del both, one

    # every kernel input of the run against the kernel's plain twin
    T = codec_for(cfg, dev).tables()
    shapes = {"check_decode": {}, "rs_correct": {}}
    for body, layout in k1_in:
        require(layout is codec_for(cfg, dev).dlayout,
                "K1 ran on another layout than the stream's")
        _k1_equal(torch, body, codec_for(cfg, dev), f"pixel path n_sf="
                  f"{body.shape[0]}")
        key = f"n_sf={body.shape[0]}"
        shapes["check_decode"][key] = shapes["check_decode"].get(key, 0) + 1
    for recv, k in k2_in:
        got, got_ok = rs_cuda.rs_correct(recv, k)
        want, want_ok = rs.correct_pm_ref(recv, k)
        require(torch.equal(got, want) and torch.equal(got_ok, want_ok),
                f"K2 on the pixel path's k={k} B={recv.shape[-1]} input: "
                "differs from plain")
        key = f"k={k} B={recv.shape[-1]}"
        shapes["rs_correct"][key] = shapes["rs_correct"].get(key, 0) + 1
    del k1_in, k2_in, got, want

    # K2 timed on the damaged full decode's inputs, K1 on the
    # frames-batched decode's body
    at_sizes = {"check_decode": {}, "rs_correct": {}}
    require(sorted(k for _r, k in k2_full) == [18, 20, 22],
            f"full decode: K2 inputs {[(w.shape, k) for w, k in k2_full]}")
    for recv, k in k2_full:
        run = lambda r=recv, k=k: rs_cuda.rs_correct(r, k)
        what = "header chain" if k == 18 else "full"
        at_sizes["rs_correct"][f"k={k} {what} B={recv.shape[-1]}"] = {
            "ms": cuda_ms(torch, run, 10), "device_ms": graph_ms(torch, run, 10),
            "plain_ms": cuda_ms(torch, lambda r=recv, k=k:
                                rs.correct_pm_ref(r, k), 1),
            "bound_ms": k2_bound_ms(k, recv.shape[-1])}
    del k2_full
    body = pair.transpose(2, 3).flatten(0, 1).contiguous()[:, :, 6:]
    dl = codec_for(cfg, dev).dlayout
    run = lambda: dec_cuda.check_decode(body, dl)
    at_sizes["check_decode"][f"frames-batched n_sf={body.shape[0]}"] = {
        "ms": cuda_ms(torch, run, 10), "device_ms": graph_ms(torch, run, 10),
        "plain_ms": cuda_ms(torch, lambda: dec_cuda.check_decode_ref(body, T),
                            1),
        "bound_ms": k1_bound(dl, body.shape[0])[0]}
    del body

    # the RGB entry: the same frame as one (H, W, 3) image through
    # encode_rgb and decode_rgb on the card, its launches counted alone
    # (one K3, one K1, no K2) and its K1 input held to the twin; then
    # against the same calls on the CPU and the stream's words and pixels
    img = frame.permute(2, 1, 0).reshape(H8K, W8K, 3)
    codec = codec_for(cfg, dev)
    legs, k1_rgb, k2_rgb = {}, [], []

    def rgb_leg():
        wire = codec.encode_rgb(img)
        return (wire,) + codec.decode_rgb(wire, "auto", size=(H8K, W8K))
    before = launch_counts()
    wire, back, ok = counted_leg(legs, k1_rgb, k2_rgb, "rgb_entry", rgb_leg)
    legs["rgb_entry"].update(launches_since(before, ["bridge_ingest",
                                                     "bridge_egress"]))
    launches["rgb_entry"] = legs["rgb_entry"]
    require(legs["rgb_entry"] == {"superframe_encode": 1, "check_decode": 1,
                                  "rs_correct": 0, "bridge_ingest": 1,
                                  "bridge_egress": 1},
            f"encode_rgb + decode_rgb(auto) of a clean 8K frame: launches "
            f"{legs['rgb_entry']}, not one K4, K3, K1 and K5 each and no K2")
    # the leg's counters in a profiler session: K4 and K5 once a request
    from ternary_image_codec_tpu_torch.runtime import tracing
    tracing.report(reset=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rgb_leg()
    counts = tracing.report(reset=True)["counts"]
    require(counts.get("t3.ingest.k4") == 1 and counts.get("t3.egress.k5") == 1,
            f"encode_rgb + decode_rgb under a profiler: counters {counts}, "
            "not t3.ingest.k4 and t3.egress.k5 once each")
    for body, layout in k1_rgb:
        require(layout is codec.dlayout, "decode_rgb's K1 ran on another "
                "layout than the stream's")
        _k1_equal(torch, body, codec, f"decode_rgb n_sf={body.shape[0]}")
    del k1_rgb, k2_rgb
    require(bool(ok), "decode_rgb of the 8K RGB frame: ok is False")
    require(torch.equal(wire.transpose(1, 2), words),
            "encode_rgb differs from the stream encode of ingest9's words")
    require(torch.equal(back, want_rgb.permute(2, 1, 0).reshape(H8K, W8K, 3)),
            "decode_rgb differs from egress9(ingest9(frame))")
    t0 = time.perf_counter()
    cpu = codec_for(cfg, "cpu")
    require(torch.equal(cpu.encode_rgb(img.cpu()), wire.cpu()),
            "encode_rgb on the card differs from the CPU")
    back_cpu, ok_cpu = cpu.decode_rgb(wire.cpu(), "auto", size=(H8K, W8K))
    require(bool(ok_cpu) and torch.equal(back_cpu, back.cpu()),
            "decode_rgb on the card differs from the CPU")
    cpu_s = time.perf_counter() - t0
    del cpu, back_cpu

    # K4 and K5 at 8K: the frame into the words, the decode's planes back
    raw_rgb, _ok = codec.decode(wire, "auto")
    raw_rgb = raw_rgb[:, :, :sfw]
    words_rgb = torch.empty((m, 9), dtype=torch.int8, device=dev)
    bound, moved = bridge_bound_ms(2 * m)
    at_sizes["bridge"] = {}
    for name, run, twin in (
            ("ingest", lambda: bridge_cuda.ingest(img, words_rgb),
             lambda: wc.ingest9_ref(img, words_rgb)),
            ("egress", lambda: bridge_cuda.egress(raw_rgb),
             lambda: wc.egress9_ref(raw_rgb))):
        at_sizes["bridge"][name] = {
            "ms": cuda_ms(torch, run, 20), "device_ms": graph_ms(torch, run, 20),
            "plain_ms": cuda_ms(torch, twin, 2), "bound_ms": bound,
            "bytes": moved}
    del raw_rgb, words_rgb

    # warm times, ms per frame
    times = {
        "encode_rgb": wall_ms(torch, lambda: codec.encode_rgb(img))[0],
        "decode_rgb": wall_ms(torch, lambda: codec.decode_rgb(
            wire, size=(H8K, W8K)))[0],
        "ingest": wall_ms(torch, lambda: wc.ingest9_planes(frame))[0],
        "egress": wall_ms(torch, lambda: wc.egress9_planes(planes))[0],
        "e2e roundtrip": wall_ms(torch, e2e)[0],
        "full decode clean": wall_ms(torch, lambda: dec(words, "full"))[0],
        "full decode dirty": wall_ms(torch, lambda: dec(dirty, "full"))[0],
        "none decode": wall_ms(torch, lambda: dec(words, "none"))[0],
        "frames-batched fused dirty (F=2, per frame)": wall_ms(
            torch, lambda: port.decode_frames_fused(
                pair, cfg, sf_batch=SF_BATCH, repair_cap=REPAIR_CAP))[0] / 2,
    }
    print(f"[6 pixel path, one 8K RGB frame: {2 * m} pixels, {n_sf} "
          f"superframes] ingest9/egress9 on the card equal to the CPU on all "
          f"2^24 RGB triples and all 243*81*81 pixel codes; e2e roundtrip "
          f"(raw_wire planes, feed ingest9, fold egress9), full, none and "
          f"fused decodes, full under the D=20 E=8 hdr=25% damage and the "
          f"frames-batched fused decode of 2 damaged frames all exact "
          f"(words and pixels; frames-batched equal to two fused decodes); "
          f"profile round trip at {n_prof} words, 8 body errors, exact; "
          f"K4/K5 equal to their twins on the card on "
          f"{len(bridge_checked)} inputs ({'; '.join(bridge_checked)}); "
          f"encode_rgb/decode_rgb of the frame as (H, W, 3) equal to the "
          f"stream's words and pixels and to the CPU's ({cpu_s:.1f} s), "
          f"launches {launches['rgb_entry']}, its K1 input bit-equal to "
          f"plain; "
          f"launches {launches}; every kernel input of the run bit-equal to "
          f"plain (inputs by shape: {shapes}); times at the path's sizes: "
          f"{at_sizes}; ms/frame warm: "
          + ", ".join(f"{k} {v:.1f}" for k, v in times.items()), flush=True)
    return launches, at_sizes, times



def serve_frames(torch, cfg, n_raw, n_frames, dev, seed=6):
    """``n_frames`` seeded frames of ``n_raw`` RAW words as (n_sf, sf, 9)
    int8 chunks (the tail zero-padded, trit 26 of every word zero), made
    on ``dev`` and handed over in host memory, pinned when ``dev`` is a
    card: what a capture process gives the serve encoder."""
    sf = cfg.superframe_words
    n_sf = -(-n_raw // sf)
    out = []
    for i in range(n_frames):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        raw = torch.randint(0, 27, (n_raw, 9), generator=g, device=dev,
                            dtype=torch.int8)
        raw[:, 8] %= 9
        chunks = torch.nn.functional.pad(raw, (0, 0, 0, n_sf * sf - n_raw))
        host = torch.empty(chunks.shape, dtype=torch.int8,
                           pin_memory=dev.type == "cuda")
        out.append(host.copy_(chunks).view(n_sf, sf, 9))
    return out


def serve_write(torch, cfg, n_raw, frames, path, dev, w=W8K, h=H8K):
    """The serve loop's write direction, one frame an executor item
    (``bench/serve_bench.serve_write``): (wire checksums per frame, ms
    split, wall ms)."""
    from ternary_image_codec_tpu_torch.bench import serve_bench
    return serve_bench.serve_write(cfg, n_raw, frames, path, dev, w, h,
                                   meta=SERVE_META, prefetch=SERVE_PREFETCH)


def serve_read(torch, cfg, n_raw, path, dev, approve):
    """The serve loop's read direction, one frame an executor item
    (``bench/serve_bench.serve_read``): ({frame: (ok, wire checksum, out
    checksum)}, ms split, wall ms)."""
    from ternary_image_codec_tpu_torch.bench import serve_bench
    return serve_bench.serve_read(cfg, n_raw, path, dev, approve,
                                  prefetch=SERVE_PREFETCH)


def serve_checks(torch, cfg, n_raw, frames, path, dev, cks, results):
    """What the serve loop must show (tier-1 holds the same helpers on the
    CPU): every frame ok with the encode's wire checksum; frame 0 decoded
    exactly from the file's bytes, which equal ``np_pack_wire`` of its wire
    planes (zero padding after them); one flipped payload byte raises the
    CRC error; a denying policy raises "not approved" with the file still
    at the payload's first byte and the buffer untouched.  Returns the
    check decode's out checksum of frame 0."""
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.io import serve
    from ternary_image_codec_tpu_torch.io.containers import ContainerError
    from ternary_image_codec_tpu_torch.ops import wirepack
    from ternary_image_codec_tpu_torch.security import policy
    _enc, dec, geom = serve.serve_codec_fns(cfg, n_raw, device=dev)
    n_sf, nb, sf = geom["n_sf"], geom["sf_bytes"], cfg.superframe_words
    require(sorted(results) == list(range(len(frames))),
            f"serve read: frames {sorted(results)} of {len(frames)}")
    for i, (ok, wck, _ock) in sorted(results.items()):
        require(ok, f"serve frame {i}: ok is False")
        require(wck == cks[i], f"serve frame {i}: wire checksum {wck} after "
                f"unpack, {cks[i]} at encode")
    with serve.T3V6StreamReader(path) as rd:
        pay = rd.read_frame_bytes(0)
        off = rd.index[1].offset + rd.index[1].meta_len + nb * (n_sf // 2)
    require(len(pay) == geom["frame_bytes"]
            and not any(pay[n_sf * nb:]), "frame 0: payload size or padding")
    by = torch.frombuffer(bytearray(pay[:n_sf * nb]), dtype=torch.uint8) \
        .view(n_sf, nb)
    codec = codec_for(cfg, dev)
    chunks = frames[0].to(dev)
    planes = codec.encode(chunks, 128)
    got = wirepack.unpack_wire(by.to(dev), geom["total_words"])
    require(torch.equal(got, planes), "frame 0: unpacked wire planes differ "
            "from the encoder's")
    out, ok = codec.check(got)
    require(bool(ok.all()) and torch.equal(out[:, :, :sf].transpose(1, 2),
                                           chunks),
            "frame 0: decoded RAW words differ from the source")
    planes = planes.cpu().numpy()
    by = by.numpy()
    for a in range(0, n_sf, 128):
        require(np.array_equal(by[a:a + 128],
                               wirepack.np_pack_wire(planes[a:a + 128])),
                f"frame 0: file bytes of superframes {a}.. differ from "
                "np_pack_wire")
    with open(path, "r+b") as f:                      # one payload byte
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    buf = np.empty(geom["frame_bytes"], dtype=np.uint8)
    try:
        with serve.T3V6StreamReader(path) as rd:
            rd.read_frame_into(1, buf)
        raise SmokeFailure("a flipped payload byte read back without error")
    except ContainerError as e:
        require("crc" in str(e), f"flipped payload byte: {e}")
    finally:
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(b)
    pol = policy.Policy(memberships=[policy.Membership("other/")])
    seen = []
    deny = policy.t3v_approve_with_policy(pol)
    buf.fill(0xAB)
    with serve.T3V6StreamReader(
            path, approve_meta=lambda m: seen.append(m) or deny(m)) as rd:
        try:
            rd.read_frame_into(2, buf)
            raise SmokeFailure("a denying policy read the payload")
        except ContainerError as e:
            require("not approved" in str(e), f"denied read: {e}")
        at = rd._f.tell()
        fi = rd.index[2]
    require(seen == [SERVE_META] and at == fi.offset + fi.meta_len
            and (buf == 0xAB).all(),
            f"denied read: approve saw {seen}, file at {at} (payload at "
            f"{fi.offset + fi.meta_len}), buffer touched")
    return int(serve.checksum(out))


def phase_serve(torch, dev, cfg):
    """The serve path at full size: 4 seeded 8K frames encoded, packed and
    written to a T3V6 file through the executor, then read back behind a
    policy that admits the domain, unpacked and check-decoded (K1); the
    checks of ``serve_checks``; every K1 input of the run held bit-equal to
    the twin; a second, warm pass of both directions.  Returns (launches
    in the first pass, times)."""
    import os
    import tempfile
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.runtime import native
    from ternary_image_codec_tpu_torch.security import policy
    require(native.available(), "the native CRC library did not build: "
            "the serve path would time zlib's CRC")
    n_raw = W8K * H8K // 2
    frames = serve_frames(torch, cfg, n_raw, SERVE_FRAMES, dev)
    admit = policy.t3v_approve_with_policy(
        policy.Policy(memberships=[policy.Membership("acme/")]))
    k1_in, k2_in = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve.t3v")
        before = launch_counts()
        with kept_inputs(k1_in, k2_in):
            cks, wsplit, wms = serve_write(torch, cfg, n_raw, frames, path, dev)
            res, rsplit, rms = serve_read(torch, cfg, n_raw, path, dev, admit)
        launches = launches_since(before)
        require(launches == {"check_decode": SERVE_FRAMES, "rs_correct": 0}
                and len(k1_in) == SERVE_FRAMES and not k2_in,
                f"serve launches {launches}, {len(k1_in)} K1 inputs kept: "
                f"one K1 launch a frame and no K2 expected")
        ock0 = serve_checks(torch, cfg, n_raw, frames, path, dev, cks, res)
        require(res[0][2] == ock0, "frame 0: out checksum of the serve loop "
                "differs from the direct decode's")
        codec = codec_for(cfg, dev)
        for body, layout in k1_in:
            require(layout is codec.dlayout, "K1 ran on another layout")
            _k1_equal(torch, body, codec, f"serve n_sf={body.shape[0]}")
        del k1_in
        mb = os.path.getsize(path) / 1e6
        cks2, wsplit2, wms2 = serve_write(torch, cfg, n_raw, frames, path, dev)
        res2, rsplit2, rms2 = serve_read(torch, cfg, n_raw, path, dev, admit)
        require(cks2 == cks and res2 == res, "warm serve pass differs")
    n = SERVE_FRAMES
    per = lambda d: {k: round(v / n, 3) for k, v in d.items()}
    times = {"write ms/frame": wms / n, "read ms/frame": rms / n,
             "write ms/frame warm": wms2 / n, "read ms/frame warm": rms2 / n,
             "write split ms/frame": per(wsplit),
             "read split ms/frame": per(rsplit),
             "write split ms/frame warm": per(wsplit2),
             "read split ms/frame warm": per(rsplit2)}
    print(f"[7 serve path, {n} 8K frames through a T3V6 file of {mb:.1f} MB "
          f"({SERVE_PREFETCH}-deep executor)] every frame ok, wire checksums "
          f"equal after unpack, frame 0 exact and its file bytes equal to "
          f"np_pack_wire, flipped payload byte raised the CRC error, denying "
          f"policy raised before any payload byte, native CRC in use; K1 "
          f"launches {launches['check_decode']} (K2 {launches['rs_correct']}), "
          f"every K1 input bit-equal to plain", flush=True)
    print(f"[7 serve times] first pass: write {wms / n:.1f} ms/frame "
          f"(split {per(wsplit)}), read {rms / n:.1f} ms/frame (split "
          f"{per(rsplit)}); warm: write {wms2 / n:.1f} ms/frame (split "
          f"{per(wsplit2)}), read {rms2 / n:.1f} ms/frame (split "
          f"{per(rsplit2)}); device, h2d and d2h by CUDA events on their "
          f"streams, crc and io by the host clock", flush=True)
    return launches, times

def counted_leg(legs, k1_in, k2_in, name, fn):
    """fn() with its K1, K2 and K3 launches read into ``legs[name]``; every
    K1 and K2 input of it is kept (``kept_inputs``)."""
    before = launch_counts()
    with kept_inputs(k1_in, k2_in):
        out = fn()
    legs[name] = launches_since(before, [*K12, "superframe_encode"])
    return out


def raw_frame(torch, dev, n_raw=W8K * H8K // 2, seed=0):
    """One frame of ``n_raw`` seeded RAW words (n_raw, 9) int8 on ``dev``,
    trit 26 zero (bench.py's generator)."""
    t = np.random.default_rng(seed).integers(0, 3, size=(n_raw, 27)) \
        .astype(np.int8)
    t[:, 26] = 0
    t = t.reshape(n_raw, 9, 3)
    return torch.as_tensor(t[..., 0] + 3 * t[..., 1] + 9 * t[..., 2],
                           device=dev)


def flagship_cfg(config):
    """The flagship streaming layout of bench.py (T3_BENCH_PROFILE=p5
    T3_BENCH_BEACON=1): P5 at the largest tile the header carries, 26x26,
    luma-priority UEP, a period-13 beacon in band 4."""
    return config.EncoderConfig(
        profile=config.ProfileID.P5_RS26_22_2D,
        uep=config.uep_luma_priority(), tile=config.Tile2D(26, 26),
        beacon=config.SparseBeaconCfg(BEACON_PERIOD, BEACON_BAND, True))


def layout_cfgs(config):
    """The layouts phase 8 drives: the flagship, P2 with the flagship's
    beacon, P5 26x26 without one, and the UEP grouping that is not a set
    of residue classes."""
    luma = config.uep_luma_priority()
    return {
        "flagship": flagship_cfg(config),
        "p2_beacon": config.EncoderConfig(
            profile=config.ProfileID.P2_RS26_22, uep=luma,
            beacon=config.SparseBeaconCfg(BEACON_PERIOD, BEACON_BAND, True)),
        "p5": config.EncoderConfig(
            profile=config.ProfileID.P5_RS26_22_2D, uep=luma,
            tile=config.Tile2D(26, 26)),
        "uep_nonresidue": config.EncoderConfig(
            profile=config.ProfileID.P2_RS26_22,
            uep=config.UEPLayout(NONRESIDUE_UEP)),
    }


def _add_sym(torch, words, idx, e):
    """words[idx] + e in GF(27) (digit-wise mod 3), in place."""
    from ternary_image_codec_tpu_torch.ops import gf27
    cell = words[idx]
    e = torch.as_tensor(e, dtype=torch.int8, device=words.device)
    words[idx] = gf27.dig_to_sym(gf27.mod3(
        gf27.sym_to_dig(cell).to(torch.int16) + gf27.sym_to_dig(e)))


def beacon_row(j, period):
    """The body row of the beacon band's payload symbol j (codeword j // 26,
    coefficient j % 26): the rows that are multiples of the period hold
    the beacon cells."""
    return j + j // (period - 1) + 1


def beacon_page_damage(torch, words_T, sf, pages, period, band):
    """One symbol error in each of the first ``pages`` 16-block pages of
    the beacon band of superframe ``sf`` (coefficient 3 of each page's
    first codeword, on its payload row r = j + j//(p-1) + 1), in place in
    wire planes (n_sf, 9, 6 + H)."""
    for pg in range(pages):
        row = beacon_row(pg * 16 * 26 + 3, period)
        _add_sym(torch, words_T, (sf, band, 6 + row), 1 + pg % 26)


# the grid route's layouts besides the flagship frame on which K1's beacon
# and P5 specialisations are held to the plain grid check (the CPU model
# test's cases, ``tests/test_torch_check_decode.py``, and one too large
# for the shared-memory stage): name -> (profile, superframe words, UEP
# band profiles (None: luma priority), scrambler seed, P5 tile, beacon
# (period, band))
GRID_K1_CASES = {
    "p5_26x26_b13/512": ("P5_RS26_22_2D", 512, None, (1, 1, 1), (26, 26), (13, 4)),
    "p5_26x26_b13/1024": ("P5_RS26_22_2D", 1024, None, (2, 1, 0), (26, 26), (13, 4)),
    "p5_8x4/208": ("P5_RS26_22_2D", 208, None, (0, 2, 1), (8, 4), None),
    "p2_b13/256": ("P2_RS26_22", 256, None, (2, 0, 1), None, (13, 4)),
    "p5_6x5_b7_band0/170": ("P5_RS26_22_2D", 170, NONRESIDUE_UEP, (2, 2, 0),
                            (6, 5), (7, 0)),
    "p2_b2_band8/184": ("P2_RS26_22", 184, None, (2, 1, 1), None, (2, 8)),
    "p5_26x26_b13/16000": ("P5_RS26_22_2D", 16000, None, (2, 1, 0), (26, 26),
                           (13, 4)),
}
GRID_K1_UNSTAGED = "p5_26x26_b13/16000"
GRID_K1_SF = 300       # more superframes than the kernel's persistent grid


def hold_grid_k1(torch, dev):
    """K1's beacon and P5 specialisations against the plain grid check on
    ``GRID_K1_CASES``: GRID_K1_SF encoded superframes, every 8th damaged
    in a payload cell of the beacon band (else of band 0) and every 8th + 3
    in beacon cells only (which must not flag), as the encoder's strided
    view and contiguous, then random bytes over all 256 values.  Returns
    the names held."""
    from ternary_image_codec_tpu_torch import SuperframeCodec, config as C
    from ternary_image_codec_tpu_torch.ops import dec_cuda, pipeline
    held = []
    for name, (prof, sfw, uep, seed, tile, beacon) in GRID_K1_CASES.items():
        kw = {}
        if tile:
            kw["tile"] = C.Tile2D(*tile)
        if beacon:
            kw["beacon"] = C.SparseBeaconCfg(*beacon, True)
        codec = SuperframeCodec(C.EncoderConfig(
            profile=C.ProfileID[prof], superframe_words=sfw,
            uep=C.UEPLayout(uep) if uep else C.uep_luma_priority(),
            seed=C.ScramblerSeed(*seed), **kw), device=dev)
        dl = codec.dlayout
        require(pipeline.check_route(dl) == "grid" and dec_cuda.covers(dl),
                f"K1 grid route {name}: the layout is not covered")
        g = torch.Generator(device=dev).manual_seed(sfw)
        words = codec.encode(torch.randint(
            0, 27, (GRID_K1_SF, sfw, 9), generator=g, device=dev,
            dtype=torch.int8), sf_batch=SF_BATCH)
        band = beacon[1] if beacon else 0
        row = beacon_row(2 * 26 + 5, beacon[0]) if beacon else 2 * 26 + 5
        hit = torch.arange(0, GRID_K1_SF, 8, device=dev)
        words[hit, band, 6 + row] = (words[hit, band, 6 + row] + 1) % 27
        if beacon:
            cells = torch.arange(3, GRID_K1_SF, 8, device=dev)
            for r in (0, beacon[0], 5 * beacon[0]):
                words[cells, band, 6 + r] = (words[cells, band, 6 + r] + 2) % 27
        body = words[:, :, 6:]
        staged = dec_cuda.plan(body, dl)["staged"]
        require(staged == (name != GRID_K1_UNSTAGED),
                f"K1 grid route {name}: staged is {staged}")
        i = torch.arange(GRID_K1_SF, device=dev)
        for what, b in (("view", body), ("contiguous", body.contiguous())):
            _err, ok = _k1_equal(torch, b, codec, f"grid route {name} {what}")
            require(torch.equal(ok, i % 8 != 0),
                    f"K1 grid route {name} {what}: wrong superframes flagged")
        noise = torch.randint(-128, 128, (GRID_K1_SF, 9, 6 + dl.H),
                              generator=g, device=dev, dtype=torch.int8)
        noise.view(-1)[:256] = (torch.arange(256, device=dev) - 128) \
            .to(torch.int8)
        _k1_equal(torch, noise[:, :, 6:], codec, f"grid route {name} noise")
        held.append(f"{name}{'' if staged else ' unstaged'}")
        del words, body, noise
    return held


def phase_layouts(torch, dev):
    """The configs off the main path at full width through the public
    entry points: the flagship layout on one 8K frame (encode; check, auto
    and fused clean and under the damage model; full and none; an overcap
    copy; damaged beacon cells; more than 4 dirty pages of the beacon band
    in one superframe; the pixel round trip); P2 with the beacon and P5
    without one on 64 superframes; the non-residue UEP layout on one 8K
    frame, its K1 launches held to the twin and timed.  The launch counts
    of each leg are read from that leg alone; every K1 and K2 input of the
    phase is kept and held bit-equal to the kernel's twin.  Returns
    (launches by leg, K1 and K2 times, stage times)."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch import config
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.ops import (dec_cuda, pipeline, rs,
                                                   rs_cuda, wordcodec as wc)
    cfgs = layout_cfgs(config)
    n_raw = W8K * H8K // 2
    raw = raw_frame(torch, dev, n_raw)
    legs, times, peaks = {}, {}, {}
    k1_in, k2_in = [], []
    counted = functools.partial(counted_leg, legs, k1_in, k2_in)

    def dec(cfg, w, strategy, n=n_raw):
        return port.decode_stream_superframes(
            w, cfg, n, sf_batch=SF_BATCH, strategy=strategy,
            repair_cap=REPAIR_CAP)

    def exact(cfg, w, strategy, what, n=n_raw, want_ok=True):
        ms, (out, ok) = wall_ms(torch, lambda: dec(cfg, w, strategy, n))
        require(bool(ok) == want_ok, f"{what}: ok is {bool(ok)}")
        if want_ok:
            require(torch.equal(out, raw[:n]), f"{what}: words differ")
        return ms

    # --- the flagship on one 8K frame --------------------------------------
    cfg = cfgs["flagship"]
    codec = codec_for(cfg, dev)
    require(pipeline.check_route(codec.dlayout) == "grid",
            "flagship layout: check route is not the grid check")
    p, b0 = cfg.beacon.words_period, cfg.beacon.band_slot

    def flagship():
        t = {}
        t["encode"], words = wall_ms(torch, lambda: port.encode_stream_superframes(
            raw, cfg, sf_batch=SF_BATCH))
        n_sf = words.shape[0]
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t["check clean"] = exact(cfg, words, "check", "flagship check")
        peaks["check clean"] = torch.cuda.max_memory_allocated(dev) - base
        t["auto clean"] = exact(cfg, words, "auto", "flagship auto")
        t["fused clean"] = exact(cfg, words, "fused", "flagship fused")
        dirty = damaged(torch, words)
        exact(cfg, dirty, "check", "flagship check, damaged", want_ok=False)
        t["auto dirty"] = exact(cfg, dirty, "auto", "flagship auto, damaged")
        t["fused dirty"] = exact(cfg, dirty, "fused",
                                 "flagship fused, damaged")
        t["full clean"] = exact(cfg, words, "full", "flagship full")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t["full dirty"] = exact(cfg, dirty, "full", "flagship full, damaged")
        peaks["full dirty"] = torch.cuda.max_memory_allocated(dev) - base
        t["none clean"] = exact(cfg, words, "none", "flagship none")
        # overcap: 3 GF(27) errors in one k=22 codeword (band 1, block 2)
        # of 2 clean superframes; the repair must flag them
        si_sf = bench_damage(n_sf, words.shape[1])[0]
        over_T = dirty.transpose(1, 2).clone()
        for sf in np.setdiff1d(np.arange(n_sf), si_sf)[:2]:
            _add_sym(torch, over_T, (int(sf), 1, slice(58, 61)), [1, 1, 2])
        exact(cfg, over_T.transpose(1, 2), "fused", "flagship overcap",
              want_ok=False)
        # beacon cells are never read: every 97th superframe gets 3 of them
        cell_T = words.transpose(1, 2).clone()
        for r in (0, p, 7 * p):
            _add_sym(torch, cell_T, (slice(0, n_sf, 97), b0, 6 + r), 5)
        cell = cell_T.transpose(1, 2)
        for strategy in ("check", "fused"):
            exact(cfg, cell, strategy, f"flagship beacon cells, {strategy}")
        # 5 dirty pages of the beacon band in superframe 3, 4 in 4: the
        # paged repair holds 4 a superframe
        cap_T = words.transpose(1, 2).clone()
        beacon_page_damage(torch, cap_T, 3, 5, p, b0)
        beacon_page_damage(torch, cap_T, 4, 4, p, b0)
        exact(cfg, cap_T.transpose(1, 2), "fused",
              "flagship beacon band over capacity", want_ok=False)
        few = cap_T[2:6].contiguous()
        out, ok = codec.paged(few)
        cpu_out, cpu_ok = codec_for(cfg, "cpu").paged(few.cpu())
        require(ok.tolist() == [True, False, True, True],
                f"beacon capacity: per-superframe ok {ok.tolist()}")
        require(torch.equal(out.cpu(), cpu_out) and torch.equal(ok.cpu(), cpu_ok),
                "beacon capacity: card differs from the CPU path")
        sfw = cfg.superframe_words
        want = raw[2 * sfw:6 * sfw].view(4, sfw, 9).transpose(1, 2)
        require(torch.equal(out[[0, 2, 3], :, :sfw], want[[0, 2, 3]])
                and not torch.equal(out[1, :, :sfw], want[1]),
                "beacon capacity: repaired superframes differ")
        # the pixel path: ingest inside the pass, egress as its fold
        frame = rgb_frame(torch, dev)
        want_rgb = wc.egress9_planes(wc.ingest9_planes(frame))
        e2e = pixel_roundtrip(torch, cfg, frame)
        t["e2e roundtrip"], (rgb, ok) = wall_ms(torch, e2e)
        m = frame.shape[-1]
        require(bool(ok.all()) and torch.equal(
            rgb.permute(1, 2, 0, 3).reshape(3, 2, m), want_rgb),
            "flagship e2e roundtrip (feed, fold) failed")
        return t, words, dirty, e2e

    t, words, dirty, e2e = counted("flagship", flagship)
    times["flagship"] = t
    # warm times of the same calls
    times["flagship warm"] = {
        "encode": wall_ms(torch, lambda: port.encode_stream_superframes(
            raw, cfg, sf_batch=SF_BATCH))[0],
        "check clean": wall_ms(torch, lambda: dec(cfg, words, "check"))[0],
        "fused clean": wall_ms(torch, lambda: dec(cfg, words, "fused"))[0],
        "fused dirty": wall_ms(torch, lambda: dec(cfg, dirty, "fused"))[0],
        "full dirty": wall_ms(torch, lambda: dec(cfg, dirty, "full"))[0],
        "e2e roundtrip": wall_ms(torch, e2e)[0]}
    body = words.transpose(1, 2)[:, :, 6:]
    T = codec.tables()
    times["flagship warm"]["grid check (device, CUDA events)"] = cuda_ms(
        torch, lambda: pipeline.grid_check(body, codec.dlayout, T), 5)
    # K1's grid route on the same frame, clean and damaged, as the decode
    # hands it over (contiguous planes, the body a strided view) and
    # contiguous; then timed against its bound and the plain grid check
    dl = codec.dlayout
    require(dec_cuda.covers(dl), "flagship layout: K1's grid route does "
            "not cover it")
    held = []
    for what, w in (("clean", words), ("damaged", dirty)):
        b = w.transpose(1, 2).contiguous()[:, :, 6:]
        for how, x in (("view", b), ("contiguous", b.contiguous())):
            _k1_equal(torch, x, codec, f"flagship {what} {how}")
            held.append(f"flagship 8K {what} {how}")
    body = words.transpose(1, 2).contiguous()[:, :, 6:]
    run = lambda: dec_cuda.check_decode(body, dl)
    bound, bound_by, _moved = k1_bound(dl, body.shape[0])
    grid_k1 = {"n_sf": body.shape[0], "plan": dec_cuda.plan(body, dl),
               "ms": cuda_ms(torch, run, 20),
               "device_ms": graph_ms(torch, run, 20), "bound_ms": bound,
               "bound_by": bound_by, "plain_grid_check_ms":
               times["flagship warm"]["grid check (device, CUDA events)"]}
    del words, dirty, body
    grid_k1["held"] = held + hold_grid_k1(torch, dev)

    # --- P2 with the beacon and P5 without one, 64 superframes ------------
    for name in ("p2_beacon", "p5"):
        c = cfgs[name]
        n = SMALL_SF * c.superframe_words

        def small(c=c, n=n, name=name):
            w = port.encode_stream_superframes(raw[:n], c, sf_batch=SF_BATCH)
            r = {"fused clean": exact(c, w, "fused", f"{name} fused", n),
                 "fused dirty": exact(c, damaged(torch, w), "fused",
                                      f"{name} fused, damaged", n)}
            return r
        times[name] = counted(name, small)

    # --- the non-residue UEP layout on one 8K frame: K1 -------------------
    c = cfgs["uep_nonresidue"]
    nr = codec_for(c, dev)
    require(pipeline.check_route(nr.dlayout) == "k1",
            "non-residue UEP layout: check route is not K1")

    def nonresidue():
        r = {}
        r["encode"], w = wall_ms(torch, lambda: port.encode_stream_superframes(
            raw, c, sf_batch=SF_BATCH))
        r["check clean"] = exact(c, w, "check", "non-residue check")
        r["fused dirty"] = exact(c, damaged(torch, w), "fused",
                                 "non-residue fused, damaged")
        return r, w
    times["uep_nonresidue"], w = counted("uep_nonresidue", nonresidue)
    body = w.transpose(1, 2).contiguous()[:, :, 6:]
    del w

    for name, n in legs.items():
        require(n["check_decode"] > 0, f"{name}: K1 never launched")
        require(n["rs_correct"] > 0, f"{name}: K2 never launched")
    require(len(k1_in) == sum(n["check_decode"] for n in legs.values())
            and len(k2_in) == sum(n["rs_correct"] for n in legs.values()),
            f"launches {legs} but {len(k1_in)} K1 and {len(k2_in)} K2 "
            "inputs kept")

    # every kernel input of the phase against the kernel's twin
    shapes = {"check_decode": {}, "rs_correct": {}}
    codecs = {name: codec_for(c, dev) for name, c in cfgs.items()}
    for b, layout in k1_in:
        name = next((k for k, cod in codecs.items() if cod.dlayout is layout),
                    None)
        require(name is not None, "K1 ran on another layout")
        _k1_equal(torch, b, codecs[name], f"{name} n_sf={b.shape[0]}")
        key = f"{name} n_sf={b.shape[0]}"
        shapes["check_decode"][key] = shapes["check_decode"].get(key, 0) + 1
    for recv, k in k2_in:
        got, got_ok = rs_cuda.rs_correct(recv, k)
        want, want_ok = rs.correct_pm_ref(recv, k)
        require(torch.equal(got, want) and torch.equal(got_ok, want_ok),
                f"K2 on phase 8's k={k} B={recv.shape[-1]} input: differs "
                "from plain")
        key = f"k={k} B={recv.shape[-1]}"
        shapes["rs_correct"][key] = shapes["rs_correct"].get(key, 0) + 1
    del k1_in, k2_in

    # K1 on the non-residue frame, against its bound
    run = lambda: dec_cuda.check_decode(body, nr.dlayout)
    bound, bound_by, _moved = k1_bound(nr.dlayout, body.shape[0])
    k1 = {"n_sf": body.shape[0], "ms": cuda_ms(torch, run, 10),
          "device_ms": graph_ms(torch, run, 10),
          "plain_ms": cuda_ms(torch, lambda: dec_cuda.check_decode_ref(
              body, nr.tables()), 1),
          "bound_ms": bound, "bound_by": bound_by}
    del body
    print(f"[8 layouts off the main path, one 8K frame: {n_raw} RAW words] "
          f"flagship (P5 26x26, luma UEP, beacon {p} in band {b0}, check "
          f"route grid): encode; check, auto, fused exact clean and under "
          f"the D=20 E=8 hdr=25% damage; full clean and damaged, none; "
          f"overcap flagged; damaged beacon cells read as clean; 5 dirty "
          f"beacon pages in one superframe flagged, 4 in the next repaired, "
          f"equal to the CPU path; pixel e2e exact.  P2 + beacon and P5 "
          f"26x26 at {SMALL_SF} superframes: fused exact clean and damaged.  "
          f"UEP {NONRESIDUE_UEP}: check and fused exact, K1 bit-equal to "
          f"plain.  Launches by leg {legs}; every kernel input bit-equal to "
          f"plain (inputs by shape: {shapes}); K1's grid route bit-equal to "
          f"the plain grid check on {grid_k1['held']}; peak device memory "
          f"above the frame's words (bytes): {peaks}", flush=True)
    del grid_k1["held"]
    k1["grid_route"] = grid_k1
    print(f"[8 layout times] ms/frame (first pass, then warm): "
          f"{json.dumps(times)}; K1 on the non-residue frame and on the "
          f"flagship frame (grid route): {k1}", flush=True)
    return legs, k1, times


# --- phase 9: the transform prototypes and the CLI tools --------------------

PROTO_SIZES = ((W8K, H8K), (1920, 1080))   # 1080 rows take the 32-row pad
PROTO_REPS = 5
SKETCH_TOL = 2         # of the sketch's 64 trits (float32 on both sides)


def proto_image(torch, dev, w, h):
    """(h, w, 3) uint8 RGB on ``dev``: at 8K the pixels of ``rgb_frame``
    in raster order, at other sizes seed-0 uniform bytes."""
    if (w, h) == (W8K, H8K):
        return rgb_frame(torch, dev).permute(2, 1, 0).reshape(h, w, 3) \
            .contiguous()
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, size=(h, w, 3), dtype=np.uint8), device=dev)


def proto_stages(rgb, device):
    """The prototype calls on one frame, each as a call: Haar tiles, their
    reconstruction, the spectral sketch, AnisoRC encode and its
    reconstruction (ops/proto.py defaults).  Returns (stage calls by name,
    their outputs by name)."""
    from ternary_image_codec_tpu_torch.ops import proto as P
    pp, rp = P.ProtoParams(), P.AnisoRCParams()
    out = {}
    ll, trits, tx, ty = out["haar tiles"] = P.proto_tile_haar_ternary(
        rgb, pp, device)
    art = out["aniso_rc encode"] = P.proto_aniso_rc_encode(rgb, rp, device)
    calls = {
        "haar tiles": lambda: P.proto_tile_haar_ternary(rgb, pp, device),
        "haar recon": lambda: P.proto_reconstruct_y_from_tiles(
            ll, trits, tx, ty, pp, device),
        "sketch": lambda: P.proto_spectral_sketch(rgb, pp, device),
        "aniso_rc encode": lambda: P.proto_aniso_rc_encode(rgb, rp, device),
        "aniso_rc recon": lambda: P.proto_aniso_rc_reconstruct(art, rp,
                                                               device=device)}
    for name in ("haar recon", "sketch", "aniso_rc recon"):
        out[name] = calls[name]()
    return calls, out


def proto_equal(torch, got, want, what):
    """Prototype outputs on two devices: every integer output bit-equal
    (Haar LL, trits and tile counts, both reconstructions, every field of
    AnisoRCArtifacts), the sketch within SKETCH_TOL trits.  Returns the
    sketch's differing trits."""
    import dataclasses

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return isinstance(b, torch.Tensor) and torch.equal(a.cpu(),
                                                               b.cpu())
        return a == b
    for i, name in enumerate(("LL", "trits", "tiles_x", "tiles_y")):
        require(same(got["haar tiles"][i], want["haar tiles"][i]),
                f"{what}: Haar {name} differs")
    for stage in ("haar recon", "aniso_rc recon"):
        require(same(got[stage], want[stage]), f"{what}: {stage} differs")
    for f in dataclasses.fields(got["aniso_rc encode"]):
        require(same(getattr(got["aniso_rc encode"], f.name),
                     getattr(want["aniso_rc encode"], f.name)),
                f"{what}: AnisoRC {f.name} differs")
    diff = int((got["sketch"].cpu() != want["sketch"].cpu()).sum())
    require(got["sketch"].numel() == 64 and diff <= SKETCH_TOL,
            f"{what}: sketch differs in {diff} of 64 trits")
    return diff


def proto_bound_ms(name, w, h, out):
    """The least time of a stage: its input read once and its output
    written once, over the HBM rate (every stage here is a few integer or
    float operations a byte, far under the ALUs' rate)."""
    n_px = w * h
    tiles = n_px // 64                       # 8x8 Haar tiles
    rc = out["aniso_rc encode"]
    rc_out = rc.trits.numel() + rc.blocks_x * rc.blocks_y
    moved = {"haar tiles": 3 * n_px + tiles * 49,
             "haar recon": tiles * 49 + n_px,
             "sketch": 3 * 256 * 256 + 64,    # the 256x256 NN samples
             "aniso_rc encode": 3 * n_px + rc_out,
             "aniso_rc recon": rc_out + rc.W * rc.H}[name]
    return moved / HBM_BPS * 1e3


def proto_files(torch, rgb, dev, want_rgb, d):
    """Both prototype profiles through ``profiles.encode_prototype_ternary``
    on ``dev``, each written as a .t3proto in ``d`` and read back; the
    trits, packed bytes and meta JSON equal to the run on ``want_rgb``'s
    device (Haar's sketch part within SKETCH_TOL).  Returns ({profile:
    path}, {profile: host ms})."""
    import os
    from ternary_image_codec_tpu_torch import profiles as PR
    from ternary_image_codec_tpu_torch.io import legacy_containers as LC
    paths, ms = {}, {}
    h, w = rgb.shape[:2]
    for prof in (LC.ProtoProfile.HAAR_TERNARY, LC.ProtoProfile.ANISO_RC):
        cfg = PR.ProtoConfig(profile=prof)
        t0 = time.perf_counter()
        bal, packed, meta = PR.encode_prototype_ternary(rgb, cfg, dev)
        ms[prof.name] = (time.perf_counter() - t0) * 1e3
        path = paths[prof.name] = os.path.join(d, f"{prof.name.lower()}.t3proto")
        LC.t3proto_write(path, prof, w, h, bal, packed, meta)
        got = LC.t3proto_read(path)
        require(got[:3] == (prof, w, h) and got[5] == meta
                and np.array_equal(got[3], bal)
                and np.array_equal(got[4], packed),
                f"{prof.name}: .t3proto read back differs from what was "
                "written")
        wbal, wpacked, wmeta = PR.encode_prototype_ternary(
            want_rgb, cfg, want_rgb.device)
        require(meta == wmeta, f"{prof.name}: meta JSON differs")
        head = bal.size - json.loads(meta)["layout"].get("len_sketch", 0)
        require(bal.size == wbal.size
                and np.array_equal(bal[:head], wbal[:head])
                and (bal[head:] != wbal[head:]).sum() <= SKETCH_TOL,
                f"{prof.name}: balanced trits differ")
        require(np.array_equal(packed, PR.pack_base243_from_balanced(bal))
                and (not np.array_equal(bal, wbal)
                     or np.array_equal(packed, wpacked)),
                f"{prof.name}: packed bytes differ")
    return paths, ms


def run_tool(mod, argv, **kw):
    """A CLI tool's ``main(argv, **kw)`` with its standard output captured:
    (exit code, output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv, **kw)
    return rc, buf.getvalue()


def tool_legs(torch, dev, d, proto_path, png, counted):
    """The port's CLI tools on ``dev`` in directory ``d``, each run through
    ``counted(leg, call)``: main_bare (self-tests OK, its demo files equal
    to a run on the CPU), minitest_trits, minitest_codec, t3proto_tool info,
    repack (packed, then balanced under --strict: the trits come back) and
    cat on ``proto_path``; with a PNG (``png``, needs PIL): t3proto_tool
    encode, main (its roundtrip PNG equal to the quantization round trip of
    the image) and minitest_aniso_rc.  Returns {leg: summary}."""
    import os
    from ternary_image_codec_tpu_torch.cli import (main, main_bare,
                                                   minitest_aniso_rc,
                                                   minitest_codec,
                                                   minitest_trits,
                                                   t3proto_tool)
    from ternary_image_codec_tpu_torch.io import legacy_containers as LC
    dv = ["--device", str(dev)]
    p = lambda *names: os.path.join(d, *names)
    res = {}

    rc, out = counted("main_bare", lambda: run_tool(
        main_bare, ["--outdir", p("bare")] + dv))
    require(rc == 0 and "RS unit: OK" in out and "API roundtrip: OK" in out,
            f"main_bare on {dev}: {out!r}")
    rc_cpu, _ = run_tool(main_bare, ["--outdir", p("bare_cpu"),
                                     "--device", "cpu"])
    for name in ("demo_s21.t3v", "demo_s21.t3p"):
        with open(p("bare", name), "rb") as a, open(p("bare_cpu", name),
                                                   "rb") as b:
            require(rc_cpu == 0 and a.read() == b.read(),
                    f"main_bare: {name} differs from the CPU run's")
    res["main_bare"] = "RS unit OK, API roundtrip OK, demo files = CPU's"

    for leg, mod in (("minitest_trits", minitest_trits),
                     ("minitest_codec", minitest_codec)):
        rc, out = counted(leg, lambda mod=mod: run_tool(mod, dv))
        status = json.loads(out)["report"]["final_status"]
        require(rc == 0 and status == "PASS", f"{leg}: {status}")
        res[leg] = status

    def t3t(*argv):
        rc, out = run_tool(t3proto_tool, list(argv) + dv)
        require(rc == 0, f"t3proto_tool {argv}: exit {rc}")
        return out

    def t3proto_leg():
        info = json.loads(t3t("info", proto_path, "--json"))["t3proto"]
        _, _, _, bal, packed, _ = LC.t3proto_read(proto_path)
        require(info["trits"] == bal.size and info["bytes"] == packed.size,
                f"t3proto_tool info: {info}")
        t3t("repack", proto_path, "--to", "packed", "--out", p("pk.t3proto"))
        t3t("repack", p("pk.t3proto"), "--to", "balanced", "--strict",
            "--out", p("bal.t3proto"))
        back = LC.t3proto_read(p("bal.t3proto"))[3]
        require(np.array_equal(back, bal),
                "t3proto_tool repack: the trits did not come back")
        t3t("cat", "--out", p("cat.t3proto"), proto_path, proto_path)
        cat = LC.t3proto_read(p("cat.t3proto"))
        require(cat[3].size == 2 * bal.size and cat[4].size == 2 * packed.size,
                "t3proto_tool cat: wrong sizes")
        if png is not None:
            t3t("encode", "--in", png, "--out", p("enc.t3proto"),
                "--profile", "rc")
            require(LC.t3proto_read(p("enc.t3proto"))[3].size > 0,
                    "t3proto_tool encode wrote no trits")
        return f"info, repack, cat on {info['trits']} trits" + (
            ", encode" if png is not None else "")
    res["t3proto_tool"] = counted("t3proto_tool", t3proto_leg)
    if png is None:
        return res

    from ternary_image_codec_tpu_torch.io import image as I
    from ternary_image_codec_tpu_torch.ops import quant as Q
    rc, out = counted("main", lambda: run_tool(
        main, [png, p("main.t3v"), "--roundtrip-png", p("rt.png")] + dv))
    rgb = torch.as_tensor(I.load_image_rgb8(png))
    want = Q.quant_to_rgb(Q.rgb_to_quant(rgb))
    require(rc == 0 and np.array_equal(I.load_image_rgb8(p("rt.png")),
                                       want.numpy()),
            f"main: {out!r}, or its roundtrip PNG is not the quantization "
            "round trip of the image")
    res["main"] = "roundtrip PNG = quantization round trip"
    rc, out = counted("minitest_aniso_rc", lambda: run_tool(
        minitest_aniso_rc, ["--in", png, "--png", p("rc.png"), "--json"] + dv))
    rep = json.loads(out)["aniso_rc"]
    h, w = rgb.shape[:2]
    require(rc == 0 and (rep["W"], rep["H"]) == (-(-w // 32) * 32,
                                                 -(-h // 32) * 32)
            and np.isfinite(rep["psnrY"]), f"minitest_aniso_rc: {rep}")
    res["minitest_aniso_rc"] = f"PSNR-Y {rep['psnrY']} dB, {rep['bpp']} bpp"
    return res


def phase_protos(torch, dev):
    """The transform prototypes and the CLI tools on the card: the five
    prototype stages on one 8K frame and one 1920x1080 frame, equal to the
    port's CPU path on the same input (integer outputs bit-equal, the
    sketch within SKETCH_TOL of 64), timed warm by CUDA events with their
    peak device memory; both prototype profiles at 8K through
    ``profiles.encode_prototype_ternary`` into .t3proto files and back,
    equal to the CPU run; the CLI tools (``tool_legs``) with K1 and K2
    launches read per leg, every K1 and K2 input of the tools kept and held
    bit-equal to the kernel's twin.  Returns (launches by leg, times)."""
    import importlib.util
    import os
    import shutil
    import tempfile
    from ternary_image_codec_tpu_torch.io import image as I
    has_pil = importlib.util.find_spec("PIL") is not None
    has_ffmpeg = shutil.which("ffmpeg") is not None
    print(json.dumps({"pil": has_pil, "ffmpeg": has_ffmpeg}), flush=True)

    times, peaks, sketch_diff = {}, {}, {}
    with tempfile.TemporaryDirectory() as d:
        png = None
        for w, h in PROTO_SIZES:
            key = f"{w}x{h}"
            rgb = proto_image(torch, dev, w, h)
            calls, got = proto_stages(rgb, dev)
            _, want = proto_stages(rgb.cpu(), "cpu")
            sketch_diff[key] = proto_equal(torch, got, want, key)
            t, pk = {}, {}
            for name, fn in calls.items():
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                wall = wall_ms(torch, fn)[0]
                pk[name] = torch.cuda.max_memory_allocated(dev) - base
                t[name] = {"ms": cuda_ms(torch, fn, PROTO_REPS),
                           "host_ms": wall,
                           "bound_ms": proto_bound_ms(name, w, h, got)}
            times[key], peaks[key] = t, pk
            if (w, h) == (W8K, H8K):
                paths, times["t3proto 8K host ms"] = proto_files(
                    torch, rgb, dev, rgb.cpu(), d)
            elif has_pil:
                png = os.path.join(d, f"frame_{key}.png")
                I.save_image_png(png, rgb)
            del calls, got, want, rgb

        legs, k1_in, k2_in = {}, [], []

        def counted(leg, fn):
            before = launch_counts()
            t0 = time.perf_counter()
            with kept_inputs(k1_in, k2_in):
                out = fn()
            legs[leg] = {**launches_since(before),
                         "s": time.perf_counter() - t0}
            return out
        tools = tool_legs(torch, dev, d, paths["HAAR_TERNARY"], png, counted)

    n = {leg: {k: v for k, v in c.items() if k != "s"}
         for leg, c in legs.items()}
    # the profile decode is the paged corrector (header chain and repair
    # on K2); no tool runs a check decode, so K1 is counted, not required
    require(n["main_bare"]["rs_correct"] > 0,
            f"main_bare did not launch K2: {n['main_bare']}")
    require(n["minitest_trits"]["rs_correct"] > 0,
            "minitest_trits' RS self-test did not launch K2")
    if "main" in n:
        require(n["main"]["rs_correct"] > 0,
                f"main did not launch K2: {n['main']}")
    require(len(k1_in) == sum(c["check_decode"] for c in n.values())
            and len(k2_in) == sum(c["rs_correct"] for c in n.values()),
            f"launches {n} but {len(k1_in)} K1 and {len(k2_in)} K2 inputs kept")
    hold_kept(torch, dev, k1_in, k2_in, "phase 9")
    print(f"[9 prototypes and tools] {' and '.join(times)} frames: Haar "
          f"tiles, recon, AnisoRC encode, recon bit-equal to the CPU path, "
          f"sketch trits differing {sketch_diff} of 64; both profiles at 8K "
          f"through .t3proto files equal to the CPU run; tools {tools}; "
          f"launches by leg {legs}; every kernel input bit-equal to plain "
          f"({len(k1_in)} K1, {len(k2_in)} K2)", flush=True)
    print(f"[9 prototype times] ms by CUDA events over {PROTO_REPS} warm "
          f"calls, host ms of one warm call, the memory bound: "
          f"{json.dumps(times)}; peak device memory above the frame (bytes): "
          f"{json.dumps(peaks)}", flush=True)
    return n, times


# --- phase 10: multi-device -------------------------------------------------

MESH_TIMEOUT_S = 420   # each spawn's limit, and its process group's
MESH_REPS = 3          # timed calls a leg (the least is kept)
MESH_8K = {"n": W8K * H8K // 2, "sfw": 8192, "frame": 1920 * 1080 // 2,
           "pp": (5, 405)}  # 2,025 superframes as 5 microbatches of 405
# PP with two data ranks a stage: 2,024 superframes as 4 microbatches of 506
MESH_8K_PP4 = dict(MESH_8K, pp=(4, 506))
MESH_1RANK_LEGS = ["superframe_dp", "fused_dp", "frame_dp"]
# frame-DP's extra error in frame i: band 0 (k=20), block FRAME_ERR_BLOCK + i
FRAME_ERR_BLOCK = 100
# beyond the paged corrector's capacity in one PP frame: one error in each
# of PP_OVER_PAGES 16-block pages of band 1 (its k=22 group repairs 6)
PP_OVER_PAGES = 7


def mesh_cfg(port, sizes):
    return port.EncoderConfig(profile=port.ProfileID.P2_RS26_22,
                              uep=port.uep_luma_priority(),
                              superframe_words=sizes["sfw"])


def mesh_raw(torch, dev, n, seed):
    """n RAW words (n, 9) int8 made on ``dev`` from ``seed`` (symbol 8
    holds trits 24..26, trit 26 zero): the same words on every rank of one
    device type."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(0, 27, (n, 9), generator=g, device=dev)
    w[:, 8] %= 9
    return w.to(torch.int8)


def digest(x):
    import hashlib
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def mesh_ms(torch, mesh, fn, reps=MESH_REPS):
    """The least time of ``reps`` calls of ``fn``, each started on every
    rank together (a barrier) and timed by CUDA events around synchronised
    calls (by the host clock on the CPU, for rehearsals only)."""
    import torch.distributed as dist
    cuda = mesh.device.type == "cuda"
    best = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(mesh.device)
            best.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best.append((time.perf_counter() - t0) * 1e3)
    return min(best)


def leg_superframe_dp(torch, mesh, sizes):
    """``roundtrip_superframes_dp`` of the frame: exact, ok, equal to the
    single-device ``roundtrip_stream(rs_mode="paged")``."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.parallel import mesh as M
    cfg, n, sfw = mesh_cfg(port, sizes), sizes["n"], sizes["sfw"]
    raw = mesh_raw(torch, mesh.device, n, 0)

    def call():
        return M.roundtrip_superframes_dp(raw, cfg, mesh, sf_batch=SF_BATCH)

    def run():
        rows, ok = call()
        return M.gather(mesh, rows)[:n], bool(ok)

    def single():
        return port.roundtrip_stream(raw.view(-1, sfw, 9), cfg,
                                     sf_batch=SF_BATCH, rs_mode="paged",
                                     device=mesh.device)

    def check(out):
        got, ok = out
        require(ok and torch.equal(got, raw),
                "superframe-DP round trip: not exact")
        if mesh.rank == 0:
            planes, ok1 = single()
            require(bool(ok1.all()) and torch.equal(
                planes[:, :, :sfw].transpose(1, 2).reshape(-1, 9), got),
                "superframe-DP differs from the single-device roundtrip")
        return {"digest": digest(got)}
    timed = {"superframe_dp": call}
    if mesh.size == 1:
        timed["single-device roundtrip_stream paged"] = single
    return run, check, timed


def leg_fused_dp(torch, mesh, sizes):
    """``decode_superframes_fused_dp`` of the frame under ``bench_damage``
    (header cells too) at ``REPAIR_CAP``: exact, ok, equal to the
    single-device fused decode; the superframes with damaged header cells
    are flagged by the check and end ok (the header chain repaired them);
    an overcap copy fails safe."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.ops import gf27
    from ternary_image_codec_tpu_torch.parallel import mesh as M
    cfg, n, sfw = mesh_cfg(port, sizes), sizes["n"], sizes["sfw"]
    dev = mesh.device
    raw = mesh_raw(torch, dev, n, 0)
    # the frame's superframes, padded with encoded zero superframes to a
    # multiple of the mesh size, the damage on the frame's own
    n_sf = -(-n // sfw)
    pad = -(-n_sf // mesh.size) * mesh.size * sfw - n
    words = port.encode_stream_superframes(
        torch.nn.functional.pad(raw, (0, 0, 0, pad)), cfg,
        sf_batch=SF_BATCH, device=dev)
    total_w = words.shape[1]
    si_sf, (si, _bi, pi, _dlt) = bench_damage(n_sf, total_w)
    hdr_sf = np.unique(si[pi < 6])
    dirty = torch.cat([damaged(torch, words[:n_sf]), words[n_sf:]])
    del words
    # overcap: 3 errors in one k=22 codeword (band 1, block 2) of 2 clean
    # superframes, as phase 5
    over = dirty.clone()
    for sf in np.setdiff1d(np.arange(n_sf), si_sf)[:2]:
        rows = 6 + 2 * 26 + torch.arange(3, device=dev)
        e = torch.tensor([1, 1, 2], dtype=torch.int8, device=dev)
        over[int(sf), rows, 1] = gf27.dig_to_sym(gf27.mod3(
            gf27.sym_to_dig(over[int(sf), rows, 1]).to(torch.int16)
            + gf27.sym_to_dig(e)))

    def call(words):
        return M.decode_superframes_fused_dp(words, cfg, mesh,
                                             repair_cap=REPAIR_CAP)

    def run():
        fix, ok = call(dirty)
        got = M.gather(mesh, fix)[:, :sfw].reshape(-1, 9)[:n]
        return got, bool(ok), bool(call(over)[1])

    def single():
        return port.decode_stream_superframes(
            dirty, cfg, n, sf_batch=SF_BATCH, strategy="fused",
            repair_cap=REPAIR_CAP, device=dev)

    def check(out):
        got, ok, ok_over = out
        require(ok and torch.equal(got, raw),
                "fused superframe-DP decode under bench_damage: not exact")
        require(not ok_over, "fused superframe-DP overcap copy: ok is True")
        codec = codec_for(cfg, dev)
        hdr_T = dirty[torch.as_tensor(hdr_sf, device=dev)].transpose(1, 2)
        require(not bool(codec.check(hdr_T.contiguous())[1].any()),
                "damaged header cells not flagged by the check")
        if mesh.rank == 0:
            want, ok1 = single()
            require(bool(ok1) and torch.equal(want, got),
                    "fused superframe-DP differs from the single-device "
                    "fused decode")
        return {"digest": digest(got), "header_superframes_repaired":
                len(hdr_sf), "flagged": len(si_sf)}
    timed = {"fused_dp dirty": lambda: call(dirty)}
    if mesh.size == 1:
        timed["single-device fused dirty"] = single
    return run, check, timed


def leg_frame_dp(torch, mesh, sizes):
    """Frame-DP on 2 frames a rank of ``sizes["frame"]`` RAW words (one
    profile each): ``roundtrip_step_dp`` exact; ``decode_frames_dp`` of the
    encoded frames with injected symbol errors repaired exactly;
    ``encode_stream_sharded`` of frame 0 equal to the single-device
    ``encode_profile_from_raw``."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.parallel import mesh as M
    cfg, n1, dev = mesh_cfg(port, sizes), sizes["frame"], mesh.device
    B = 2 * mesh.size
    frames = torch.stack([mesh_raw(torch, dev, n1, 100 + i)
                          for i in range(B)])

    def run():
        out, ok = M.roundtrip_step_dp(frames, cfg, mesh)
        got = M.gather(mesh, out)[:, :n1]
        words = M.gather(mesh, M.encode_frames_dp(frames, cfg, mesh))
        hw = 6
        for row, band, d in ((hw + 7, 4, 1), (hw + 20, 1, 2)):
            words[:, row, band] = (words[:, row, band] + d) % 27
        for i in range(B):
            row = hw + 26 * (FRAME_ERR_BLOCK + i) + 3
            words[i, row, 0] = (words[i, row, 0] + 5) % 27
        fix, ok_f, all_ok = M.decode_frames_dp(words, cfg, mesh)
        fix = M.gather(mesh, fix)[:, :n1]
        ok_f = M.gather(mesh, ok_f)
        prof = M.gather(mesh, M.encode_stream_sharded(frames[0], cfg, mesh))
        return got, bool(ok), fix, bool(ok_f.all()), bool(all_ok), prof

    def check(out):
        got, ok, fix, ok_f, all_ok, prof = out
        require(ok and torch.equal(got, frames),
                "frame-DP round trip: not exact")
        require(ok_f and all_ok and torch.equal(fix, frames),
                "frame-DP repair of injected errors: not exact")
        want = port.encode_profile_from_raw(frames[0], cfg, device=dev)
        require(torch.equal(prof, want),
                "stream-sharded encode differs from the single-device one")
        # frames 0 and 1 are the same at every rank count
        return {"digest": digest(got[:2]) + digest(fix[:2]) + digest(prof)}
    return run, check, {}


def leg_pp(torch, mesh, sizes):
    """``roundtrip_pipeline_pp`` of the frame's first T x db superframes
    as frames of ``sfw`` words (T microbatches of db): clean; with <= t errors a codeword
    on the link in 3 frames (exact, every frame ok); with errors in more
    16-block pages than the paged corrector repairs in one frame (exactly
    that frame flagged, every other frame exact)."""
    import ternary_image_codec_tpu_torch as port
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.parallel import mesh as M
    cfg, n, sfw = mesh_cfg(port, sizes), sizes["n"], sizes["sfw"]
    T, db = sizes["pp"]
    dev = mesh.device
    frames = mesh_raw(torch, dev, n, 0)[:T * db * sfw].view(T, db, sfw, 9)
    total = codec_for(cfg, dev, sfw).layout.total_words
    fix_dmg = torch.zeros((T, db, total, 9), dtype=torch.int8, device=dev)
    for t, f, band, blk in ((0, 0, 1, 5), (T // 2, db // 2, 4, 8),
                            (T - 1, db - 1, 7, 3)):
        for c in (3, 17):                     # 2 errors, k=22 has t=2
            fix_dmg[t, f, 6 + 26 * blk + c, band] = 5 + c
    bad = (1 % T, 7 % db)
    over_dmg = torch.zeros_like(fix_dmg)
    for p in range(PP_OVER_PAGES):
        over_dmg[bad[0], bad[1], 6 + 26 * 16 * p, 1] = 1

    def call(dmg=None):
        return M.roundtrip_pipeline_pp(frames, cfg, mesh, wire_damage=dmg)

    def run():
        res = []
        for dmg in (None, fix_dmg, over_dmg):
            out, ok = call(dmg)
            res.append((M.gather(mesh, out, dim=1, axis="data")[:, :, :sfw],
                        M.gather(mesh, ok, dim=1, axis="data")))
        return res

    def check(out):
        (clean, ok), (fixed, ok_fix), (over, ok_over) = out
        require(bool(ok.all()) and torch.equal(clean, frames),
                "PP round trip: not exact")
        require(bool(ok_fix.all()) and torch.equal(fixed, frames),
                "PP with correctable link damage: not exact")
        want = torch.ones_like(ok_over)
        want[bad] = False
        keep = want.clone()
        require(torch.equal(ok_over, want) and torch.equal(
            over[keep], frames[keep]),
            "PP beyond capacity: not exactly the damaged frame flagged")
        return {"digest": digest(clean)}
    return run, check, {"pp": call}


MESH_LEGS = {"superframe_dp": leg_superframe_dp, "fused_dp": leg_fused_dp,
             "frame_dp": leg_frame_dp, "pp": leg_pp}


def mesh_leg(torch, mesh, name, sizes):
    """One leg on this rank: its run with the launch counts read from it
    alone and every K1/K2 input kept, its checks, the kept inputs held to
    the twins, then its warm times.  Returns host data."""
    dev = mesh.device
    cuda = dev.type == "cuda"
    run, check, timed = MESH_LEGS[name](torch, mesh, sizes)
    k1_in, k2_in = [], []
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    before = launch_counts()
    with kept_inputs(k1_in, k2_in):
        out = run()
    launches = launches_since(before, [*K12, "superframe_encode"])
    res = check(out)
    del out
    res["s"] = time.perf_counter() - t0
    res["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) - base
                         if cuda else None)
    require(len(k1_in) == launches["check_decode"]
            and len(k2_in) == launches["rs_correct"],
            f"{name}: launches {launches} but {len(k1_in)} K1 and "
            f"{len(k2_in)} K2 inputs kept")
    hold_kept(torch, dev, k1_in, k2_in, name)
    del k1_in, k2_in
    res["ms"] = {key: mesh_ms(torch, mesh, fn) for key, fn in timed.items()}
    res["launches"] = launches
    return res


def mesh_rank(rank, world, legs, sizes=MESH_8K):
    """Phase 10's rank function: each leg of ``legs`` on a ``world``-rank
    mesh (``pp`` on the 2-stage mesh)."""
    import torch
    from ternary_image_codec_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(world)
    pp = M.make_mesh_pp(world) if "pp" in legs else None
    return {leg: mesh_leg(torch, pp if leg == "pp" else mesh, leg, sizes)
            for leg in legs}


def dryrun_rank(rank, world):
    """``dryrun_multichip``'s rank (parallel/dryrun.py) with its K1/K2
    launches read and every kernel input kept and held to the twin."""
    import torch
    from ternary_image_codec_tpu_torch.parallel import dryrun, launch
    k1_in, k2_in = [], []
    before = launch_counts()
    with kept_inputs(k1_in, k2_in):
        line = dryrun.dryrun_rank(rank, world)
    launches = launches_since(before)
    hold_kept(torch, launch.rank_device(), k1_in, k2_in, "dryrun")
    return {"summary": line, "launches": launches}


def _by_leg(runs, part, out):
    """Fold per-rank leg results into ``out[f"{part} {leg}"]`` = list of
    rank results."""
    for rank, res in enumerate(runs):
        for leg, r in res.items():
            out.setdefault(f"{part} {leg}", []).append(r)


def phase_mesh(torch, dev, smi_line):
    """Multi-device on the card through ``parallel/``: (a) one NCCL rank
    on ``dev``, (b) two gloo ranks sharing it (each launching K1/K2 there),
    (c) ``dryrun_multichip``'s legs on four gloo ranks sharing it, (d) NCCL
    with one rank a card where there are two or more, (e) ``channel_qa``
    on the card against its CPU run.  Launches are read per rank and leg,
    every kernel input a rank launches is held to the twin in that rank.
    Returns (launches by leg and rank, times)."""
    from ternary_image_codec_tpu_torch.cli import channel_qa
    from ternary_image_codec_tpu_torch.parallel import launch
    torch.cuda.empty_cache()           # the ranks share the card
    legs = {}
    t0 = time.perf_counter()
    # (a) and (b): the same legs, the same results
    one = launch.spawn(mesh_rank, 1, backend="nccl", device=dev,
                       args=(MESH_1RANK_LEGS,), timeout_s=MESH_TIMEOUT_S)
    _by_leg(one, "a nccl x1", legs)
    s_a = time.perf_counter() - t0
    print(f"[10a one NCCL rank, {smi_line}] {s_a:.1f} s: {json.dumps(one)}",
          flush=True)
    two = launch.spawn(mesh_rank, 2, backend="gloo", device=dev,
                       args=(MESH_1RANK_LEGS + ["pp"],),
                       timeout_s=MESH_TIMEOUT_S)
    _by_leg(two, "b gloo x2", legs)
    s_b = time.perf_counter() - s_a - t0
    print(f"[10b two gloo ranks on one card, {smi_line}] {s_b:.1f} s: "
          f"{json.dumps(two)}", flush=True)
    same_results(legs, "a nccl x1", "b gloo x2")
    # (c)
    four = launch.spawn(dryrun_rank, 4, backend="gloo", device=dev,
                        timeout_s=MESH_TIMEOUT_S)
    legs["c gloo x4 dryrun"] = four
    s_c = time.perf_counter() - s_b - s_a - t0
    # (d)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        legs.update(mesh_across_cards(torch, n_cards, legs))
        d_line = f"ran on {n_cards} cards, results equal to (a)"
    else:
        d_line = (f"not run: NCCL with more than one rank needs a card a "
                  f"rank, and {n_cards} card is visible")
    # (e)
    k2_in = []
    before = launch_counts()
    with kept_inputs([], k2_in):
        rc, out_card = run_tool(channel_qa, ["--device", "cuda", "--json"])
    qa_launches = (launch_counts() - before)["rs_correct"]
    rc_cpu, out_cpu = run_tool(channel_qa, ["--device", "cpu", "--json"])
    require(rc == rc_cpu == 0 and out_card == out_cpu,
            "channel_qa on the card differs from its CPU run")
    # one decode a (k, error count): 2t + 2 counts for t = 1..4
    require(qa_launches == len(k2_in) == sum(2 * t + 2 for t in (1, 2, 3, 4)),
            f"channel_qa launched K2 {qa_launches} times")
    hold_kept(torch, dev, [], k2_in, "channel_qa")
    legs["e channel_qa"] = [{"launches": {"check_decode": 0,
                                          "rs_correct": qa_launches}}]
    check_mesh_launches(legs)
    launches = {leg: [r["launches"] for r in rs_] for leg, rs_ in legs.items()}
    times = {leg: [{k: v for k, v in r.items() if k in ("ms", "s",
                                                          "peak_bytes")}
                   for r in rs_] for leg, rs_ in legs.items()
             if "ms" in rs_[0]}
    print(f"[10 multi-device] (a) one NCCL rank on {dev}: 8K superframe-DP "
          f"round trip and fused-DP decode under bench_damage (header cells "
          f"repaired, overcap flagged) exact and equal to the single-device "
          f"calls, 1080p frame-DP round trip, repair and stream sharding "
          f"exact ({s_a:.1f} s); (b) two gloo ranks sharing it: the same, "
          f"equal to (a), and the 2-stage PP of the 8K frame's superframes "
          f"clean, repaired and beyond capacity ({s_b:.1f} s); (c) "
          f"{four[0]['summary']} (four gloo ranks on {dev}, {s_c:.1f} s); "
          f"(d) {d_line}; (e) channel_qa --device cuda --json equal to its "
          f"CPU run, K2 {qa_launches} launches; launches by leg and rank "
          f"{json.dumps(launches)}; every kernel input bit-equal to plain",
          flush=True)
    print(f"[10 mesh times] {smi_line}: ms per 8K frame by CUDA events "
          f"around synchronised calls (least of {MESH_REPS}), per rank; two "
          f"ranks share one card here, so they are not expected to be "
          f"faster; host s of each leg's checked run (tables included), peak "
          f"device memory above the leg's inputs per rank (bytes): "
          f"{json.dumps(times)}", flush=True)
    return launches, times


def same_results(legs, part, other):
    """Every leg both parts ran gave the same result digest."""
    for key, runs in legs.items():
        if key.startswith(other + " ") and not key.endswith(" pp"):
            leg = key[len(other) + 1:]
            ds = {r["digest"] for r in legs[f"{part} {leg}"] + runs}
            require(len(ds) == 1, f"{leg}: {other} differs from {part} "
                    f"({ds})")


def mesh_across_cards(torch, n_cards, legs):
    """(d): NCCL with one rank a card on ``n_cards`` cards, the legs of
    one NCCL rank (``legs`` holds their results) and, with an even count,
    PP (two data ranks a stage when there are four cards: 2,024 of the
    frame's superframes); the results equal to one rank's.  Returns the
    new legs."""
    from ternary_image_codec_tpu_torch.parallel import launch
    many = launch.spawn(
        mesh_rank, n_cards, backend="nccl",
        args=(MESH_1RANK_LEGS + (["pp"] if n_cards % 2 == 0 else []),
              MESH_8K if n_cards == 2 else MESH_8K_PP4),
        timeout_s=MESH_TIMEOUT_S)
    out = {}
    _by_leg(many, f"d nccl x{n_cards}", out)
    same_results({**legs, **out}, "a nccl x1", f"d nccl x{n_cards}")
    print(f"[10d NCCL, one rank a card on {n_cards} cards] "
          f"{json.dumps(many)}", flush=True)
    return out


def phase_mesh_cards(torch, dev, smi_line):
    """(a) and (d) of phase 10 alone, for a machine with several cards:
    one NCCL rank, then one NCCL rank a card, the results equal."""
    from ternary_image_codec_tpu_torch.parallel import launch
    torch.cuda.empty_cache()
    legs = {}
    _by_leg(launch.spawn(mesh_rank, 1, backend="nccl", device=dev,
                         args=(MESH_1RANK_LEGS,), timeout_s=MESH_TIMEOUT_S),
            "a nccl x1", legs)
    n_cards = torch.cuda.device_count()
    require(n_cards >= 2, f"{n_cards} card visible: nothing to compare")
    legs.update(mesh_across_cards(torch, n_cards, legs))
    check_mesh_launches(legs)
    print(f"[10 a, d, {smi_line}] {json.dumps(legs)}", flush=True)


def check_mesh_launches(legs):
    """K1 only where a check decode runs (the fused DP decode's first
    phase; the dry run's fused legs), K2 in every paged decode: per rank."""
    for leg, runs in legs.items():
        for rank, r in enumerate(runs):
            n = r["launches"]
            k1, k2 = n["check_decode"], n["rs_correct"]
            what = f"{leg} rank {rank}: launches {n}"
            if leg.endswith("pp") and rank < len(runs) // 2:
                require(k1 == k2 == 0, f"{what} (stage 0 only encodes)")
            elif leg.endswith(("fused_dp", "dryrun")):
                require(k1 > 0 and k2 > 0, what)
            else:
                require(k1 == 0 and k2 > 0, what)



# --- phase 11: the benchmark entry points ------------------------------------

BENCH_TOOLS = ("headline", "rs_bench", "full_mode_bench", "serve_bench")
# the legs whose runs must launch each kernel
BENCH_K1_LEGS = {"headline": ("clean", "e2e", "dirty"),
                 "serve_bench": ("read",)}
BENCH_K2_LEGS = {"headline": ("dirty",),
                 "rs_bench": ("k24", "k22", "k20", "k18"),
                 "full_mode_bench": ("clean", "dirty")}


def bench_keep(torch, dev, held):
    """``keep(leg)`` for the bench tools: inside the block every K1 and K2
    input is kept (``kept_inputs``); on leaving it, each is held bit-equal
    to the kernel's twin (those launches are taken back off the counters)
    and ``held[leg]`` gets the counts."""
    from ternary_image_codec_tpu_torch.runtime import build

    @contextlib.contextmanager
    def keep(leg):
        k1_in, k2_in = [], []
        with kept_inputs(k1_in, k2_in):
            yield
        before = launch_counts()
        hold_kept(torch, dev, k1_in, k2_in, f"bench {leg}")
        build.launches.subtract(launches_since(before))
        held[leg] = {"check_decode": len(k1_in), "rs_correct": len(k2_in)}
    return keep


def phase_bench(torch, dev, smi_line):
    """The four benchmark entry points of ``bench/`` in-process on the card
    at their defaults, each with its launches read: every exactness check of the tools must pass
    (exit 0), K1 must launch in the headline's clean, e2e and dirty legs and
    in serve's read, K2 in the dirty leg, in every k of rs_bench and in both
    full-mode legs, the per-leg counts the tools print must add up to the
    counters, and every kernel input of the kept calls (the clean and e2e
    warm-up batches, the dirty leg's checked decode, each k's checked paged
    run, each full-mode leg's first decode, serve's read pass) is held
    bit-equal to the twin.  Prints each tool's JSON line.  Returns
    {tool: {leg: launches}}."""
    import importlib
    torch.cuda.empty_cache()
    out = {}
    for name in BENCH_TOOLS:
        tool = importlib.import_module(
            f"ternary_image_codec_tpu_torch.bench.{name}")
        held = {}
        t0 = time.perf_counter()
        before = launch_counts()
        rc, text = run_tool(tool, [], keep=bench_keep(torch, dev, held))
        launches = launches_since(before)
        require(rc == 0, f"bench {name}: exit {rc}")
        line = text.strip().splitlines()[-1]
        res = json.loads(line)
        legs = {leg: {"check_decode": res["k1_launches"][leg],
                      "rs_correct": res["k2_launches"][leg]}
                for leg in res["k1_launches"]}
        for kernel in launches:
            require(sum(n[kernel] for n in legs.values()) == launches[kernel],
                    f"bench {name}: per-leg {kernel} launches {legs} do not "
                    f"add up to the counter's {launches[kernel]}")
        for leg in BENCH_K1_LEGS.get(name, ()):
            require(legs[leg]["check_decode"] > 0,
                    f"bench {name} {leg}: K1 never launched ({legs})")
        for leg in BENCH_K2_LEGS.get(name, ()):
            require(legs[leg]["rs_correct"] > 0,
                    f"bench {name} {leg}: K2 never launched ({legs})")
        require(held, f"bench {name}: no kernel input was kept")
        out[name] = legs
        print(f"[11 bench {name}, {smi_line}] {time.perf_counter() - t0:.1f} "
              f"s, every check passed; launches by leg {json.dumps(legs)}; "
              f"kept inputs held bit-equal to the twins {json.dumps(held)}; "
              f"its JSON line:", flush=True)
        print(line, flush=True)
    return out


# --- phase 12: the single-device entry step -----------------------------------

ENTRY_BANDS = (0, 5, 4)    # a k=20 band, a k=22 band and the beacon band
ENTRY_BLOCKS = 3           # damaged codewords a band: within the paged capacity
ENTRY_BEACON_CELLS = 5
ENTRY_SEED = 12
ENTRY_REPS = 10            # warm steps timed


def entry_damage(torch, words, seed=ENTRY_SEED):
    """Copies (dirty, overcap) of the step's profile words (6 + H, 9) under
    a damage pattern fixed by ``seed``.  dirty: in each band of
    ``ENTRY_BANDS``, ``ENTRY_BLOCKS`` codewords with 1..t symbol errors
    each at distinct coefficients; one header cell; ``ENTRY_BEACON_CELLS``
    beacon cells (never read).  overcap: dirty and t+1 errors in one more
    codeword of band ``ENTRY_BANDS[0]``.  A t+1 pattern is miscorrected
    with some probability, so the pattern stays fixed by its seed."""
    from ternary_image_codec_tpu_torch.entry import CFG, N_RAW
    from ternary_image_codec_tpu_torch.ops import pipeline
    geom = pipeline.build_encode_layout(CFG, N_RAW).geom
    beacon, hw = CFG.beacon, pipeline.HEADER_WORDS
    rng = np.random.default_rng(seed)
    t = lambda band: (26 - geom.ks[band]) // 2
    p = beacon.words_period

    def hit(w, band, block, nerr):
        # P2 has no interleave: codeword c of a uniform band is rows 26c
        # to 26c + 25
        for pos in rng.choice(26, nerr, replace=False):
            j = 26 * block + int(pos)
            row = beacon_row(j, p) if band == beacon.band_slot else j
            _add_sym(torch, w, (hw + row, band), int(rng.integers(1, 27)))

    dirty, used = words.clone(), {}
    for band in ENTRY_BANDS:
        used[band] = rng.choice(geom.blocks[band], ENTRY_BLOCKS, replace=False)
        for block in used[band]:
            hit(dirty, band, int(block), int(rng.integers(1, t(band) + 1)))
    cell = int(rng.integers(pipeline.HEADER_SYMS))
    _add_sym(torch, dirty, divmod(cell, 9), int(rng.integers(1, 27)))
    for m in rng.choice(geom.H // p, ENTRY_BEACON_CELLS, replace=False):
        _add_sym(torch, dirty, (hw + int(m) * p, beacon.band_slot),
                 int(rng.integers(1, 27)))
    overcap, band = dirty.clone(), ENTRY_BANDS[0]
    block = next(int(b) for b in rng.permutation(geom.blocks[band])
                 if b not in used[band])
    hit(overcap, band, block, t(band) + 1)
    return dirty, overcap


def phase_entry(torch, dev, smi_line):
    """The single-device entry step (``entry.entry``) on the card: the
    build (host tables) by host clock, one cold and ``ENTRY_REPS`` warm
    steps by CUDA events and the step's peak device memory; its output
    bit-equal to the CPU step's on the same input and the same on a second
    call; ``decode_profile_to_raw`` on the card of it clean, under
    ``entry_damage`` (exact, ok True) and of the overcap copy (ok False).
    The launch counters are set to 0 before each leg and read after: K3
    once in the step, K2 and never K1 in each decode (the profile decode is
    the paged corrector, which runs no check); every K2 input of the decodes is held
    bit-equal to the twin.  Returns (launches by leg, times)."""
    from ternary_image_codec_tpu_torch import entry as E
    from ternary_image_codec_tpu_torch.ops import pipeline
    torch.cuda.empty_cache()
    legs, times, k1_in, k2_in = {}, {}, [], []
    counted = functools.partial(counted_leg, legs, k1_in, k2_in)
    t0 = time.perf_counter()
    fn, (raw,) = E.entry()
    torch.cuda.synchronize()
    times["build s"] = time.perf_counter() - t0
    require(raw.device == dev and raw.shape == (E.N_RAW, 9),
            f"entry: raw {tuple(raw.shape)} on {raw.device}")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    words = counted("step", lambda: fn(raw))
    end.record()
    torch.cuda.synchronize()
    times["cold ms"] = start.elapsed_time(end)
    times["peak bytes"] = torch.cuda.max_memory_allocated(dev) - base
    times["warm ms"] = cuda_ms(torch, lambda: fn(raw), ENTRY_REPS)
    require(words.device == dev and words.dtype == torch.int8
            and words.shape == (576868, 9),
            f"entry: step gave {words.dtype} {tuple(words.shape)} on "
            f"{words.device}")
    require(torch.equal(fn(raw), words), "entry: a second step differs")
    cpu_fn, _ = E.entry(device="cpu")
    require(torch.equal(words.cpu(), cpu_fn(raw.cpu())),
            "entry: the card's step differs from the CPU's")

    dirty, overcap = entry_damage(torch, words)
    for name, w, want_ok in (("clean", words, True), ("damaged", dirty, True),
                             ("overcap", overcap, False)):
        ms, (out, hdr, ok) = counted(name, lambda w=w: wall_ms(
            torch, lambda: pipeline.decode_profile_to_raw(w)))
        times[f"decode {name} ms"] = ms
        require(hdr is not None and pipeline.header_config(hdr) == E.CFG,
                f"entry decode {name}: header {hdr}")
        require(ok == want_ok, f"entry decode {name}: ok is {ok}")
        if want_ok:
            require(out.device == dev and torch.equal(out[:E.N_RAW], raw),
                    f"entry decode {name}: words differ")
    require(legs["step"] == {"check_decode": 0, "rs_correct": 0,
                             "superframe_encode": 1},
            f"entry step: launches {legs['step']}, K3 once expected")
    for name in ("clean", "damaged", "overcap"):
        require(legs[name]["check_decode"] == 0 and legs[name]["rs_correct"] > 0,
                f"entry decode {name}: launches {legs[name]}")
    require(not k1_in and len(k2_in) == sum(n["rs_correct"]
                                            for n in legs.values()),
            f"launches {legs} but {len(k1_in)} K1 and {len(k2_in)} K2 "
            "inputs kept")
    hold_kept(torch, dev, k1_in, k2_in, "the entry step")
    print(f"[12 entry, {smi_line}] the single-device entry step: {E.N_RAW} RAW words "
          f"(720p, P2, luma UEP, beacon {E.CFG.beacon.words_period} in band "
          f"{E.CFG.beacon.band_slot}) -> {tuple(words.shape)} int8, equal to "
          f"the CPU step and on a second call; decode back exact clean and "
          f"damaged ({len(ENTRY_BANDS)} bands, one header cell, "
          f"{ENTRY_BEACON_CELLS} beacon cells), overcap flagged; launches by "
          f"leg {json.dumps(legs)}; {len(k2_in)} K2 inputs held bit-equal to "
          f"the twin; times {json.dumps(times)}", flush=True)
    return legs, times


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
    k3_by_phase = {}

    def k3_counted(phase, fn, *args):
        """fn(*args) with its K3 launches read into ``k3_by_phase[phase]``."""
        before = launch_counts()
        out = fn(*args)
        k3_by_phase[phase] = (launch_counts() - before)["superframe_encode"]
        return out

    k1 = k3_counted("4 K1", phase_k1, torch, dev, codec, n_sf)
    k3 = k3_counted("4b K3", phase_k3, torch, dev)
    launches, real = k3_counted("5 main", phase_main, torch, dev, cfg)
    launches_px, at_sizes, _times = k3_counted("6 pixel", phase_pixel, torch,
                                               dev, cfg)
    launches_sv, _serve_times = k3_counted("7 serve", phase_serve, torch, dev,
                                           cfg)
    launches_ly, k1_ly, _layout_times = k3_counted("8 layouts", phase_layouts,
                                                   torch, dev)
    launches_pt, _proto_times = k3_counted("9 tools", phase_protos, torch,
                                           dev)
    launches_mh, _mesh_times = k3_counted("10 mesh", phase_mesh, torch, dev,
                                          smi_line)
    launches_bn = k3_counted("11 bench", phase_bench, torch, dev, smi_line)
    launches_en, _entry_times = k3_counted("12 entry", phase_entry, torch,
                                           dev, smi_line)
    for phase in ("5 main", "6 pixel", "7 serve", "8 layouts", "11 bench",
                  "12 entry"):
        require(k3_by_phase[phase] > 0, f"phase {phase}: K3 never launched")
    print(f"[K3 launches by phase] {json.dumps(k3_by_phase)}; phase 10's "
          f"ranks: " + json.dumps({leg: [r.get("superframe_encode") for r in
                                         ranks]
                                   for leg, ranks in launches_mh.items()}),
          flush=True)
    k1_at_sizes = dict(at_sizes["check_decode"])
    k1_at_sizes[f"uep {NONRESIDUE_UEP} n_sf={k1_ly.pop('n_sf')}"] = k1_ly
    k2.update(at_sizes["rs_correct"])
    k2_big = k2[f"k=22 B={K2_BLOCKS}"]
    t = dict(real["times"])
    k2[f"k=22 real window B={t.pop('B')}"] = t
    # no single PyTorch call computes either function: library_ms is null
    kernels = [
        {"name": "check_decode", "route": "cuda",
         "source": "ternary_image_codec_tpu_torch/csrc/check_decode.cu",
         "replaces": "ternary_image_codec_tpu/ops/dec_pallas.py:116",
         "launches": launches["check_decode"],
         "launches_pixel_path": launches_px["check_decode"],
         "launches_rgb_entry": launches_px["rgb_entry"]["check_decode"],
         "launches_serve": launches_sv["check_decode"],
         "launches_layouts": {leg: n["check_decode"]
                              for leg, n in launches_ly.items()},
         "launches_tools": {leg: n["check_decode"]
                            for leg, n in launches_pt.items()},
         "launches_mesh": {leg: [n["check_decode"] for n in ranks]
                           for leg, ranks in launches_mh.items()},
         "launches_bench": {tool: {leg: n["check_decode"]
                                   for leg, n in legs.items()}
                            for tool, legs in launches_bn.items()},
         "launches_entry": {leg: n["check_decode"]
                            for leg, n in launches_en.items()},
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "at_path_sizes": k1_at_sizes},
        {"name": "rs_correct", "route": "cuda",
         "source": "ternary_image_codec_tpu_torch/csrc/rs_correct.cu",
         "replaces": "ternary_image_codec_tpu/ops/rs_pallas.py:199",
         "launches": launches["rs_correct"],
         "launches_pixel_path": launches_px["rs_correct"],
         "launches_rgb_entry": launches_px["rgb_entry"]["rs_correct"],
         "launches_serve": launches_sv["rs_correct"],
         "launches_layouts": {leg: n["rs_correct"]
                              for leg, n in launches_ly.items()},
         "launches_tools": {leg: n["rs_correct"]
                            for leg, n in launches_pt.items()},
         "launches_mesh": {leg: [n["rs_correct"] for n in ranks]
                           for leg, ranks in launches_mh.items()},
         "launches_bench": {tool: {leg: n["rs_correct"]
                                   for leg, n in legs.items()}
                            for tool, legs in launches_bn.items()},
         "launches_entry": {leg: n["rs_correct"]
                            for leg, n in launches_en.items()},
         "max_abs_err": k2_err,
         "ms": k2_big["ms"], "device_ms": k2_big["device_ms"],
         "plain_ms": k2_big["plain_ms"], "bound_ms": k2_big["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "at_path_sizes": {key: t for key, t in k2.items()
                           if f"B={K2_BLOCKS}" not in key}},
        {"name": "superframe_encode", "route": "cuda",
         "source": "ternary_image_codec_tpu_torch/csrc/encode.cu",
         "replaces": None, "launches_by_phase": k3_by_phase,
         "launches_rgb_entry": launches_px["rgb_entry"]["superframe_encode"],
         "launches_mesh": {leg: [n.get("superframe_encode") for n in ranks]
                           for leg, ranks in launches_mh.items()},
         "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "device_ms": k3["device_ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
    ] + [
        {"name": f"bridge_{kind}", "route": "cuda",
         "source": "ternary_image_codec_tpu_torch/csrc/bridge.cu",
         "replaces": None,
         "launches_rgb_entry": launches_px["rgb_entry"][f"bridge_{kind}"],
         "max_abs_err": 0, **at_sizes["bridge"][kind], "bound_by": "bytes",
         "library_ms": None}
        for kind in ("ingest", "egress")]
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
