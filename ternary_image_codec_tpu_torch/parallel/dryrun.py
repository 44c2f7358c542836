"""The multichip dry run: the JAX package's ``__graft_entry__.
dryrun_multichip`` on ranks, leg for leg, and one leg more.

    python -m ternary_image_codec_tpu_torch.parallel.dryrun 4 \\
        [--device cpu] [--backend gloo]

Legs, on tiny shapes: a frame-DP round trip; a frame-DP paged repair of
injected symbol errors; P5 (5x5) + beacon frames under frame-DP; word-
stream sharding (equal to the single-device encode); superframe-DP of one
frame; the fused two-phase decode under superframe-DP, with its window
overflow failing safe; with an even rank count, the 2-stage pipeline
clean and with damage on the stage link.  The leg the reference cannot
pass: damaged header cells under the fused decode are repaired within the
RS(26,18) chain's capacity and flagged beyond it.  Any failed leg raises.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..config import (EncoderConfig, ProfileID, SparseBeaconCfg, Tile2D,
                      uep_luma_priority)
from ..ops import pipeline
from ..ops.pipeline import HEADER_WORDS
from . import launch
from . import mesh as M

TIMEOUT_S = 300


def make_raw_words(n: int, seed: int = 0) -> np.ndarray:
    """n RAW words (n, 9) int8 with trit 26 zero (the reference's
    ``_make_raw_words``: the same generator and draws)."""
    r = np.random.default_rng(seed)
    t = r.integers(0, 3, size=(n, 27)).astype(np.int8)
    t[:, 26] = 0
    return (t.reshape(n, 9, 3) * np.array([1, 3, 9])).sum(-1).astype(np.int8)


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _equal(got: torch.Tensor, want: np.ndarray) -> bool:
    return np.array_equal(got.cpu().numpy(), want)


def damage_header_cells(prof: np.ndarray, sf: int, cells) -> None:
    """Add 1 (mod 27), in place, to header cells of superframe ``sf`` of
    profile words (n_sf, total, 9): cell c is symbol c of the 6 x 9 header
    words (word c // 9, band c % 9)."""
    for c in cells:
        w, b = divmod(c, 9)
        prof[sf, w, b] = (prof[sf, w, b] + 1) % 27


def dryrun_rank(rank: int, world: int) -> str:
    """Every leg on this rank of a ``world``-rank mesh; returns the
    summary line."""
    n_devices = world
    mesh = M.make_mesh(n_devices)
    dev = mesh.device
    cfg = EncoderConfig(profile=ProfileID.P2_RS26_22, uep=uep_luma_priority())

    # 1) DP over frames: 2n tiny frames, encode -> decode -> reduce
    B, n_raw = 2 * n_devices, 36
    frames = np.stack([make_raw_words(n_raw, seed=i) for i in range(B)])
    raw_out, ok = M.roundtrip_step_dp(frames, cfg, mesh)
    _require(bool(ok), "multi-chip roundtrip flagged failure")
    _require(_equal(M.gather(mesh, raw_out)[:, :n_raw], frames),
             "multi-chip roundtrip mismatch")

    # 1b) error-injected paged repair under frame-DP
    words = M.gather(mesh, M.encode_frames_dp(frames, cfg, mesh)) \
        .cpu().numpy().copy()
    words[:, HEADER_WORDS + 7, 4] = (words[:, HEADER_WORDS + 7, 4] + 1) % 27
    words[:, HEADER_WORDS + 20, 1] = (words[:, HEADER_WORDS + 20, 1] + 2) % 27
    fix, ok_f, all_ok = M.decode_frames_dp(words, cfg, mesh, rs_mode="paged")
    _require(bool(all_ok) and bool(M.gather(mesh, ok_f).all()),
             "multi-chip repair flagged failure")
    _require(_equal(M.gather(mesh, fix)[:, :n_raw], frames),
             "multi-chip repair mismatch")

    # 1c) P5 (5x5) + beacon frames under frame-DP
    cfg_p5 = EncoderConfig(profile=ProfileID.P5_RS26_22_2D,
                           uep=uep_luma_priority(),
                           beacon=SparseBeaconCfg(13, 4, True),
                           tile=Tile2D(5, 5))
    frames5 = np.stack([make_raw_words(n_raw, seed=40 + i) for i in range(B)])
    out5, ok5 = M.roundtrip_step_dp(frames5, cfg_p5, mesh)
    _require(bool(ok5), "P5+beacon DP roundtrip flagged failure")
    _require(_equal(M.gather(mesh, out5)[:, :n_raw], frames5),
             "P5+beacon DP roundtrip mismatch")

    # 2) stream sharding: one larger frame's profile rows across the mesh
    raw = make_raw_words(n_devices * 64)
    prof = M.gather(mesh, M.encode_stream_sharded(raw, cfg, mesh))
    _require(prof.shape[1] == 9 and torch.equal(
        prof, pipeline.encode_profile_from_raw(raw, cfg, device=dev)),
        "stream-sharded encode differs from the single-device encode")

    # 3) superframe-DP: one frame in 32-word superframes over the mesh
    cfg_sf = dataclasses.replace(cfg, superframe_words=32)
    raw2 = make_raw_words(n_devices * 32 * 2 + 11, seed=3)
    out, ok = M.roundtrip_superframes_dp(raw2, cfg_sf, mesh)
    _require(bool(ok), "superframe-DP roundtrip flagged failure")
    _require(_equal(M.gather(mesh, out)[:raw2.shape[0]], raw2),
             "superframe-DP mismatch")

    # 3b) the fused two-phase decode under superframe-DP: two damaged
    #     superframes on different ranks repaired, the window overflow
    #     (repair_cap 1) failing safe
    n_sf2 = -(-raw2.shape[0] // 32)
    n_sf2 = -(-n_sf2 // n_devices) * n_devices
    raw2p = np.concatenate([raw2, np.zeros((n_sf2 * 32 - raw2.shape[0], 9),
                                           np.int8)])
    prof2 = np.stack([pipeline.encode_profile_from_raw(
        raw2p[i * 32:(i + 1) * 32], cfg_sf, device=dev).cpu().numpy()
        for i in range(n_sf2)])
    dirty2 = prof2.copy()
    dirty2[0, HEADER_WORDS + 3, 2] = (dirty2[0, HEADER_WORDS + 3, 2] + 1) % 27
    dirty2[-1, HEADER_WORDS + 11, 6] = (dirty2[-1, HEADER_WORDS + 11, 6]
                                        + 2) % 27

    def fused(words, cap):
        fix, ok = M.decode_superframes_fused_dp(words, cfg_sf, mesh,
                                                repair_cap=cap)
        got = M.gather(mesh, fix)[:, :32, :].reshape(-1, 9)
        return got[:raw2.shape[0]], bool(ok)

    got2, okf2 = fused(dirty2, 3)
    _require(okf2, "fused superframe-DP repair flagged failure")
    _require(_equal(got2, raw2), "fused superframe-DP mismatch")
    _require(not fused(dirty2, 1)[1], "fused window overflow must fail safe")

    # 3c) header cells under the fused decode (the reference never checks
    #     them): 3 damaged cells in one header block of the first and of
    #     the last superframe are repaired (t = 4 for RS(26,18)), equal to
    #     the single-device fused decode; 5 in one block are flagged
    hdr = dirty2.copy()
    damage_header_cells(hdr, 0, (1, 9, 20))
    damage_header_cells(hdr, n_sf2 - 1, (27, 30, 40))
    got3, okf3 = fused(hdr, 4)
    ref3, ref_ok3 = pipeline.decode_stream_superframes(
        hdr, cfg_sf, raw2.shape[0], strategy="fused", repair_cap=4,
        device=dev)
    _require(okf3 and bool(ref_ok3) and torch.equal(got3, ref3)
             and _equal(got3, raw2),
             "fused superframe-DP did not repair damaged header cells")
    damage_header_cells(hdr, n_sf2 - 1, (0, 2, 5, 11, 17))
    _require(not fused(hdr, 4)[1],
             "damaged header cells beyond capacity must flag")

    # 4) pipeline parallelism: a 2-stage (encode | decode) mesh x DP
    if n_devices % 2 == 0:
        pp_mesh = M.make_mesh_pp(n_devices)
        T, db = 3, n_devices // 2
        fpp = np.stack([[make_raw_words(n_raw, seed=90 + 10 * t + i)
                         for i in range(db)] for t in range(T)])

        def pp(dmg=None):
            out, ok = M.roundtrip_pipeline_pp(fpp, cfg, pp_mesh,
                                              wire_damage=dmg)
            return (M.gather(pp_mesh, out, dim=1, axis="data"),
                    M.gather(pp_mesh, ok, dim=1, axis="data"))

        out_pp, ok_pp = pp()
        _require(bool(ok_pp.all()), "PP roundtrip flagged")
        _require(_equal(out_pp[:, :, :n_raw], fpp), "PP roundtrip mismatch")

        # 4b) <= t symbol errors a codeword on the stage link, repaired
        total = pipeline.build_encode_layout(cfg, n_raw).total_words
        dmg = np.zeros((T, db, total, 9), np.int8)
        for mt, fr, band in [(0, 0, 1), (1, db - 1, 4), (2, 0, 7)]:
            for c in (2, 19):          # 2 errors in body block 1 (t >= 2)
                dmg[mt, fr, HEADER_WORDS + 26 + c, band] = 5 + c
        out_pr, ok_pr = pp(dmg)
        _require(bool(ok_pr.all()), "PP repair flagged failure")
        _require(_equal(out_pr[:, :, :n_raw], fpp), "PP repair mismatch")

    return (f"dryrun_multichip OK on {n_devices} devices "
            f"(DP batch {B}, error-injected DP repair, "
            f"fused-P5(5x5)+beacon DP batch {B}, "
            f"stream {raw.shape[0]} words, "
            f"superframe-DP {raw2.shape[0]} words, "
            f"fused two-phase repair + overflow fail-safe under "
            f"superframe-DP, "
            f"2-stage PP + error-injected PP repair)")


def dryrun_multichip(n_devices: int, device=None, backend=None) -> None:
    """Run every leg on ``n_devices`` ranks (``launch.spawn``'s device and
    backend rules: by default one card a rank under NCCL, raising without
    a card) and print the summary line; ranks running past ``TIMEOUT_S``
    raise."""
    print(launch.spawn(dryrun_rank, n_devices, backend=backend,
                       device=device, timeout_s=TIMEOUT_S)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
