"""RS(26,k) symbol throughput of the port (the JAX package's
``tools/rs_bench.py``).

Per k in 24, 22, 20, 18, over ``--blocks`` codewords: encode (plain torch
``rs.encode_pm``), syndrome check (``rs.syndromes_pm_bk``) and paged
correct (``rs.decode_paged_pm_bk``, whose correction chain is K2 on the
card), each warmed on its first input and timed over ``--iters`` - 1
distinct inputs (the one input again when ``--iters`` is 1), synchronised
on a scalar of each result.  Reported as Msym/s (26 GF(27) symbols a
codeword) and Mtrit/s (3 trits a symbol) under the JAX tool's keys.
``--errors`` codewords of each batch carry t = (26 - k) / 2 symbol errors;
the corrector takes up max(errors / 4, 4) dirty pages, as the JAX tool.

After the timed runs the corrected blocks are checked: every block the
corrector returns ok equals the clean codeword's data, and exactly the
dirty blocks of the dirty pages past the corrector's capacity come back
flagged, holding their received data.

Usage: python -m ternary_image_codec_tpu_torch.bench.rs_bench
           [--blocks 2000000] [--iters 4] [--errors 2000] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from ..cli import add_device_arg
from ..codec import resolve_device
from ..ops import rs
from . import peak_bytes, require, run_main
from .headline import counted, smi_line, sync

KS = (24, 22, 20, 18)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="rs_bench")
    ap.add_argument("--blocks", type=int, default=2_000_000)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--errors", type=int, default=2000,
                    help="corrupted blocks a batch in the paged run")
    add_device_arg(ap)
    return ap.parse_args(argv)


def timed(fn, inputs, dev):
    """Seconds a call of ``fn``: warmed on the first input, then timed over
    the others back to back, each result synchronised by a scalar."""
    int(fn(inputs[0]).to(torch.int32).sum())
    rest = inputs[1:] or inputs[:1]
    sync(dev)
    t0 = time.perf_counter()
    acc = [fn(x) for x in rest]
    for r in acc:
        int(r.to(torch.int32).sum())
    return (time.perf_counter() - t0) / len(rest)


def paged_expect(bad: np.ndarray, B: int, page: int, C: int):
    """(flagged (B,) bool) of the paged corrector's contract: the dirty
    blocks of dirty pages after the first C come back flagged."""
    dirty = np.zeros(B, dtype=bool)
    dirty[bad] = True
    pages = np.unique(bad // page)
    over = np.zeros(-(-B // page), dtype=bool)
    over[pages[C:]] = True
    return dirty & over[np.arange(B) // page]


def leg(k, args, rng, dev, keep, launches):
    """One k: its JSON row and (received (3, B, 26), corrected (3, B, k),
    ok (B,)) of the checked run."""
    B, iters = args.blocks, args.iters
    data = rng.integers(0, 3, size=(3, B, k)).astype(np.int8)  # (3, B, k)
    # encode_pm takes (3, k, B) data digits
    datasets = [torch.as_tensor(np.ascontiguousarray(
        ((data + i) % 3).transpose(0, 2, 1)), device=dev)
        for i in range(iters)]
    with counted(launches, f"k{k}"):
        t_enc = timed(lambda d: rs.encode_pm(d, k), datasets, dev)
    cw = rs.encode_pm(datasets[0], k).transpose(1, 2).cpu().numpy()
    del datasets
    bad = rng.choice(B, args.errors, replace=False)
    cwd = cw.copy()
    t_cap = (26 - k) // 2
    for bi in bad:
        for c in rng.choice(26, t_cap, replace=False):
            cwd[:, bi, c] = (cwd[:, bi, c] + 1) % 3
    wsets = [torch.as_tensor((cw + i) % 3, device=dev) for i in range(iters)]
    with counted(launches, f"k{k}"):
        t_chk = timed(lambda w: rs.syndromes_pm_bk(w, k), wsets, dev)
    del wsets
    page = rs.pick_page(B) or 256
    C = max(args.errors // 4, 4)

    def fix(w):
        return rs.decode_paged_pm_bk(w, k, page=page, max_dirty_pages=C)

    dsets = [torch.as_tensor(np.roll(cwd, i, axis=1), device=dev)
             for i in range(iters)]
    with counted(launches, f"k{k}"):
        t_fix = timed(lambda w: fix(w)[0], dsets, dev)
        with keep(f"rs_bench k{k}") if keep else contextlib.nullcontext():
            got, ok = fix(dsets[0])
    got, ok = got.cpu().numpy(), ok.cpu().numpy()
    flagged = paged_expect(bad, B, page, min(C, -(-B // page)))
    require(np.array_equal(ok, ~flagged),
            f"k={k}: ok flags differ from the paged contract "
            f"({int((~ok).sum())} flagged, {int(flagged.sum())} expected)")
    require(np.array_equal(got[:, ok], cw[:, ok, :k]),
            f"k={k}: a corrected block differs from its clean codeword")
    require(np.array_equal(got[:, ~ok], cwd[:, ~ok, :k]),
            f"k={k}: a block past the capacity is not its received data")
    sym = 26 * B
    row = {"encode_Msym_s": sym / t_enc / 1e6,
           "check_Msym_s": sym / t_chk / 1e6,
           "paged_fix_Msym_s": sym / t_fix / 1e6,
           "encode_Mtrit_s": 3 * sym / t_enc / 1e6,
           "flagged_past_capacity": int(flagged.sum()),
           "page": page, "max_dirty_pages": C}
    return row, (cwd, got, ok)


def run(argv=None, keep=None, held=None) -> dict:
    """The benchmark's result dict; raises ``BenchFailure`` when a check
    fails.  ``keep(leg)`` (a context manager) wraps each k's checked paged
    run; ``held``, a dict, receives each k's (received, corrected, ok)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    out, launches, peaks = {}, {}, {}
    for k in KS:
        with peak_bytes(peaks, f"k{k}", dev):
            row, res = leg(k, args, rng, dev, keep, launches)
        out[f"k{k}"] = dict(row, peak_bytes=peaks[f"k{k}"])
        if held is not None:
            held[k] = res
        print(k, row, flush=True)
    return {"metric": "rs26_throughput", "blocks": args.blocks, **out,
            "backend": f"torch-{dev.type}", "device": smi_line(dev),
            "k1_launches": {k: n["check_decode"] for k, n in launches.items()},
            "k2_launches": {k: n["rs_correct"] for k, n in launches.items()}}


def main(argv=None, keep=None) -> int:
    return run_main(run, argv, keep=keep)


if __name__ == "__main__":
    raise SystemExit(main())
