"""minitest_trits — trit-level property tests with the reference's JSON
report schema (src/minitest_trits.cpp:128-293).

Per subword mode (S27..S15): T1 balanced<->unbalanced roundtrip, T2 signed
int <-> fixed-L balanced ternary, T3 base-243 pack/unpack with CRC-12(0x80F)
+ mod-3 parity stream signatures.  The optional RS/GF self-test (the
reference gates it behind TEST_WITH_RS_SELFTEST and its RS is broken) always
runs here and must pass.  T1 and the RS self-test run on ``--device``
(default: the current CUDA device); T2 and T3 are host code, as in the
JAX package.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..codec import resolve_device
from ..ops import trits as T
from . import add_device_arg
from .sigs import crc12_0x80F


def _make_balanced(rng, n: int) -> np.ndarray:
    """10% -1 / 80% 0 / 10% +1 bias (src/minitest_trits.cpp:146-153)."""
    r = rng.integers(0, 100, size=n)
    return np.where(r < 10, -1, np.where(r < 90, 0, 1)).astype(np.int8)


def test_t1(rng, n: int, cases: int, device) -> int:
    mism = 0
    for _ in range(cases):
        bal = torch.as_tensor(_make_balanced(rng, n), device=device)
        if not torch.equal(T.unb_to_bal(T.bal_to_unb(bal)), bal):
            mism += 1
    return mism


def test_t2(rng, L: int, cases: int) -> int:
    vmax = (3 ** L - 1) // 2
    v = rng.integers(-vmax, vmax + 1, size=cases)
    bal = T.np_int_to_balanced_fixed(v, L)  # int64-exact host path (L<=27)
    back = T.np_balanced_fixed_to_int(bal)
    return int((back != v).sum())


def test_t3(rng, n: int, cases: int):
    mism, total_bytes = 0, 0
    concat_bytes, concat_unb = [], []
    for _ in range(cases):
        bal = _make_balanced(rng, n)
        unb = (bal + 1).astype(np.uint8)
        by, _tail = T.np_trits_to_base243(unb)
        back = T.np_base243_to_trits(by, n)
        if not np.array_equal(back, unb.astype(np.int8)):
            mism += 1
        concat_bytes.append(by)
        concat_unb.append(unb)
        total_bytes += by.size
    crc = crc12_0x80F(np.concatenate(concat_bytes))
    parity = int(np.concatenate(concat_unb).astype(np.int64).sum() % 3)
    return mism, crc, parity, total_bytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="minitest_trits")
    ap.add_argument("--cases-t1", type=int, default=200)
    ap.add_argument("--cases-t2", type=int, default=200)
    ap.add_argument("--cases-t3", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    tests = []
    all_ok = True
    for name, n in (("S27", 27), ("S24", 24), ("S21", 21), ("S18", 18),
                    ("S15", 15)):
        mm1 = test_t1(rng, n, args.cases_t1, dev)
        mm2 = test_t2(rng, n, args.cases_t2)
        mm3, crc, parity, total = test_t3(rng, n, args.cases_t3)
        ok1, ok2, ok3 = mm1 == 0, mm2 == 0, mm3 == 0
        all_ok &= ok1 and ok2 and ok3
        tests.append({
            "mode": name, "N_trits": n,
            "T1_balanced_unbalanced": {"cases": args.cases_t1,
                                       "mismatches": mm1, "ok": ok1},
            "T2_int_fixedL": {"cases": args.cases_t2, "mismatches": mm2,
                              "ok": ok2},
            "T3_pack_unpack": {"cases": args.cases_t3, "mismatches": mm3,
                               "bytes_total": total,
                               "crc12_0x80F": f"{crc:03X}",
                               "parity_mod3": parity, "ok": ok3},
        })

    from .main_bare import selftest_rs_unit
    rs_ok = selftest_rs_unit(device=dev)
    print(json.dumps({"report": {
        "tests": tests,
        "rs_gf_selftest": "OK" if rs_ok else "FAIL",
        "final_status": "PASS" if (all_ok and rs_ok) else "CHECK",
    }}, indent=2))
    return 0 if (all_ok and rs_ok) else 1


if __name__ == "__main__":
    raise SystemExit(main())
