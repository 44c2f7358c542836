"""K2's compiled-in constants: csrc/rs_tables.cuh, generated from this file.

The header holds the GF(27) tables' image (``gf_table_image``), which each
block of csrc/rs_correct.cu copies to shared memory, and the packed GF(3)
syndrome map S2 (``packed_s2``), a ``const`` ``__constant__`` array the
compiler reads at build time: its words become immediate operands of the
kernel's dp4a, with no constant-cache reads at run time (a copy uploaded
at run time was 1.1-1.7x slower on the card, PERF.md).  Rewrite the header
after a change here:

    python -m ternary_image_codec_tpu_torch.ops.rs_tables

The CPU tests hold the header to ``header_source()`` and model the kernel
on these arrays.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from . import gf27, rs

HEADER = Path(__file__).resolve().parents[1] / "csrc" / "rs_tables.cuh"


def gf_table_image() -> np.ndarray:
    """K2's GF(27) tables as the kernel's ``GfTables`` lays them out, 1,552
    bytes: mul and add (27 x 27, row a, column b), neg, inv (27 each), exp
    (alpha^0..25), zeros to a multiple of 16."""
    T = gf27.tables()
    img = np.concatenate([T["mul"].ravel(), T["add"].ravel(),
                          gf27.np_gf_neg(np.arange(27)), T["inv"], T["exp"]])
    return np.pad(img, (0, -len(img) % 16)).astype(np.uint8)


def packed_s2() -> np.ndarray:
    """K2's syndrome map S2 of ``rs._matrices_pm(26 - r)`` for r = 2, 4, 6,
    8 (index r/2 - 1) as the kernel's dp4a takes it: (4, 24, 20) uint32, row
    q's entry for received digit f = 26 e + i in byte f % 4 of word f // 4,
    rows past 3r and bytes past 78 zero."""
    out = np.zeros((4, 24, 80), dtype=np.uint8)
    for r in (2, 4, 6, 8):
        out[r // 2 - 1, :3 * r, :78] = rs._matrices_pm(26 - r)["S2"].reshape(3 * r, 78)
    return out.view("<u4")



def header_arrays() -> dict:
    """Name -> (state space, C element type, array) of every constant in
    ``HEADER``."""
    return {"kGfTableImage": ("__device__", "uint8_t", gf_table_image()),
            "kS2": ("__constant__", "uint32_t", packed_s2())}


def header_source() -> str:
    """The text of ``HEADER``."""
    out = ["// Generated by `python -m ternary_image_codec_tpu_torch.ops.rs_tables`",
           "// from ops/gf27.py and ops/rs.py; do not edit.  K2's constants.",
           "#pragma once", "", "#include <cstdint>", ""]
    for name, (space, ctype, a) in header_arrays().items():
        dims = "".join(f"[{n}]" for n in a.shape)
        out.append(f"{space} __align__(16) const {ctype} {name}{dims} = {{")
        flat = [str(int(v)) + ("u" if ctype == "uint32_t" else "")
                for v in a.ravel()]
        per = 16 if ctype == "uint8_t" else 6
        out += ["    " + ", ".join(flat[i:i + per]) + ","
                for i in range(0, len(flat), per)]
        out += ["};", ""]
    return "\n".join(out)


if __name__ == "__main__":
    HEADER.write_text(header_source())
