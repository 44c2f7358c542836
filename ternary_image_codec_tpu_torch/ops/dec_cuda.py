"""K1: the superframe check decode as a hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel ops/dec_pallas.py
(``check_decode_fn``); the kernel is csrc/check_decode.cu.  Both it and its
plain torch twin ``check_decode_ref`` have the semantics of the
reference's XLA check path (``pipeline_v3.check_decode_fn_v3``,
rs_mode="check"): descramble, one ok flag per superframe (every codeword's
syndromes zero over its band's r rows), and the data symbols reassembled
into RAW planes without correction.

The kernel reads one uint32 table per layout, built here on the host
(``host_consts``) and uploaded once:

* ``[0, LUT_WORDS)``: the descramble table ``descramble_lut``, entry
  (parity, band, byte) at ``(parity * 9 + band) * 256 + byte``;
* ``[BFRAG_OFF, BAND_OFF)``: the syndrome map ``syndrome_matrix`` as the B
  operand of ``mma.m16n8k32.s8``, per lane ``[lane][nt][kt][reg]``
  (``bfrag_words``);
* ``[BAND_OFF, +9)``: the k of each band.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import NUM_BANDS
from ..runtime import build
from . import rs, scramble

# kernel launches made by check_decode in this process
launches = 0

LUT_WORDS = 2 * NUM_BANDS * 256
BFRAG_OFF = LUT_WORDS
BAND_OFF = BFRAG_OFF + 32 * 24
CONST_WORDS = BAND_OFF + NUM_BANDS


def supported(layout) -> bool:
    """True when the kernel covers this decode layout."""
    geom, hdr = layout.geom, layout.hdr
    if hdr.beacon.enabled:
        return False
    if hdr.tile.w and hdr.tile.h:          # P5 2D interleave
        return False
    if not all(geom.blocks[b] == geom.blocks[0] for b in range(NUM_BANDS)):
        return False
    if geom.blocks[0] <= 0:
        return False
    if geom.H != geom.blocks[0] * 26:
        return False
    return all(k % 2 == 0 for k in geom.ks)


def check_decode_ref(body: torch.Tensor, tables: dict):
    """Plain torch twin of K1: body (n, 9, H) -> (out (n, 9, n_out) int8,
    ok (n,) bool), with ``tables`` the tables of the body's codec."""
    from .pipeline import assemble_words, descramble_grid, grid_syndromes
    grid = descramble_grid(body, tables)                    # (n, 9, H, 3)
    S = grid_syndromes(grid, tables)                        # (n, 9, nb, 3, 8)
    bad = (S != 0) & tables["rmask"][None, :, None, None, :]
    return assemble_words(grid, tables), ~bad.flatten(1).any(-1)


def descramble_lut(seed) -> np.ndarray:
    """(2, 9, 256) uint32: wire byte x (read as int8) of band b at a body
    column of parity p -> its descrambled symbol in byte 0 and that
    symbol's digits in bytes 1..3.  Digits have floor semantics for every
    int8 value, invalid wire bytes included (the digits of x mod 27)."""
    pat = scramble.np_offsets(6, seed.a, seed.b, seed.s0)
    b = np.arange(NUM_BANDS)
    # scramble offset of band b at even and at odd columns (ops/scramble.py)
    off = np.stack([pat[b % 6], pat[(3 + b) % 6]])[:, :, None, None]
    v = np.arange(256).astype(np.uint8).astype(np.int8).astype(np.int64)
    dig = (v[:, None] // 3 ** np.arange(3)) % 3             # (256, 3)
    dd = (dig[None, None] - off) % 3                        # (2, 9, 256, 3)
    sym = dd[..., 0] + 3 * dd[..., 1] + 9 * dd[..., 2]
    return (sym | dd[..., 0] << 8 | dd[..., 1] << 16
            | dd[..., 2] << 24).astype(np.uint32)


def syndrome_matrix() -> np.ndarray:
    """(24, 128) int8 M: the r=8 syndrome map on lookup words.  Row 3j + d'
    gives digit d' of S_j (j-major, so a band with r syndromes uses the
    first 3r rows).  Column 32kt + 16hh + 4q + 1 + d multiplies byte 1 + d
    of the word in k-slot (kt, hh) of lane q, digit d of coefficient
    i = 8kt + 4hh + q; byte 0 (the symbol) and coefficients i >= 26 meet
    zero columns."""
    S2 = np.asarray(rs._matrices_pm(18)["S2"]).reshape(3, 8, 3, rs.N)
    S = S2.transpose(1, 0, 3, 2).reshape(24, rs.N, 3)      # (3j + d', i, d)
    M = np.zeros((24, 32, 4), dtype=np.int8)                # (row, i, byte)
    M[:, :rs.N, 1:] = S
    return M.reshape(24, 128)


def bfrag_words(M: np.ndarray) -> np.ndarray:
    """(32 lanes, 3 nt, 4 kt, 2 regs) uint32: the B fragments of
    ``mma.m16n8k32.col`` for B = M^T.  Lane 4g + q holds column 8nt + g of
    B (row of M), k-rows 4q..4q+3 of the k-tile in reg 0 and 16 + 4q.. in
    reg 1; lowest k in byte 0."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    out = np.zeros((32, 3, 4, 2), dtype=np.uint32)
    for nt in range(3):
        for kt in range(4):
            for reg in range(2):
                col = 32 * kt + 16 * reg + 4 * q
                by = M[(8 * nt + g)[:, None], col[:, None] + np.arange(4)] \
                    .astype(np.uint8).astype(np.uint32)
                out[:, nt, kt, reg] = (by[:, 0] | by[:, 1] << 8
                                       | by[:, 2] << 16 | by[:, 3] << 24)
    return out


@functools.cache
def host_consts(layout) -> np.ndarray:
    """(CONST_WORDS,) uint32: the table the kernel reads (module docstring)."""
    return np.concatenate([
        descramble_lut(layout.hdr.seed).reshape(-1),
        bfrag_words(syndrome_matrix()).reshape(-1),
        np.asarray(layout.geom.ks, dtype=np.uint32)])


@functools.cache
def _consts(layout, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(host_consts(layout).view(np.int32), device=device)


@functools.cache
def _lib():
    lib = build.load("check_decode")
    fn = lib.t3_check_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    plan_fn = lib.t3_check_decode_plan
    plan_fn.restype = ctypes.c_int
    plan_fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    return lib


def _validate(body: torch.Tensor, layout):
    if not supported(layout):
        raise ValueError("check_decode: layout not covered by the kernel")
    if body.device.type != "cuda":
        raise ValueError(f"check_decode needs a CUDA tensor, got {body.device}")
    if body.dtype != torch.int8:
        raise TypeError(f"check_decode needs int8 symbols, got {body.dtype}")
    H = layout.geom.H
    if body.dim() != 3 or tuple(body.shape[1:]) != (NUM_BANDS, H):
        raise ValueError(f"check_decode needs (n, 9, {H}), got "
                         f"{tuple(body.shape)}")
    if body.stride(2) != 1:
        raise ValueError("check_decode needs a contiguous last axis")
    if not all(16 <= k <= 24 for k in layout.geom.ks):
        raise ValueError("check_decode needs 16 <= k <= 24 in every band")


@functools.cache
def _plan(device, row_stride, nblk, kmax) -> dict:
    """The kernel's plan for one geometry on one device (csrc
    ``t3_check_decode_plan``)."""
    lib, got = _lib(), (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.t3_check_decode_plan(row_stride, nblk, kmax, got)
    build.check(lib, err, "check_decode plan")
    return dict(zip(("staged", "max_grid", "smem", "blocks_per_sm",
                     "stream_bytes"), got))


def _launch_plan(body: torch.Tensor, layout) -> dict:
    p = _plan(body.device, body.stride(1), layout.geom.blocks[0],
              max(layout.geom.ks))
    grid = min(body.shape[0], p["max_grid"])
    return {"staged": p["staged"], "grid": grid, "smem": p["smem"],
            "blocks_per_sm": p["blocks_per_sm"],
            "scratch": 0 if p["staged"] else grid * p["stream_bytes"]}


def plan(body: torch.Tensor, layout) -> dict:
    """The launch ``check_decode`` makes for ``body``: ``staged`` (1: body
    and stream buffer in shared memory; 0: they do not fit, both stay in
    global memory), grid, dynamic shared bytes, resident blocks per SM and
    the scratch bytes of an unstaged launch."""
    _validate(body, layout)
    return _launch_plan(body, layout)


def check_decode(body: torch.Tensor, layout):
    """K1: body (n_sf, 9, H) int8 on a CUDA device -> (out (n_sf, 9, n_out)
    int8, ok (n_sf,) bool).  The body may be a view into wire planes
    (n_sf, 9, 6 + H) as long as its last axis is contiguous.  Raises on a
    layout ``supported`` rejects and on a tensor the kernel does not take."""
    global launches
    _validate(body, layout)
    n = body.shape[0]
    n_out = layout.n_out_words
    out = torch.empty((n, NUM_BANDS, n_out), dtype=torch.int8,
                      device=body.device)
    ok = torch.empty((n,), dtype=torch.bool, device=body.device)
    if n == 0:
        return out, ok
    consts = _consts(layout, body.device)
    lib = _lib()
    need = _launch_plan(body, layout)["scratch"]
    scratch = torch.empty((need,), dtype=torch.uint8, device=body.device) \
        if need else None
    with torch.cuda.device(body.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.t3_check_decode(body.data_ptr(), body.stride(0),
                                  body.stride(1), n, layout.geom.blocks[0],
                                  max(layout.geom.ks), n_out,
                                  consts.data_ptr(), out.data_ptr(),
                                  ok.data_ptr(),
                                  None if scratch is None
                                  else scratch.data_ptr(), stream)
    build.check(lib, err, "check_decode launch")
    launches += 1
    return out, ok
