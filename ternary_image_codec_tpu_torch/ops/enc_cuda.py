"""K3: the superframe encode as a hand-written CUDA kernel.

Replaces no Pallas kernel: the JAX package left the encode to XLA
(``_encode_parts_pm``, ops/pipeline.py:533-688, and
``pipeline_v3.encode_fn_v3``).  The kernel is csrc/encode.cu; its plain
torch twin is ``encode.encode_superframes_ref``, which it matches bit for
bit on every layout the port encodes.

The kernel reads one int32 table per layout, built here on the host with
numpy (``host_consts``) at the first encode on the card and uploaded once:

* ``[0, 16)``: the scalars (``C_*``);
* ``[SCR_OFF, +18)``: the scramble offset of band b at even and at odd body
  rows, ``2 * b + (h & 1)``;
* ``[HDR_OFF, +54)``: the 6 header symbols of each band, ``6 * b + col``;
* ``[BAND_OFF, +9 * BAND_WORDS)``: each band's k, kind (``bands``), block
  count, parity map and the offset of its staging in shared memory;
* ``[BF_OFF, +PMAX * BF_WORDS)``: the parity map ``par{k}`` of each k of
  the body, ascending, as the B operand of ``mma.m16n8k32.s8``, per lane
  ``[lane][kt][nt][reg]`` (``parity_matrix`` through K1's
  ``dec_cuda.bfrag_words``, k-tiles 0..2);
* ``[UNIT_OFF, ...)``: the units of one superframe (``units``), one thread
  block each.

Under P5 the kernel also reads the interleave ``interleave.perm`` as one
int32 table of the stream length (``_perm``).  The digit words of a RAW
byte, the place of a stream symbol's trits in its three words and the
scramble of a symbol are constants of the kernel itself.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import NUM_BANDS
from ..runtime import build
from . import dec_cuda, interleave, rs, scramble
from .pipeline import HEADER_WORDS, _is_p5, _stream_len, k_groups, parity_map

TILE = 16                        # codewords of one band per mma row tile
UNIT_COLS = 1760                 # data columns of each band a unit takes
PMAX = 3                         # parity maps: the body's k in {20, 22, 24}
BAND_WORDS = 8
BF_WORDS = 32 * 18               # [lane][kt][nt][reg]
UNIT_WORDS = 72
UNIT_BAND = 8                    # then a slot per band: band, cw0, cw1,
SLOT_WORDS = 7                   # col0, col1, fill_from, first task
C_NRAW, C_H, C_UNITS, C_P5, C_L, C_BCBAND, C_BCP, C_BCSYM, C_SYMB, \
    C_STAGE = range(10)
SCR_OFF = 16
HDR_OFF = SCR_OFF + 2 * NUM_BANDS
BAND_OFF = HDR_OFF + HEADER_WORDS * NUM_BANDS
BF_OFF = BAND_OFF + BAND_WORDS * NUM_BANDS
UNIT_OFF = BF_OFF + PMAX * BF_WORDS
UNIFORM, BEACON, FILL = range(3)
# parameters, digit words, scramble table, B fragments
SM_SYM = 704 + 1024 + 256 + PMAX * BF_WORDS * 4


def parity_matrix(par: np.ndarray, k: int) -> np.ndarray:
    """(24, 128) int8 M of the parity map ``par`` ((3k, 3(26-k)), rows
    (c, d), columns (c', d')) for ``dec_cuda.bfrag_words``: row 8d' + c'
    gives digit d' of parity symbol c' (c' < 26 - k <= 8), column 4c + d
    multiplies digit d of data symbol c (byte d of its digit word); digit 3
    and symbols past k meet zeros."""
    r = rs.N - k
    M = np.zeros((3, 8, 32, 4), dtype=np.int8)          # (d', c', c, d)
    M[:, :r, :k, :3] = np.asarray(par, dtype=np.int8) \
        .reshape(k, 3, r, 3).transpose(3, 2, 0, 1)
    return M.reshape(24, 128)


def bands(layout) -> list:
    """(kind, k, nblk) of each band: ``UNIFORM`` for a band of a uniform
    k-group (``k_groups``), ``BEACON`` for the beacon band with whole
    codewords, ``FILL`` for a band with none (scrambled zeros and beacon
    cells)."""
    out = [(FILL, 0, 0)] * NUM_BANDS
    for g in k_groups(layout.geom, layout.cfg.beacon):
        for b in g.bands:
            out[b] = (BEACON if g.beacon else UNIFORM, g.k, g.nblk)
    return out


def _start(layout, kind, B):
    """First body row of band codeword B (B may be the block count: the
    row after the last codeword)."""
    if kind != BEACON:
        return 26 * B
    p = layout.cfg.beacon.words_period
    j = np.maximum(26 * B - 1, 0)
    return np.where(B > 0, j + j // (p - 1) + 2, 0)


def units(layout) -> np.ndarray:
    """(U, UNIT_WORDS) int32: the units of one superframe, in stream order.
    Unit u takes the data columns [u, u + 1) * UNIT_COLS of every band.
    After m0, m1 and the task count, a slot a band, the bands of one k
    together: the band; its codewords whose first data column lies there,
    [cw0, cw1); the output columns [col0, col1) of the band that the unit
    writes (col = 6 + body row: from its first codeword's first row to the
    next unit's, the header in the first unit, the rows past the last
    codeword in the unit that holds it; a band without codewords is all in
    unit 0); the first body row past the band's codewords where the unit
    holds them (``fill_from``, else H); and its first task (16 codewords a
    task).  [m0, m1) is the window of 27-byte groups of RAW words (26
    stream symbols each) that the unit's data reads."""
    cfg, H = layout.cfg, layout.geom.H
    p5 = _is_p5(cfg.profile, cfg.tile)
    L = _stream_len(layout.geom)
    perm = interleave.perm(L, cfg.tile.w, cfg.tile.h) if p5 else None
    bd = bands(layout)
    n_units = max(1, -(-max(k * nb for _, k, nb in bd) // UNIT_COLS))
    J0 = np.arange(n_units) * UNIT_COLS
    t = np.zeros((n_units, UNIT_WORDS), dtype=np.int64)
    lo = np.full(n_units, np.iinfo(np.int64).max)
    hi = np.zeros(n_units, dtype=np.int64)
    tasks = np.zeros(n_units, dtype=np.int64)
    # slots in task order: the bands of one k together, so that a warp
    # seldom loads another parity map
    order = sorted(range(NUM_BANDS), key=lambda b: (bd[b][0] == FILL,
                                                    bd[b][1], b))
    for i, b in enumerate(order):
        kind, k, nblk = bd[b]
        rec = t[:, UNIT_BAND + SLOT_WORDS * i:UNIT_BAND + SLOT_WORDS * (i + 1)]
        rec[:, 0] = b
        if kind == FILL:
            rec[0, 4] = HEADER_WORDS + H
            rec[:, 5] = np.where(np.arange(n_units) == 0, 0, H)
        else:
            cw0 = np.minimum(-(-J0 // k), nblk)
            cw1 = np.minimum(-(-(J0 + UNIT_COLS) // k), nblk)
            has = cw1 > cw0
            last = has & (cw1 == nblk)
            rec[:, 1], rec[:, 2] = cw0, cw1
            rec[:, 3] = np.where(cw0 == 0, 0,
                                 HEADER_WORDS + _start(layout, kind, cw0))
            rec[:, 4] = np.where(last, HEADER_WORDS + H,
                                 HEADER_WORDS + _start(layout, kind, cw1))
            rec[~has, 3:5] = 0
            rec[:, 5] = np.where(last, _start(layout, kind, nblk), H)
            lo = np.where(has, np.minimum(lo, 9 * cw0 * k + b), lo)
            hi = np.where(has, np.maximum(hi, 9 * cw1 * k + b - 8), hi)
        rec[:, 6] = tasks
        tasks += -(-(rec[:, 2] - rec[:, 1]) // TILE)
    # stream symbols the data reads: i in [lo, hi) (P5: perm[i], i < L)
    has = hi > lo
    if p5:
        span = [perm[a:c] for a, c in zip(np.minimum(lo, L), np.minimum(hi, L))]
        has = np.asarray([x.size > 0 for x in span])
        smin = np.asarray([x.min() if x.size else 0 for x in span])
        smax = np.asarray([x.max() if x.size else 0 for x in span])
    else:
        smin, smax = np.where(has, lo, 0), np.where(has, hi - 1, 0)
    t[:, 0] = np.where(has, smin // 26, 0)
    t[:, 1] = np.where(has, smax // 26 + 1, 0)
    t[:, 2] = tasks
    return t.astype(np.int32)


@functools.cache
def host_consts(layout) -> np.ndarray:
    """(UNIT_OFF + U * UNIT_WORDS,) int32: the table the kernel reads
    (module docstring)."""
    cfg, geom = layout.cfg, layout.geom
    beacon = cfg.beacon
    bd = bands(layout)
    unit = units(layout)
    p5 = _is_p5(cfg.profile, cfg.tile)
    ks = sorted({k for kind, k, _ in bd if kind != FILL})
    # staging of each band: its widest column range, 16 bytes of
    # alignment, rounded to 16
    slots = unit[:, UNIT_BAND:UNIT_BAND + SLOT_WORDS * NUM_BANDS] \
        .reshape(len(unit), NUM_BANDS, SLOT_WORDS)
    width = np.zeros(NUM_BANDS, dtype=np.int64)
    width[slots[0, :, 0]] = (slots[:, :, 4] - slots[:, :, 3]).max(0)
    width += 16
    width = -(-width // 16) * 16
    stage_off = np.concatenate([[0], np.cumsum(width)])
    # the staging holds the RAW window (aligned as the input) until the
    # stream symbols are made
    raw_bytes = -(-(27 * int((unit[:, 1] - unit[:, 0]).max()) + 32) // 16) * 16
    t = np.zeros(UNIT_OFF + unit.size, dtype=np.int64)
    t[:C_STAGE + 1] = (
        layout.n_raw_words, geom.H, len(unit), p5,
        _stream_len(geom) if p5 else 0,
        beacon.band_slot if beacon.enabled else -1,
        beacon.words_period if beacon.enabled else 0, geom.beacon_sym,
        -(-(26 * int((unit[:, 1] - unit[:, 0]).max())) // 16) * 16,
        max(stage_off[-1], raw_bytes))
    off = scramble.pm_offsets(2, cfg.seed, 1)[::3]          # (9, 2)
    t[SCR_OFF:HDR_OFF] = off.reshape(-1)
    t[HDR_OFF:BAND_OFF] = layout.header_words.T.reshape(-1)
    for b, (kind, k, nblk) in enumerate(bd):
        t[BAND_OFF + BAND_WORDS * b:][:5] = (
            k, kind, nblk, ks.index(k) if kind != FILL else 0, stage_off[b])
    for i, k in enumerate(ks):
        par = parity_map(rs._matrices_pm(k)["G2"], k)
        # K1's fragments [lane][nt][kt][reg], k-tiles 0..2, as
        # [lane][kt][nt][reg]: a lane's 18 words in the order it loads them
        words = dec_cuda.bfrag_words(parity_matrix(par, k))[:, :, :3]
        t[BF_OFF + i * BF_WORDS:BF_OFF + (i + 1) * BF_WORDS] = \
            words.transpose(0, 2, 1, 3).reshape(-1).view(np.int32)
    t[UNIT_OFF:] = unit.reshape(-1)
    return t.astype(np.int32)


def plan(layout) -> dict:
    """The launch ``encode`` makes for one superframe of ``layout``: units
    (thread blocks a superframe), the bytes of a unit's stream symbols and
    of its staging, and the dynamic shared memory of a block."""
    t = host_consts(layout)
    return {"units": int(t[C_UNITS]), "sym_bytes": int(t[C_SYMB]),
            "stage_bytes": int(t[C_STAGE]),
            "smem": SM_SYM + int(t[C_SYMB]) + int(t[C_STAGE])}


@functools.cache
def _consts(layout, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(host_consts(layout), device=device)


@functools.cache
def _perm(layout, device: torch.device):
    """P5's interleave over the stream length as int32 on ``device``; None
    for a layout without P5."""
    cfg = layout.cfg
    if not _is_p5(cfg.profile, cfg.tile):
        return None
    p = interleave.perm(_stream_len(layout.geom), cfg.tile.w, cfg.tile.h)
    return torch.as_tensor(p.astype(np.int32), device=device)


@functools.cache
def _lib():
    lib = build.load("encode")
    fn = lib.t3_superframe_encode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _validate(chunks: torch.Tensor, layout):
    if chunks.dtype != torch.int8:
        raise TypeError(f"encode needs int8 RAW symbols, got {chunks.dtype}")
    n_raw = layout.n_raw_words
    if chunks.dim() != 3 or tuple(chunks.shape[1:]) != (n_raw, NUM_BANDS):
        raise ValueError(f"encode needs (n, {n_raw}, {NUM_BANDS}), got "
                         f"{tuple(chunks.shape)}")
    ks = {k for kind, k, _ in bands(layout) if kind != FILL}
    if not all(18 <= k <= 24 for k in ks) or len(ks) > PMAX:
        raise ValueError(f"encode needs at most {PMAX} k, 18 <= k <= 24, "
                         f"got {sorted(ks)}")
    if chunks.device.type != "cuda":
        raise ValueError(f"encode needs a CUDA tensor, got {chunks.device}")


def encode(chunks: torch.Tensor, layout) -> torch.Tensor:
    """K3: RAW words (n, n_raw_words, 9) int8 on a CUDA device -> wire planes
    (n, 9, 6 + H) int8 in one launch, equal to ``encode_superframes``' twin.
    A strided input is made contiguous once.  Raises on a tensor the kernel
    does not take."""
    _validate(chunks, layout)
    n, H = chunks.shape[0], layout.geom.H
    out = torch.empty((n, NUM_BANDS, HEADER_WORDS + H), dtype=torch.int8,
                      device=chunks.device)
    if n == 0:
        return out
    chunks = chunks.contiguous()
    p = plan(layout)
    consts = _consts(layout, chunks.device)
    perm = _perm(layout, chunks.device)
    build.launch(_lib(), "t3_superframe_encode", chunks.device,
                 chunks.data_ptr(), n, layout.n_raw_words, p["units"],
                 p["smem"], None if perm is None else perm.data_ptr(),
                 consts.data_ptr(), out.data_ptr(), counter="t3.encode.k3")
    return out
