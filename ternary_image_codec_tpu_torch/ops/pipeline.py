"""Superframe stream pipeline for the PyTorch port.

The JAX package's ops/pipeline.py: RAW words <-> wire planes for every
``EncoderConfig`` the reference encodes: any UEP grouping, the sparse
beacon splice (any band, period 2..26) and P5's 2D interleave (any tile up
to 26x26, with or without a beacon).

Wire format (identical to the reference): a superframe is int8 wire planes
(9, 6 + H); words 0..5 carry the two RS(26,18) header blocks, words 6.. the
body, where band b's RS(26, k_b) codewords fill row b, block after block,
scrambled digit-wise; the cells past a band's last whole codeword carry
zero data.  With a beacon, rows r % p == 0 of the beacon band carry the
beacon symbol unscrambled and its codewords run down the other rows (its
own, smaller block count); H is then the least height that holds them, not
always a multiple of 26.  Under P5 the round-robin stream is interleaved
(ops/interleave.py) over the decoder's stream length before the band
split.

Device work is plain torch on integer tensors except the two kernels: the
check decode (K1, ops/dec_cuda.py) and the BM/Chien/Forney chain (K2,
ops/rs_cuda.py, reached through ``rs.correct_pm``).  Every constant is built
on the host once per layout (``derive_tables``) and held by
``SuperframeCodec`` as buffers.

Decode strategies of ``decode_stream_superframes``:

* ``check``: verify and extract; syndromes set per-superframe flags, headers
  byte-compare against the config's constant header words.
* ``paged``: the v2 page-compacted corrector: 16-block pages over the block
  count padded to a multiple of 16, capacity C = min(g*npage, max(6, g))
  pages per k-group of g bands, slot-gather merge; pages past capacity keep
  their data uncorrected with ok=False.  Headers go through the RS(26,18)
  paged chain.
* ``auto``: ``check``, then ``paged`` on the flagged superframes only (the
  flags go to the host between the phases).
* ``fused``: ``check``, then a stable argsort of the flags puts flagged
  superframes first, ``paged`` runs on a fixed window of ``repair_cap`` of
  them, the fixes scatter back, and ok fails safe when more than
  ``repair_cap`` superframes were flagged.  No host round trip.
  ``decode_frames_fused`` does the same over the superframes of F frames.
* ``full``: the BM/Chien/Forney chain (K2) on every block of every k-group,
  the block count padded to a multiple of 16 as the paged corrector pads
  it; ok covers every block.  Headers as for ``paged``.
* ``none``: no RS on the body (ok True); the data is extracted as ``check``
  extracts it (its flags dropped).  Headers as for ``paged``.

The check decode takes one of two routes, fixed by the layout
(``check_route``): K1 where the kernel covers the layout (no beacon, no
P5, one block count, whole codewords; any UEP grouping), else the grid
route, as the reference checks such layouts outside Pallas: on the card
K1's beacon and P5 specialisations where ``dec_cuda.covers`` the layout,
the plain torch grid check (``grid_check``) otherwise and on the CPU.
The beacon band is checked and repaired on its own chain (K2 on the card):
check reads its syndromes, paged repairs at most 4 of its 16-block pages a
superframe, full corrects every codeword.

The profile API (``encode_profile_from_raw``, ``decode_profile_to_raw``,
``decode_header_from_words``) codes one frame of any length as one
superframe whose header carries the config and the frame number.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..config import (BeaconPayload, EncoderConfig, NUM_BANDS, ProfileID,
                      SuperframeHeader, encode_beacon_symbol)
from ..runtime import tracing
from . import dec_cuda, header as header_mod, interleave, rs, scramble
from .gf27 import dig_to_sym, mod3, np_sym_to_dig, sym_to_dig

HEADER_WORDS = 6
HEADER_SYMS = 52                 # the 2 RS(26,18) header codewords
_PROFILE_KS = (24, 22, 20, 18)   # band_profile index 0..3 -> k
PAGE = 16                        # blocks per page of the paged corrector
SROWS = 8                        # one r=8 syndrome map serves every band
BEACON_PAGES = 4                 # dirty pages a superframe's beacon band repairs


def _band_k(uep_idx: int) -> int:
    return _PROFILE_KS[uep_idx % 4]


def _band_lens(n_sy: int) -> np.ndarray:
    """Round-robin band lengths: band b gets symbols b, b+9, b+18, ..."""
    b = np.arange(NUM_BANDS)
    return (n_sy - b + NUM_BANDS - 1) // NUM_BANDS


def _is_p5(profile, tile) -> bool:
    return profile == ProfileID.P5_RS26_22_2D and bool(tile.w and tile.h)


def _beacon_rows(H: int, period: int) -> np.ndarray:
    """Rows of the beacon band that carry the beacon symbol."""
    if period <= 0:
        return np.zeros(0, dtype=np.int64)
    return np.arange(0, H, period)


def _beacon_payload_rows(usable: int, period: int) -> np.ndarray:
    """Row of the j-th payload cell of the beacon band: r = j + j//(p-1)
    + 1 (rows with r % p == 0 carry the beacon)."""
    j = np.arange(usable, dtype=np.int64)
    if usable == 0:
        return j
    return j + j // (period - 1) + 1


@dataclasses.dataclass(frozen=True, eq=False)
class _GridGeom:
    """Body-grid geometry of one config and height H."""

    H: int
    ks: Tuple[int, ...]          # per-band RS k
    usable: Tuple[int, ...]      # payload capacity per band row
    blocks: Tuple[int, ...]      # full RS codewords per band row
    beacon_sym: int


def _grid_geom(uep, beacon, H: int, beacon_sym: int) -> _GridGeom:
    ks, usable, blocks = [], [], []
    n_beacon_rows = (-(-H // beacon.words_period)
                     if beacon.enabled and beacon.words_period > 0 else 0)
    for b in range(NUM_BANDS):
        ks.append(_band_k(uep.band_profile[b]))
        u = H - n_beacon_rows if (beacon.enabled
                                  and b == beacon.band_slot) else H
        usable.append(u)
        blocks.append(u // rs.N)
    return _GridGeom(H, tuple(ks), tuple(usable), tuple(blocks), beacon_sym)


@dataclasses.dataclass(frozen=True)
class KGroup:
    """Bands that share one RS code and one block count: the uniform
    bands of one k, or the beacon band on its own (its payload rows skip
    the beacon cells, so it has fewer blocks).  ``name`` keys its tables."""

    name: str
    k: int
    bands: Tuple[int, ...]
    nblk: int
    beacon: bool


def k_groups(geom: _GridGeom, beacon) -> list:
    """The body's RS groups: the bands other than the beacon band grouped
    by k, in first-band order with bands ascending (the reference's page
    order, pipeline.py:1036-1039), then the beacon band as its own group.
    Bands without a whole codeword join no group."""
    b0 = beacon.band_slot if beacon.enabled else -1
    by_k = {}
    for b in range(NUM_BANDS):
        if b != b0 and geom.blocks[b]:
            by_k.setdefault(geom.ks[b], []).append(b)
    out = [KGroup(f"k{k}", k, tuple(bands), geom.blocks[bands[0]], False)
           for k, bands in by_k.items()]
    if b0 >= 0 and geom.blocks[b0]:
        out.append(KGroup("beacon", geom.ks[b0], (b0,), geom.blocks[b0],
                          True))
    return out


def _stream_len(geom: _GridGeom) -> int:
    """Symbols of the round-robin stream that every band can supply:
    out[i] = band_data[i % 9][i // 9] exists while i // 9 < dlens[i % 9]."""
    return int(min(NUM_BANDS * geom.blocks[b] * geom.ks[b] + b
                   for b in range(NUM_BANDS)))


def _grid_blocks(H: int):
    """(nblk_p, nblk_g) of a body of H rows: a uniform band's whole
    codewords padded to whole 16-block pages (the blocks the syndrome
    check and the repairs of the uniform bands cover), and the blocks of
    the decode grid (enough for both H and nblk_p)."""
    nblk_p = max(-(-(H // rs.N) // PAGE) * PAGE, PAGE)
    return nblk_p, max(nblk_p, -(-H // rs.N))


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class EncodeLayout:
    cfg: EncoderConfig
    n_raw_words: int
    n_sy: int
    geom: _GridGeom
    header_words: np.ndarray     # (6, 9) int8
    total_words: int


@dataclasses.dataclass(frozen=True, eq=False)
class DecodeLayout:
    hdr: SuperframeHeader
    H: int
    geom: _GridGeom
    L_out: int
    n_out_words: int


def _encode_header_words(cfg: EncoderConfig, frame_seq: int = 0) -> np.ndarray:
    """The 6 constant header wire words: two systematic RS(26,18) blocks
    over the 27 header symbols (A = symbols 0..17, B = 18..26 + 9 zeros)."""
    syms = header_mod.pack(stream_header(cfg, frame_seq))
    A = np.zeros(18, dtype=np.int64)
    B = np.zeros(18, dtype=np.int64)
    A[:] = syms[:18]
    B[:9] = syms[18:27]
    out = np.zeros(HEADER_WORDS * NUM_BANDS, dtype=np.int8)
    out[:26] = rs.np_encode(A, 18)
    out[26:52] = rs.np_encode(B, 18)
    return out.reshape(HEADER_WORDS, NUM_BANDS)


def stream_header(cfg: EncoderConfig, frame_seq: int = 0) -> SuperframeHeader:
    return SuperframeHeader(
        profile=cfg.profile, uep=cfg.uep, tile=cfg.tile, seed=cfg.seed,
        beacon=cfg.beacon, subword=cfg.subword, centered=cfg.centered,
        coset=cfg.coset, frame_seq=frame_seq)


def _min_height(lens, uep, beacon) -> int:
    """Smallest H whose per-band capacity fits every band's codewords: the
    whole-codeword height, grown one row at a time while the beacon band's
    payload rows fall short."""
    need = [int(-(-lens[b] // _band_k(uep.band_profile[b])))
            for b in range(NUM_BANDS)]
    H = max((nb * rs.N for nb in need), default=0)
    if not beacon.enabled:
        return H
    if beacon.words_period == 1 and need[beacon.band_slot] > 0:
        # every row of the beacon band carries the beacon: no height fits
        raise ValueError(
            "beacon words_period=1 leaves the beacon band with zero "
            "payload capacity; use a period >= 2 or an empty stream")
    while True:
        g = _grid_geom(uep, beacon, H, 0)
        if all(g.blocks[b] >= need[b] for b in range(NUM_BANDS)):
            return H
        H += 1


@functools.cache
def build_encode_layout(cfg: EncoderConfig, n_raw_words: int,
                        frame_seq: int = 0) -> EncodeLayout:
    """The encode layout of one superframe of ``n_raw_words`` RAW words.
    Raises ValueError for what the header cannot carry: a beacon period
    outside 1..26 or a band slot outside 0..8, a P5 tile side above 26,
    a band profile P4."""
    if cfg.beacon.enabled:
        if not 0 < cfg.beacon.words_period <= 26:
            # the header stores min(period, 26)
            raise ValueError("beacon words_period must be in 1..26")
        if not 0 <= cfg.beacon.band_slot < NUM_BANDS:
            raise ValueError("beacon band_slot must be in 0..8")
    if _is_p5(cfg.profile, cfg.tile) and not (cfg.tile.w <= 26
                                              and cfg.tile.h <= 26):
        # the header stores each tile side mod 27, one symbol each
        raise ValueError("P5 tile dims must be 1..26 (one header symbol "
                         "each)")
    if any(bp % 4 == 3 for bp in cfg.uep.band_profile):
        # the header carries one trit per band: P4 (index 3) cannot travel
        raise ValueError(
            "UEP band profile 3 (P4) is not transportable in the superframe "
            "header (1 trit/band); use P1..P3 per band")
    n_sy = -(-26 * n_raw_words // 3)
    H = _min_height(_band_lens(n_sy), cfg.uep, cfg.beacon)
    bsym = encode_beacon_symbol(BeaconPayload(
        cfg.profile, cfg.superframe_words % 5, 0))
    geom = _grid_geom(cfg.uep, cfg.beacon, H, bsym)
    return EncodeLayout(cfg=cfg, n_raw_words=n_raw_words, n_sy=n_sy,
                        geom=geom,
                        header_words=_encode_header_words(cfg, frame_seq),
                        total_words=HEADER_WORDS + H)


@functools.cache
def build_decode_layout(hdr: SuperframeHeader, H: int) -> DecodeLayout:
    """The decode layout of a body of H rows under ``hdr``: the decoder
    never reads a beacon cell, so the beacon symbol is 0 here."""
    geom = _grid_geom(hdr.uep, hdr.beacon, H, 0)
    L_out = _stream_len(geom)
    return DecodeLayout(hdr=hdr, H=H, geom=geom, L_out=L_out,
                        n_out_words=(L_out * 3) // 26)


def stream_layouts(cfg: EncoderConfig, n_raw_words: int | None = None):
    """(EncodeLayout, DecodeLayout) of one superframe of ``cfg`` holding
    ``n_raw_words`` RAW words (default ``cfg.superframe_words``), its
    header at frame_seq 0.  The layouts and every table built from them do
    not depend on the frame number: the profile API writes it into the
    header words of each frame."""
    layout = build_encode_layout(
        cfg, cfg.superframe_words if n_raw_words is None else n_raw_words)
    dlayout = build_decode_layout(stream_header(cfg),
                                  layout.total_words - HEADER_WORDS)
    return layout, dlayout


@functools.cache
def _unpack702():
    """One 702-trit grid block (27 rows x 26 cols) -> 27 words x 9 symbols:
    C[r, i, w*9 + b] = 3^d where grid trit (r, i) is trit 3b+d of word w."""
    C = np.zeros((27, 26, 243), dtype=np.int8)
    for r in range(27):
        for i in range(26):
            w, t = divmod(27 * i + r, 26)
            b, d = divmod(t, 3)
            C[r, i, w * 9 + b] = 3 ** d
    return C


@functools.cache
def _unpack702_bw():
    """_unpack702 with the output axis in (band, word) order b*27 + w."""
    idx = np.arange(27 * NUM_BANDS)
    return _unpack702()[:, :, (idx % 27) * NUM_BANDS + idx // 27]


@functools.cache
def _stream702():
    """P5's assembly constant: one block of 234 stream symbols (702 trits)
    -> 27 words x 9 symbols.  K[d, i, b*27 + w] = 3^dd where stream trit
    3i + d is trit 3b + dd of word w of the block."""
    K = np.zeros((3, 234, 243), dtype=np.int8)
    for i in range(234):
        for d in range(3):
            w, t = divmod(3 * i + d, 26)
            b, dd = divmod(t, 3)
            K[d, i, b * 27 + w] = 3 ** dd
    return K


# ---------------------------------------------------------------------------
# tables: everything a codec holds, built on the host once per config
# ---------------------------------------------------------------------------


def chain_ks(cfg: EncoderConfig) -> tuple:
    """RS k values whose tables a codec of ``cfg`` holds: the header's 18
    and the body's."""
    layout, _ = stream_layouts(cfg)
    return tuple(sorted({18, *layout.geom.ks}))


def reference_inputs(cfg: EncoderConfig,
                     n_raw_words: int | None = None) -> dict:
    """The tables the JAX package exposes for ``cfg``'s superframe of
    ``n_raw_words`` RAW words (``stream_layouts``), derived here: ``rs_pm``
    {k: rs._matrices_pm(k)}, ``header_words`` (frame_seq 0), the descramble
    and scramble offset fields ``off_dec``/``off_enc`` (27, H), and the
    assembly constants ``unpack702_bw`` (27, 26, 243) and ``stream702``
    (3, 234, 243, read by P5 layouts only)."""
    layout, _ = stream_layouts(cfg, n_raw_words)
    H = layout.geom.H
    return {
        "rs_pm": {k: rs._matrices_pm(k) for k in chain_ks(cfg)},
        "header_words": layout.header_words,
        "off_enc": scramble.pm_offsets(H, cfg.seed, 1),
        "off_dec": scramble.pm_offsets(H, cfg.seed, -1),
        "unpack702_bw": _unpack702_bw(),
        "stream702": _stream702(),
    }


def _encode_gather(layout: EncodeLayout, grp: KGroup, blocks=None):
    """Source of every data digit of one group: (g, nblk, k, 3) indices
    into a superframe's flat RAW symbols (n*9, plus one zero slot at the
    end) and the power of 3 that selects the digit; with ``blocks`` (a
    range of block numbers), of those blocks only.  Data digit d of band
    b, block blk, coeff c is digit d of symbol i = 9*(blk*k + c) + b of the
    band stream; that is stream symbol s = i, or s = perm[i] under P5
    (interleaved over the decoder's stream length, zero past it); stream
    trit T = 3s + d is trit T % 26 of RAW word T // 26, zero past the
    words."""
    cfg, n = layout.cfg, layout.n_raw_words
    b = np.asarray(grp.bands)[:, None, None, None]
    blk = np.arange(grp.nblk) if blocks is None else np.asarray(blocks)
    blk = blk[None, :, None, None]
    c = np.arange(grp.k)[None, None, :, None]
    d = np.arange(3)[None, None, None, :]
    i = NUM_BANDS * (blk * grp.k + c) + b
    valid = np.ones(i.shape, dtype=bool)
    if _is_p5(cfg.profile, cfg.tile):
        L = _stream_len(layout.geom)
        p = interleave.perm(L, cfg.tile.w, cfg.tile.h)
        valid = i < L
        i = p[np.where(valid, i, 0)]
    T = 3 * i + d
    valid = valid & (T < 26 * n)
    w, t = np.divmod(T, 26)
    src = np.where(valid, w * NUM_BANDS + t // 3, n * NUM_BANDS)
    pw = np.where(valid, 3 ** (t % 3), 1)
    return src.astype(np.int64), pw.astype(np.int16)


def _data_rows(geom: _GridGeom, beacon, band, j):
    """Body row of data column j of ``band`` (arrays of one shape): the
    coefficient j % k of codeword j // k; the beacon band's codewords run
    down its payload rows."""
    ks = np.asarray(geom.ks)[band]
    h = (j // ks) * rs.N + j % ks
    if beacon.enabled:
        p = max(beacon.words_period - 1, 1)
        h = np.where(band == beacon.band_slot, h + h // p + 1, h)
    return h


def _decode_gather(dlayout: DecodeLayout, ref: dict):
    """(9, n_out, 3) indices into a superframe's flat decode grid (9 bands
    x 26*nblk_g rows x 3 digits, plus one zero slot): digit d of symbol b
    of output word w.  Read off the reference's assembly constants: without
    P5, grid trit (row 3*band + digit, col m*26 + i) is trit 3b+d of word
    m*27 + w when unpack702_bw[row, i, b*27 + w] == 3^d, col being the
    band's data column; under P5, stream trit 3i + digit of block m is trit
    3b+d of word m*27 + w when stream702[digit, i, b*27 + w] == 3^d, stream
    symbol m*234 + i is band stream symbol s = inv_perm[m*234 + i], and s
    is data column s // 9 of band s % 9."""
    hdr, geom, n_out = dlayout.hdr, dlayout.geom, dlayout.n_out_words
    Wg = rs.N * _grid_blocks(geom.H)[1]
    M = -(-n_out // 27)
    m = np.arange(M)[:, None]
    if _is_p5(hdr.profile, hdr.tile):
        K = np.asarray(ref["stream702"], dtype=np.int8)
        dig, i, q = np.nonzero(K)
        p3 = K[dig, i, q]
        s_out = m * 234 + i
        live = (m * 27 + q % 27) < n_out
        s = interleave.inv_perm(dlayout.L_out, hdr.tile.w, hdr.tile.h)[
            np.where(live, s_out, 0)]
        band, j = s % NUM_BANDS, s // NUM_BANDS
    else:
        C = np.asarray(ref["unpack702_bw"], dtype=np.int8)
        row, i, q = np.nonzero(C)
        p3 = C[row, i, q]
        band, dig = row // 3, row % 3
        j = m * 26 + i
        live = (m * 27 + q % 27) < n_out
        band = np.broadcast_to(band, j.shape)
    d = (p3 >= 3).astype(np.int64) + (p3 >= 9)              # 3^d -> d
    b, w = np.divmod(q, 27)
    W = m * 27 + w
    b, d, dig = (np.broadcast_to(a, W.shape) for a in (b, d, dig))
    ks = np.asarray(geom.ks)
    if np.any(j[live] >= (np.asarray(geom.blocks) * ks)[band[live]]):
        raise AssertionError("output word reads past a band's data")
    h = _data_rows(geom, hdr.beacon, band, j)
    src = np.full((NUM_BANDS, M * 27, 3), NUM_BANDS * Wg * 3, dtype=np.int64)
    src[b[live], W[live], d[live]] = ((band * Wg + h) * 3 + dig)[live]
    return src[:, :n_out]


def decode_tables(dlayout: DecodeLayout, ref: dict) -> dict:
    """The tables a body decode of ``dlayout`` reads, as numpy arrays,
    from the reference inputs (``rs_pm`` for 18 and the body's k values,
    ``off_dec``, ``unpack702_bw``, ``stream702``)."""
    geom, beacon = dlayout.geom, dlayout.hdr.beacon
    t = {}
    for k in sorted({18, *geom.ks}):
        for name in rs.PM_KEYS:
            t[f"rs{k}_{name}"] = np.asarray(ref["rs_pm"][k][name], np.int8)
    S2 = t["rs18_S2"].reshape(3, SROWS, 3, rs.N)           # [d', j, d, i]
    # r=8 syndrome map on a block's digits flattened (i, d), rows d'*8 + j
    t["S8"] = np.ascontiguousarray(
        S2.transpose(0, 1, 3, 2).reshape(3 * SROWS, 3 * rs.N))
    # the uniform bands' syndrome rows; the beacon band is checked apart
    rmask = np.zeros((NUM_BANDS, SROWS), dtype=bool)
    for grp in k_groups(geom, beacon):
        if not grp.beacon:
            rmask[list(grp.bands), :rs.N - grp.k] = True
    t["rmask"] = rmask
    if beacon.enabled:
        b0 = beacon.band_slot
        # the payload rows of the beacon band's whole codewords
        t["bc_pay"] = _beacon_payload_rows(geom.usable[b0],
                                           beacon.words_period)[
            :geom.blocks[b0] * rs.N]
    t["off_dec"] = np.asarray(ref["off_dec"]).astype(np.int8)
    t["dec_src"] = _decode_gather(dlayout, ref)
    return t


def parity_map(G2: np.ndarray, k: int) -> np.ndarray:
    """RS(26, k)'s parity as a GF(3)-linear map from a block's data digits
    flattened (c, d) to its parity digits (c', d'), (3k, 3(26-k)) int8,
    from the generator map ``G2`` ((3*26, 3*k), rows [d', c'], columns
    [d, c])."""
    G2 = np.asarray(G2).reshape(3, rs.N, 3, k)              # [d', c', d, c]
    return np.ascontiguousarray(
        G2[:, k:].transpose(3, 2, 1, 0).reshape(3 * k, 3 * (rs.N - k)))


def derive_tables(cfg: EncoderConfig, ref: dict,
                  n_raw_words: int | None = None) -> dict:
    """Every table a ``SuperframeCodec`` holds, as numpy arrays, from the
    reference inputs (``reference_inputs`` layout) and the layout
    (``stream_layouts(cfg, n_raw_words)``): the decode tables
    (``decode_tables``) and the encoder's."""
    layout, dlayout = stream_layouts(cfg, n_raw_words)
    geom, beacon = layout.geom, cfg.beacon
    t = decode_tables(dlayout, ref)
    groups = k_groups(geom, beacon)
    for k in sorted({grp.k for grp in groups}):
        t[f"par{k}"] = parity_map(t[f"rs{k}_G2"], k)
    for grp in groups:
        t[f"enc_src_{grp.name}"], t[f"enc_pow_{grp.name}"] = \
            _encode_gather(layout, grp)
    if beacon.enabled:
        t["bc_rows"] = _beacon_rows(geom.H, beacon.words_period)
        t["bc_sym"] = np_sym_to_dig(np.asarray(geom.beacon_sym)) \
            .astype(np.int8)                                # (3,)
    hw = np.asarray(ref["header_words"], dtype=np.int8)
    t["header_words"] = hw
    flat = hw.reshape(-1).astype(np.int64)
    # systematic header blocks: their data is the first 18 symbols
    t["hdr_exp"] = np.stack([np_sym_to_dig(flat[:18]).T,
                             np_sym_to_dig(flat[26:44]).T],
                            axis=1).astype(np.int8)         # (3, 2, 18)
    t["off_enc"] = np.asarray(ref["off_enc"]).astype(np.int8)
    return t


# ---------------------------------------------------------------------------
# body decode on a digit grid
# ---------------------------------------------------------------------------


def descramble_grid(body: torch.Tensor, T: dict, pad_cols: int = 0):
    """Wire body (n, 9, H) -> descrambled digit grid (n, 9, H + pad_cols, 3)
    int8; padded cells are zero (a valid codeword)."""
    H = body.shape[-1]
    off = T["off_dec"].reshape(NUM_BANDS, 3, H).transpose(1, 2)   # (9, H, 3)
    grid = mod3(sym_to_dig(body).to(torch.int16) + off).to(torch.int8)
    if pad_cols:
        grid = torch.nn.functional.pad(grid, (0, 0, 0, pad_cols))
    return grid


def decode_grid(body: torch.Tensor, T: dict) -> torch.Tensor:
    """Wire body (n, 9, H) -> the decode grid (n, 9, 26*nblk_g, 3): the
    descrambled digits, zero past H (``_grid_blocks``).  ``dec_src``
    indexes this grid."""
    H = body.shape[-1]
    return descramble_grid(body, T, rs.N * _grid_blocks(H)[1] - H)


def block_syndromes(blocks: torch.Tensor, T: dict) -> torch.Tensor:
    """Codeword digits (..., 26, 3) -> r=8 syndromes (..., 3, 8) int8
    (row [d', j]: digit d' of S_j; an RS(26, k) code checks j < 26 - k)."""
    lead = blocks.shape[:-2]
    x = blocks.reshape(-1, 3 * rs.N).to(torch.float32)
    S = torch.matmul(x, T["S8"].to(torch.float32).T)
    return mod3(S.to(torch.int32)).to(torch.int8).reshape(*lead, 3, SROWS)


def grid_syndromes(grid: torch.Tensor, T: dict) -> torch.Tensor:
    """Digit grid (n, 9, 26*nb, 3) -> r=8 syndromes (n, 9, nb, 3, 8) int8."""
    n, nb = grid.shape[0], grid.shape[2] // rs.N
    return block_syndromes(grid.view(n, NUM_BANDS, nb, rs.N, 3), T)


def assemble_words(grid: torch.Tensor, T: dict) -> torch.Tensor:
    """Decode grid (n, 9, 26*nblk_g, 3) -> RAW planes (n, 9, n_out) int8."""
    n = grid.shape[0]
    flat = torch.nn.functional.pad(grid.reshape(n, -1), (0, 1))
    src = T["dec_src"]
    g = flat[:, src.reshape(-1)].reshape(n, *src.shape).to(torch.int16)
    return (g[..., 0] + 3 * g[..., 1] + 9 * g[..., 2]).to(torch.int8)


def _uniform_flags(grid: torch.Tensor, H: int, T: dict) -> torch.Tensor:
    """Decode grid -> (n,) bool: a nonzero syndrome in a uniform band's
    first nblk_p blocks (its r rows; the partial block past the last
    whole codeword and the page padding included, as the reference's
    grid check reads them)."""
    nblk_p = _grid_blocks(H)[0]
    S = grid_syndromes(grid, T)[:, :, :nblk_p]           # (n, 9, nblk_p, 3, 8)
    return ((S != 0) & T["rmask"][None, :, None, None, :]).flatten(1).any(-1)


def _beacon_blocks(grid: torch.Tensor, grp: KGroup, T: dict) -> torch.Tensor:
    """The beacon band's whole codewords (n, nblk, 26, 3), read down its
    payload rows (the beacon cells are never read)."""
    n = grid.shape[0]
    return grid[:, grp.bands[0], T["bc_pay"]].reshape(n, grp.nblk, rs.N, 3)


def _beacon_put(grid: torch.Tensor, grp: KGroup, T: dict, data):
    """Write the beacon band's data digits (n, nblk, k, 3) back to its
    payload rows."""
    rows = T["bc_pay"].view(grp.nblk, rs.N)[:, :grp.k].reshape(-1)
    grid[:, grp.bands[0], rows] = data.reshape(grid.shape[0], -1, 3)


def _beacon_dirty(blocks: torch.Tensor, k: int, T: dict) -> torch.Tensor:
    """(n, B, 26, 3) -> (n, B) bool: a nonzero syndrome among the r rows."""
    return (block_syndromes(blocks, T)[..., :rs.N - k] != 0).flatten(-2) \
        .any(-1)


def beacon_paged(blocks: torch.Tensor, k: int, T: dict):
    """The beacon band's paged repair, per superframe: blocks (n, B, 26, 3)
    -> (data (n, B, k, 3), ok (n, B)).  Each superframe is the
    reference's ``decode_paged_pm_bk(page=16, max_dirty_pages=4)`` of its
    own blocks: 16-block pages (the last padded with zero blocks), the
    first ``BEACON_PAGES`` dirty pages of that superframe repaired, the
    dirty pages past them kept as they are with ok False.  The repairs of
    all n superframes run as one chain (``rs.correct_pages``)."""
    n, B = blocks.shape[:2]
    npage = -(-B // PAGE)
    rd = torch.nn.functional.pad(blocks, (0, 0, 0, 0, 0, npage * PAGE - B))
    dirty = _beacon_dirty(rd, k, T).view(n, npage, PAGE)
    data, ok = rs.correct_pages(rd.view(n, npage, PAGE, rs.N, 3), dirty, k,
                                min(BEACON_PAGES, npage), _rs_maps(T, k))
    return (data.view(n, npage * PAGE, k, 3)[:, :B],
            ok.view(n, -1)[:, :B])


def check_route(dlayout: DecodeLayout) -> str:
    """How the check decode runs for this layout: "k1" where the K1 kernel
    covers it (``dec_cuda.supported``: no beacon, no P5, one block count,
    whole codewords), else "grid", the counterpart of the reference's XLA
    check: ``grid_check``, or on the card K1's beacon and P5
    specialisations where ``dec_cuda.covers`` the layout."""
    return "k1" if dec_cuda.supported(dlayout) else "grid"


def grid_check(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """Plain torch check decode of any layout, on any device: descramble,
    the syndromes of every uniform band's first nblk_p blocks and of the
    beacon band's whole codewords, and the gather assembly.
    (n, 9, H) -> (RAW planes (n, 9, n_out), ok (n,))."""
    grid = decode_grid(body, T)
    bad = _uniform_flags(grid, dlayout.H, T)
    for grp in k_groups(dlayout.geom, dlayout.hdr.beacon):
        if grp.beacon:
            bad = bad | _beacon_dirty(_beacon_blocks(grid, grp, T), grp.k,
                                      T).any(-1)
    return assemble_words(grid, T), ~bad


def _runs_k1(body: torch.Tensor, dlayout: DecodeLayout) -> bool:
    """True when ``check_body`` runs K1 (or on the CPU its plain twin)
    rather than ``grid_check``: the K1 route, or a CUDA tensor of a grid
    route layout that ``dec_cuda.covers``."""
    return check_route(dlayout) == "k1" or (body.device.type == "cuda"
                                            and dec_cuda.covers(dlayout))


def check_body(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """Check decode: (n, 9, H) -> (RAW planes (n, 9, n_out), ok (n,)).
    On the K1 route a CUDA tensor runs the kernel and a CPU tensor its
    plain twin; on the grid route a CUDA tensor runs the kernel where
    ``dec_cuda.covers`` the layout, else ``grid_check`` runs."""
    grid = check_route(dlayout) == "grid"
    with tracing.span("t3.check.grid" if grid else "t3.check.k1"):
        if not _runs_k1(body, dlayout):
            return grid_check(body, dlayout, T)
        if body.device.type == "cuda":
            return dec_cuda.check_decode(body, dlayout)
        if body.device.type == "cpu":
            return dec_cuda.check_decode_ref(body, T)
    raise ValueError(f"check decode: unsupported device {body.device}")


def paged_body(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """Paged-repair decode (the reference's v2 paged corrector):
    (n, 9, H) -> (RAW planes (n, 9, n_out), ok (n,)).  The uniform bands
    of each k-group share C = min(g*npage, max(6, g)) dirty pages a
    superframe; the beacon band has its own chain (``beacon_paged``)."""
    with tracing.span("t3.repair.paged"):
        geom = dlayout.geom
        n = body.shape[0]
        nblk_p, nblk_g = _grid_blocks(geom.H)
        npage = nblk_p // PAGE
        grid = decode_grid(body, T)                      # (n, 9, Hg, 3)
        gv = grid.view(n, NUM_BANDS, nblk_g, rs.N, 3)
        S_all = block_syndromes(gv[:, :, :nblk_p], T)    # (n, 9, nblk_p, 3, 8)
        ok = torch.ones(n, dtype=torch.bool, device=body.device)
        for grp in k_groups(geom, dlayout.hdr.beacon):
            k = grp.k
            if grp.beacon:
                data, ok_b = beacon_paged(_beacon_blocks(grid, grp, T), k, T)
                _beacon_put(grid, grp, T, data)
                ok = ok & ok_b.all(-1)
                continue
            r, g = rs.N - k, len(grp.bands)
            bidx = torch.as_tensor(grp.bands, device=body.device)
            dirty = (S_all[:, bidx, :, :, :r] != 0).flatten(3).any(-1) \
                .view(n, g * npage, PAGE)
            data, okb = rs.correct_pages(
                gv[:, bidx, :nblk_p].reshape(n, g * npage, PAGE, rs.N, 3),
                dirty, k, min(g * npage, max(6, g)), _rs_maps(T, k))
            gv[:, bidx, :nblk_p, :k] = data.view(n, g, nblk_p, k, 3)
            ok = ok & okb.flatten(1).all(-1)
        return assemble_words(grid, T), ok


def full_body(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """Full-correction decode (the reference's rs_mode="full",
    pipeline_v3.py:1358-1386 and pipeline.py:1186-1194): the BM/Chien/
    Forney chain on every block of every uniform k-group, the block count
    padded with zero blocks to the paged corrector's 16-block multiple,
    and on every whole codeword of the beacon band; ok covers every block,
    the padding (always clean) included.  (n, 9, H) -> (RAW planes
    (n, 9, n_out), ok (n,))."""
    geom = dlayout.geom
    n = body.shape[0]
    nblk_p, nblk_g = _grid_blocks(geom.H)
    grid = decode_grid(body, T)                          # (n, 9, Hg, 3)
    gv = grid.view(n, NUM_BANDS, nblk_g, rs.N, 3)
    ok = torch.ones(n, dtype=torch.bool, device=body.device)
    for grp in k_groups(geom, dlayout.hdr.beacon):
        k, g = grp.k, len(grp.bands)
        if grp.beacon:
            d_c, ok_c = rs.correct_pm(rs.blocks_pm(_beacon_blocks(grid, grp,
                                                                   T)),
                                      k, _rs_maps(T, k))
            _beacon_put(grid, grp, T, rs.pm_blocks(d_c, (n, grp.nblk)))
            ok = ok & ok_c.view(n, -1).all(-1)
            continue
        bidx = torch.as_tensor(grp.bands, device=body.device)
        d_c, ok_c = rs.correct_pm(rs.blocks_pm(gv[:, bidx, :nblk_p]), k,
                                  _rs_maps(T, k))
        gv[:, bidx, :nblk_p, :k] = rs.pm_blocks(d_c, (n, g, nblk_p))
        ok = ok & ok_c.view(n, -1).all(-1)
    return assemble_words(grid, T), ok


def none_body(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """No RS on the body (the reference's rs_mode="none"): the data as
    ``check_body`` extracts it, ok True.  (n, 9, H) -> (RAW planes
    (n, 9, n_out), ok (n,))."""
    if _runs_k1(body, dlayout):
        out, _flags = check_body(body, dlayout, T)
    else:
        out = assemble_words(decode_grid(body, T), T)
    return out, torch.ones(body.shape[0], dtype=torch.bool, device=body.device)


# body decoder of each rs_mode: (n, 9, H) -> (RAW planes, ok (n,))
BODY_DECODERS = {"check": check_body, "paged": paged_body, "full": full_body,
                 "none": none_body}


def body_decoder(rs_mode: str):
    if rs_mode not in BODY_DECODERS:
        raise ValueError(f"unknown rs_mode {rs_mode!r}; one of "
                         f"{sorted(BODY_DECODERS)}")
    return BODY_DECODERS[rs_mode]


def _rs_maps(T: dict, k: int) -> dict:
    return {name: T[f"rs{k}_{name}"] for name in rs.PM_KEYS}


def header_validator(T: dict, rs_mode: str, hdr_all_pages: bool = False):
    """validate(hdrs (n, 9, 6) wire slabs) -> (n,) bool.

    check mode: byte-compare with the config's constant header words.
    Other modes: RS(26,18) paged decode of both header blocks (64-block
    pages; every page when ``hdr_all_pages``, else the sparse default
    capacity) and a match of the corrected data with the config's."""
    if rs_mode == "check":
        def validate(hdrs):
            return (hdrs == T["header_words"].T).flatten(1).all(-1)
        return validate

    def validate(hdrs):
        with tracing.span("t3.repair.header"):
            n = hdrs.shape[0]
            sy = hdrs.transpose(1, 2).reshape(n, HEADER_WORDS * NUM_BANDS)
            blocks = torch.cat([sy[:, :26], sy[:, 26:52]], dim=0)  # (2n, 26)
            dig = sym_to_dig(blocks, dim=0)                     # (3, 2n, 26)
            npage_h = -(-dig.shape[1] // 64)
            hdr_dig, ok_h = rs.decode_paged_pm_bk(
                dig, 18, page=64,
                max_dirty_pages=npage_h if hdr_all_pages else None,
                maps=_rs_maps(T, 18))
            exp = T["hdr_exp"][:, :, None, :].expand(3, 2, n, 18) \
                .reshape(3, 2 * n, 18)
            match = (hdr_dig == exp).all(-1).all(0)
            return (ok_h & match).reshape(2, n).all(0)
    return validate


# ---------------------------------------------------------------------------
# stream API
# ---------------------------------------------------------------------------


def _codec(cfg: EncoderConfig, device, n_raw_words: int | None = None):
    """The codec of ``cfg`` on ``device``: None is the current CUDA device
    and raises without one; the CPU only when the caller passes it."""
    from ..codec import codec_for
    return codec_for(cfg, device, n_raw_words)


def encode_stream_superframes(raw_words, cfg: EncoderConfig,
                              sf_batch: int = 64, device=None):
    """RAW words (n, 9) -> profile words (n_sf, total_words, 9), one
    superframe per ``cfg.superframe_words`` RAW words (the tail superframe
    is zero-padded).  Runs on ``device``, by default the current CUDA
    device; the input moves there."""
    codec = _codec(cfg, device)
    raw = torch.as_tensor(raw_words).to(codec.device)
    n = int(raw.shape[0])
    sf = cfg.superframe_words
    n_sf = -(-n // sf)
    raw = torch.nn.functional.pad(raw, (0, 0, 0, n_sf * sf - n))
    words_T = codec.encode(raw.reshape(n_sf, sf, NUM_BANDS),
                           sf_batch=sf_batch)
    return words_T.transpose(1, 2)


def decode_stream_superframes(words, cfg: EncoderConfig, n_raw: int,
                              sf_batch: int = 64, strategy: str = "auto",
                              repair_cap: int | None = None, device=None):
    """Profile words (n_sf, total_words, 9) -> (RAW words (n_raw, 9), ok).

    ``ok`` is a 0-d bool tensor on the device.  ``strategy`` is one of
    check, paged, auto, fused, full, none (see the module docstring).
    ``repair_cap`` is the fused strategy's window (default ``sf_batch``); a
    value <= 0 raises.  (The JAX package treats 0 as unset; the port
    rejects it.)  ``device`` as for ``encode_stream_superframes``."""
    codec = _codec(cfg, device)
    words_T = torch.as_tensor(words).to(codec.device).transpose(1, 2)
    raw_T, ok = codec.decode(words_T, strategy=strategy,
                             repair_cap=repair_cap, sf_batch=sf_batch)
    raw = raw_T[:, :, :cfg.superframe_words].transpose(1, 2) \
        .reshape(-1, NUM_BANDS)[:n_raw]
    return raw, ok


def decode_frames_fused(words, cfg: EncoderConfig, sf_batch: int = 64,
                        repair_cap: int | None = None, wire: str = "words",
                        device=None):
    """The fused decode of F frames at once: wire words (F, n_sf, total, 9)
    (``wire="words"``) or planes (F, n_sf, 9, total) (``wire="planes"``)
    -> (RAW planes (F, n_sf, 9, n_out), ok 0-d bool).  One check over all
    F * n_sf superframes, one repair window of ``repair_cap`` (default
    ``sf_batch``) over the flagged ones of every frame; ok fails safe when
    more were flagged (``SuperframeCodec.decode_frames``).  ``device`` as
    for ``encode_stream_superframes``."""
    if wire not in ("words", "planes"):
        raise ValueError(f"wire must be 'words' or 'planes', got {wire!r}")
    codec = _codec(cfg, device)
    words = torch.as_tensor(words).to(codec.device)
    if wire == "words":
        words = words.transpose(2, 3)
    return codec.decode_frames(words, repair_cap=repair_cap,
                               sf_batch=sf_batch)


def roundtrip_stream(chunks, cfg: EncoderConfig, sf_batch: int = 64,
                     rs_mode: str = "check", fold=None, device=None,
                     raw_wire: str = "words", feed=None):
    """Encode and decode a superframe stream in one pass (the write-verify
    scrub): chunks (n_sf, superframe_words, 9), or (n_sf, 9,
    superframe_words) RAW planes when ``raw_wire="planes"`` -> (RAW planes
    (n_sf, 9, n_out), ok (n_sf,)), ok including the header check.
    ``rs_mode`` is the body decode: check, paged, full or none.

    ``fold`` reduces each micro-batch of decoded planes (b, 9, n_out) to a
    per-superframe result (b, ...) inside the pass, so the full planes are
    never kept; the call then returns (folded (n_sf, ...), ok).

    ``feed=(src, make)`` builds the input inside the pass: ``chunks`` is
    then a tensor or a tuple of tensors of per-superframe rows (leading
    axis n_sf), and each micro-batch's chunks are ``make(src, *rows)`` of
    its b rows (b chunks in the ``raw_wire`` layout), so a frame's RAW
    words never exist whole.  (The reference's ``make`` builds one
    superframe under vmap; here it builds a micro-batch.)
    ``device`` as for ``encode_stream_superframes``."""
    codec = _codec(cfg, device)
    move = lambda a: torch.as_tensor(a).to(codec.device)
    if feed is not None:
        src, make = feed
        rows = tuple(map(move, chunks if isinstance(chunks, (tuple, list))
                         else (chunks,)))
        return codec.roundtrip(rows, rs_mode=rs_mode, fold=fold,
                               sf_batch=sf_batch, raw_wire=raw_wire,
                               feed=(move(src), make))
    return codec.roundtrip(move(chunks), rs_mode=rs_mode, fold=fold,
                           sf_batch=sf_batch, raw_wire=raw_wire)


# ---------------------------------------------------------------------------
# profile API: one frame of any length as one superframe
# ---------------------------------------------------------------------------


def encode_profile_from_raw(raw_words, cfg: EncoderConfig, frame_seq: int = 0,
                            device=None):
    """RAW words (n, 9) -> profile words (6 + H, 9) int8: the header
    (``cfg`` and ``frame_seq``) and the RS-coded body of one superframe of
    n words.  RAW_MODE passes the words through unchanged
    (old/.../v6_min.hpp:1045-1049).  ``device`` as for
    ``encode_stream_superframes``."""
    from ..codec import resolve_device
    raw = torch.as_tensor(raw_words).to(resolve_device(device))
    if cfg.profile == ProfileID.RAW_MODE:
        return raw
    if raw.dim() != 2 or raw.shape[0] == 0 or raw.shape[1] != NUM_BANDS:
        raise ValueError(f"need RAW words (n >= 1, 9), got {tuple(raw.shape)}")
    codec = _codec(cfg, raw.device, int(raw.shape[0]))
    words = codec.encode(raw[None])[0].T
    words[:HEADER_WORDS] = torch.as_tensor(
        _encode_header_words(cfg, frame_seq), device=words.device)
    return words


def decode_header_from_words(words, device=None):
    """First 6 profile words -> (SuperframeHeader, True), or (None, False)
    when there are fewer, a header block is beyond repair or the CRC-12
    fails (old/.../v6_min.hpp:918-937): the 2 RS(26,18) header blocks are
    decoded by ``rs.decode_dig`` (K2 on the card), then checked and
    unpacked on the host.  ``device`` as for ``encode_stream_superframes``."""
    from ..codec import resolve_device
    w = torch.as_tensor(words).to(resolve_device(device))
    if w.shape[0] < HEADER_WORDS:
        return None, False
    blocks = w[:HEADER_WORDS].reshape(-1)[:HEADER_SYMS].view(2, rs.N)
    data, ok = rs.decode_dig(sym_to_dig(blocks), 18)        # (2, 18, 3)
    if not bool(ok.all()):
        return None, False
    syms = dig_to_sym(data).cpu().numpy()
    hdr_syms = np.concatenate([syms[0, :18], syms[1, :9]])
    if not header_mod.check(hdr_syms):
        return None, False
    return header_mod.unpack(hdr_syms), True


def header_config(hdr: SuperframeHeader) -> EncoderConfig:
    """The encoder config a header describes."""
    return EncoderConfig(profile=hdr.profile, uep=hdr.uep, tile=hdr.tile,
                         seed=hdr.seed, beacon=hdr.beacon, subword=hdr.subword,
                         centered=hdr.centered, coset=hdr.coset)


@functools.lru_cache(maxsize=16)
def _body_decoder_tables(cfg: EncoderConfig, H: int, device: torch.device):
    """(DecodeLayout, tables) of a body of H rows under ``cfg``'s header,
    for bodies no encoder of ``cfg`` writes at that height (a truncated or
    padded profile)."""
    dlayout = build_decode_layout(stream_header(cfg), H)
    ref = {"rs_pm": {k: rs._matrices_pm(k)
                     for k in sorted({18, *dlayout.geom.ks})},
           "off_dec": scramble.pm_offsets(H, cfg.seed, -1),
           "unpack702_bw": _unpack702_bw(), "stream702": _stream702()}
    return dlayout, {name: torch.as_tensor(np.ascontiguousarray(a),
                                           device=device)
                     for name, a in decode_tables(dlayout, ref).items()}


def decode_profile_to_raw(words, raw_mode: bool = False, device=None):
    """Profile words (6 + H, 9) -> (RAW words (n_out, 9), header, ok bool),
    or (None, None, False) when the header does not decode
    (old/.../v6_min.hpp:995-1041).  The body's layout comes from the header
    read off the words and from H; it is decoded by the paged corrector
    (the reference's default).  ``raw_mode`` passes the words through.
    ``device`` as for ``encode_stream_superframes``."""
    from ..codec import resolve_device
    w = torch.as_tensor(words).to(resolve_device(device))
    if raw_mode:
        return w, None, True
    hdr, ok = decode_header_from_words(w, device=w.device)
    if not ok:
        return None, None, False
    H = int(w.shape[0]) - HEADER_WORDS
    cfg = header_config(hdr)
    # the codec of the n_out words a body of H rows holds decodes it when
    # its encoder writes that height (always for an encoded profile)
    n_out = build_decode_layout(stream_header(cfg), H).n_out_words
    codec = _codec(cfg, w.device, n_out)
    if codec.dlayout.geom.H == H:
        dlayout, T = codec.dlayout, codec.tables()
    else:
        dlayout, T = _body_decoder_tables(cfg, H, w.device)
    body = w[HEADER_WORDS:].to(torch.int8).T.contiguous()[None]
    raw, body_ok = paged_body(body, dlayout, T)
    return raw[0].T, hdr, bool(body_ok[0])
