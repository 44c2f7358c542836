"""Superframe stream pipeline for the PyTorch port.

The main path of the JAX package's ops/pipeline.py: RAW words <-> wire
planes for the no-beacon, non-P5 configs whose UEP k-groups are residue
classes of the band index mod 3 (uniform UEP and ``uep_luma_priority``).
Anything else raises ``NotImplementedError``.

Wire format (identical to the reference): a superframe is int8 wire planes
(9, 6 + H); words 0..5 carry the two RS(26,18) header blocks, words 6.. the
body, where band b's RS(26, k_b) codewords fill row b, block after block
(H = 26 * nblk), scrambled digit-wise.

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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..config import (BeaconPayload, EncoderConfig, NUM_BANDS, ProfileID,
                      SuperframeHeader, encode_beacon_symbol)
from . import dec_cuda, header as header_mod, rs, scramble
from .gf27 import mod3, np_sym_to_dig, sym_to_dig

HEADER_WORDS = 6
_PROFILE_KS = (24, 22, 20, 18)   # band_profile index 0..3 -> k
PAGE = 16                        # blocks per page of the paged corrector
SROWS = 8                        # one r=8 syndrome map serves every band


def _band_k(uep_idx: int) -> int:
    return _PROFILE_KS[uep_idx % 4]


def _band_lens(n_sy: int) -> np.ndarray:
    """Round-robin band lengths: band b gets symbols b, b+9, b+18, ..."""
    b = np.arange(NUM_BANDS)
    return (n_sy - b + NUM_BANDS - 1) // NUM_BANDS


def _is_p5(profile, tile) -> bool:
    return profile == ProfileID.P5_RS26_22_2D and bool(tile.w and tile.h)


def _require_main_path(beacon, profile, tile):
    if beacon.enabled:
        raise NotImplementedError("beacon configs are not ported yet")
    if _is_p5(profile, tile):
        raise NotImplementedError("P5 (2D interleave) is not ported yet")


@dataclasses.dataclass(frozen=True, eq=False)
class _GridGeom:
    """Body-grid geometry of one config and height H."""

    H: int
    ks: Tuple[int, ...]          # per-band RS k
    usable: Tuple[int, ...]      # payload capacity per band row
    blocks: Tuple[int, ...]      # full RS codewords per band row
    beacon_sym: int


def _grid_geom(uep, beacon, H: int, beacon_sym: int) -> _GridGeom:
    if beacon.enabled:
        raise NotImplementedError("beacon configs are not ported yet")
    ks = tuple(_band_k(uep.band_profile[b]) for b in range(NUM_BANDS))
    return _GridGeom(H, ks, (H,) * NUM_BANDS, (H // rs.N,) * NUM_BANDS,
                     beacon_sym)


def _residue_groups(by_k, blocks):
    """[(k, v_lo, v_hi)] when the k-groups partition the 9 bands into
    contiguous residue classes mod 3 with equal block counts, else None."""
    if sorted(b for bands in by_k.values() for b in bands) != list(range(9)):
        return None
    if len({blocks[b] for b in range(9)}) != 1:
        return None
    out = []
    for k, bands in by_k.items():
        vs = sorted({b % 3 for b in bands})
        if vs != list(range(vs[0], vs[-1] + 1)):
            return None
        if sorted(bands) != sorted(3 * u + v for u in range(3) for v in vs):
            return None
        out.append((k, vs[0], vs[-1] + 1))
    out.sort(key=lambda t: t[1])
    if [v for _k, lo, hi in out for v in range(lo, hi)] != [0, 1, 2]:
        return None
    return out


def k_groups(geom: _GridGeom) -> dict:
    """{k: [bands]} in first-band order, bands ascending (the reference's
    page order); raises unless the groups are residue classes."""
    by_k = {}
    for b in range(NUM_BANDS):
        if geom.blocks[b]:
            by_k.setdefault(geom.ks[b], []).append(b)
    if _residue_groups(by_k, geom.blocks) is None:
        raise NotImplementedError(
            "only UEP layouts whose k-groups are residue classes mod 3 are "
            "ported (uniform UEP, uep_luma_priority)")
    return by_k


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


@functools.cache
def build_encode_layout(cfg: EncoderConfig, n_raw_words: int,
                        frame_seq: int = 0) -> EncodeLayout:
    _require_main_path(cfg.beacon, cfg.profile, cfg.tile)
    if any(bp % 4 == 3 for bp in cfg.uep.band_profile):
        # the header carries one trit per band: P4 (index 3) cannot travel
        raise ValueError(
            "UEP band profile 3 (P4) is not transportable in the superframe "
            "header (1 trit/band); use P1..P3 per band")
    n_sy = -(-26 * n_raw_words // 3)
    lens = _band_lens(n_sy)
    need = [int(-(-lens[b] // _band_k(cfg.uep.band_profile[b])))
            for b in range(NUM_BANDS)]
    H = max(nb * rs.N for nb in need)
    bsym = encode_beacon_symbol(BeaconPayload(
        cfg.profile, cfg.superframe_words % 5, 0))
    geom = _grid_geom(cfg.uep, cfg.beacon, H, bsym)
    return EncodeLayout(cfg=cfg, n_raw_words=n_raw_words, n_sy=n_sy,
                        geom=geom,
                        header_words=_encode_header_words(cfg, frame_seq),
                        total_words=HEADER_WORDS + H)


@functools.cache
def build_decode_layout(hdr: SuperframeHeader, H: int) -> DecodeLayout:
    _require_main_path(hdr.beacon, hdr.profile, hdr.tile)
    geom = _grid_geom(hdr.uep, hdr.beacon, H, 0)
    dlens = [geom.blocks[b] * geom.ks[b] for b in range(NUM_BANDS)]
    # out[i] = band_data[i % 9][i // 9] exists while i // 9 < dlens[i % 9]
    L_out = int(min(9 * dlens[b] + b for b in range(NUM_BANDS)))
    return DecodeLayout(hdr=hdr, H=H, geom=geom, L_out=L_out,
                        n_out_words=(L_out * 3) // 26)


@functools.cache
def stream_layouts(cfg: EncoderConfig):
    """(EncodeLayout, DecodeLayout) of one superframe of ``cfg``."""
    layout = build_encode_layout(cfg, cfg.superframe_words)
    dlayout = build_decode_layout(stream_header(cfg),
                                  layout.total_words - HEADER_WORDS)
    k_groups(layout.geom)          # raises for UEP layouts not ported yet
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


# ---------------------------------------------------------------------------
# tables: everything a codec holds, built on the host once per config
# ---------------------------------------------------------------------------


def chain_ks(cfg: EncoderConfig) -> tuple:
    """RS k values whose tables a codec of ``cfg`` holds: the header's 18
    and the body's."""
    layout, _ = stream_layouts(cfg)
    return tuple(sorted({18, *layout.geom.ks}))


def reference_inputs(cfg: EncoderConfig) -> dict:
    """The tables the JAX package exposes for ``cfg``, derived here:
    ``rs_pm`` {k: rs._matrices_pm(k)}, ``header_words``, the descramble and
    scramble offset fields ``off_dec``/``off_enc`` (27, H) and
    ``unpack702_bw`` (27, 26, 243)."""
    layout, _ = stream_layouts(cfg)
    H = layout.geom.H
    return {
        "rs_pm": {k: rs._matrices_pm(k) for k in chain_ks(cfg)},
        "header_words": layout.header_words,
        "off_enc": scramble.pm_offsets(H, cfg.seed, 1),
        "off_dec": scramble.pm_offsets(H, cfg.seed, -1),
        "unpack702_bw": _unpack702_bw(),
    }


def _encode_gather(layout: EncodeLayout, k: int, bands):
    """Source of every data digit of one k-group: (g, nblk, k, 3) indices
    into a superframe's flat RAW symbols (n*9, plus one zero slot at the
    end) and the power of 3 that selects the digit.  Data digit d of band
    b, block blk, coeff c is stream trit T = 3i + d of stream symbol
    i = 9*(blk*k + c) + b, which is trit T % 26 of RAW word T // 26."""
    n = layout.n_raw_words
    nblk = layout.geom.blocks[bands[0]]
    b = np.asarray(bands)[:, None, None, None]
    blk = np.arange(nblk)[None, :, None, None]
    c = np.arange(k)[None, None, :, None]
    d = np.arange(3)[None, None, None, :]
    T = 3 * (9 * (blk * k + c) + b) + d
    w, t = np.divmod(T, 26)
    src = np.where(T < 26 * n, w * NUM_BANDS + t // 3, n * NUM_BANDS)
    pw = np.where(T < 26 * n, 3 ** (t % 3), 1)
    return src.astype(np.int64), pw.astype(np.int16)


def _decode_gather(dlayout: DecodeLayout, unpack702_bw: np.ndarray):
    """(9, n_out, 3) indices into a superframe's flat descrambled digit grid
    (9 bands x H cols x 3 digits, plus one zero slot): digit d of symbol b
    of output word w.  Read off the reference's assembly constant: grid
    trit (row 3*band + digit, col m*26 + i) is trit 3b+d of word m*27 + w
    when unpack702_bw[row, i, b*27 + w] == 3^d; band-data col j of band
    ``band`` is body col (j // k)*26 + j % k."""
    geom, n_out = dlayout.geom, dlayout.n_out_words
    H = geom.H
    row, i, q = np.nonzero(unpack702_bw)
    p3 = unpack702_bw[row, i, q]
    d = (p3 >= 3).astype(np.int64) + (p3 >= 9)          # 3^d -> d
    b, w = np.divmod(q, 27)
    band, dig = row // 3, row % 3
    M = -(-n_out // 27)
    src = np.full((NUM_BANDS, M * 27, 3), NUM_BANDS * H * 3, dtype=np.int64)
    ks = np.asarray(geom.ks)
    for m in range(M):
        col = m * 26 + i
        h = (col // ks[band]) * rs.N + col % ks[band]
        W = m * 27 + w
        live = W < n_out
        if np.any(col[live] >= np.asarray(geom.blocks)[band[live]]
                  * ks[band[live]]):
            raise AssertionError("output word reads past a band's data")
        src[b[live], W[live], d[live]] = \
            ((band * H + h) * 3 + dig)[live]
    return src[:, :n_out]


def derive_tables(cfg: EncoderConfig, ref: dict) -> dict:
    """Every table a ``SuperframeCodec`` holds, as numpy arrays, from the
    reference inputs (``reference_inputs`` layout) and the layout."""
    layout, dlayout = stream_layouts(cfg)
    geom = layout.geom
    t = {}
    for k in chain_ks(cfg):
        for name in rs.PM_KEYS:
            t[f"rs{k}_{name}"] = np.asarray(ref["rs_pm"][k][name], np.int8)
    for k, bands in k_groups(geom).items():
        r = rs.N - k
        G2 = t[f"rs{k}_G2"].reshape(3, rs.N, 3, k)       # [d', c', d, c]
        # parity map on data digits flattened (c, d) -> parity (c', d')
        t[f"par{k}"] = np.ascontiguousarray(
            G2[:, k:].transpose(3, 2, 1, 0).reshape(3 * k, 3 * r))
        t[f"enc_src{k}"], t[f"enc_pow{k}"] = _encode_gather(layout, k, bands)
    S2 = t["rs18_S2"].reshape(3, SROWS, 3, rs.N)           # [d', j, d, i]
    # r=8 syndrome map on a block's digits flattened (i, d), rows d'*8 + j
    t["S8"] = np.ascontiguousarray(
        S2.transpose(0, 1, 3, 2).reshape(3 * SROWS, 3 * rs.N))
    rmask = np.zeros((NUM_BANDS, SROWS), dtype=bool)
    for b in range(NUM_BANDS):
        rmask[b, :rs.N - geom.ks[b]] = True
    t["rmask"] = rmask
    hw = np.asarray(ref["header_words"], dtype=np.int8)
    t["header_words"] = hw
    flat = hw.reshape(-1).astype(np.int64)
    # systematic header blocks: their data is the first 18 symbols
    t["hdr_exp"] = np.stack([np_sym_to_dig(flat[:18]).T,
                             np_sym_to_dig(flat[26:44]).T],
                            axis=1).astype(np.int8)         # (3, 2, 18)
    t["off_enc"] = np.asarray(ref["off_enc"]).astype(np.int8)
    t["off_dec"] = np.asarray(ref["off_dec"]).astype(np.int8)
    t["dec_src"] = _decode_gather(
        dlayout, np.asarray(ref["unpack702_bw"], dtype=np.int8))
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


def grid_syndromes(grid: torch.Tensor, T: dict) -> torch.Tensor:
    """Digit grid (n, 9, 26*nb, 3) -> r=8 syndromes (n, 9, nb, 3, 8) int8."""
    n, nb = grid.shape[0], grid.shape[2] // rs.N
    x = grid.reshape(-1, 3 * rs.N).to(torch.float32)
    S = torch.matmul(x, T["S8"].to(torch.float32).T)
    return mod3(S.to(torch.int32)).to(torch.int8) \
        .reshape(n, NUM_BANDS, nb, 3, SROWS)


def assemble_words(grid: torch.Tensor, T: dict) -> torch.Tensor:
    """Digit grid (n, 9, H, 3) -> RAW planes (n, 9, n_out) int8."""
    n = grid.shape[0]
    flat = torch.nn.functional.pad(grid.reshape(n, -1), (0, 1))
    src = T["dec_src"]
    g = flat[:, src.reshape(-1)].reshape(n, *src.shape).to(torch.int16)
    return (g[..., 0] + 3 * g[..., 1] + 9 * g[..., 2]).to(torch.int8)


def check_body(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """Check decode: (n, 9, H) -> (RAW planes (n, 9, n_out), ok (n,)).
    A CUDA tensor runs the K1 kernel, a CPU tensor its plain twin."""
    if body.device.type == "cuda":
        return dec_cuda.check_decode(body, dlayout)
    if body.device.type == "cpu":
        return dec_cuda.check_decode_ref(body, T)
    raise ValueError(f"check decode: unsupported device {body.device}")


def paged_body(body: torch.Tensor, dlayout: DecodeLayout, T: dict):
    """Paged-repair decode (the reference's v2 paged corrector):
    (n, 9, H) -> (RAW planes (n, 9, n_out), ok (n,))."""
    geom = dlayout.geom
    n, H = body.shape[0], geom.H
    nblk = H // rs.N
    nblk_p = max(-(-nblk // PAGE) * PAGE, PAGE)
    npage = nblk_p // PAGE
    grid = descramble_grid(body, T, nblk_p * rs.N - H)   # (n, 9, Hp, 3)
    S_all = grid_syndromes(grid, T)                      # (n, 9, nblk_p, 3, 8)
    gv = grid.view(n, NUM_BANDS, nblk_p, rs.N, 3)
    ok = torch.ones(n, dtype=torch.bool, device=body.device)
    for k, bands in k_groups(geom).items():
        r, g = rs.N - k, len(bands)
        bidx = torch.as_tensor(bands, device=body.device)
        C = min(g * npage, max(6, g))
        dirty = (S_all[:, bidx, :, :, :r] != 0).flatten(3).any(-1)  # (n,g,nb)
        pdirty = dirty.reshape(n, g * npage, PAGE).any(-1)
        psafe = rs.first_dirty_pages(pdirty, C)                     # (n, C)
        pages = gv[:, bidx].reshape(n, g * npage, PAGE * rs.N * 3)
        g_rd = torch.gather(pages, 1, psafe[..., None].expand(
            -1, -1, pages.shape[-1])).reshape(n, C, PAGE, rs.N, 3)
        g_rd = g_rd.permute(4, 3, 0, 1, 2).reshape(3, rs.N, n * C * PAGE)
        d_c, ok_c = rs.correct_pm(g_rd.contiguous(), k,
                                  _rs_maps(T, k))            # (3, k, nCP)
        delta = mod3(d_c.to(torch.int16) - g_rd[:, :k]).to(torch.int8)
        slot, use_corr = rs.slot_merge(pdirty, C)            # (n, g*npage)
        dpages = delta.reshape(3, k, n, C, PAGE).permute(2, 3, 4, 1, 0) \
            .reshape(n, C, PAGE * k * 3)
        dsel = torch.gather(dpages, 1, slot[..., None].expand(
            -1, -1, dpages.shape[-1]))
        dsel = torch.where(use_corr[..., None], dsel, 0) \
            .reshape(n, g, nblk_p, k, 3)
        gv[:, bidx, :, :k] = mod3(gv[:, bidx, :, :k].to(torch.int16)
                                  + dsel).to(torch.int8)
        ok_pages = torch.gather(ok_c.reshape(n, C, PAGE), 1,
                                slot[..., None].expand(-1, -1, PAGE))
        okb = torch.where(use_corr[..., None], ok_pages,
                          ~dirty.reshape(n, g * npage, PAGE))
        ok = ok & okb.flatten(1).all(-1)
    return assemble_words(grid[:, :, :H], T), ok


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
        n = hdrs.shape[0]
        sy = hdrs.transpose(1, 2).reshape(n, HEADER_WORDS * NUM_BANDS)
        blocks = torch.cat([sy[:, :26], sy[:, 26:52]], dim=0)   # (2n, 26)
        dig = sym_to_dig(blocks, dim=0)                         # (3, 2n, 26)
        npage_h = -(-dig.shape[1] // 64)
        hdr_dig, ok_h = rs.decode_paged_pm_bk(
            dig, 18, page=64,
            max_dirty_pages=npage_h if hdr_all_pages else None,
            maps=_rs_maps(T, 18))
        exp = T["hdr_exp"][:, :, None, :].expand(3, 2, n, 18) \
            .reshape(3, 2 * n, 18)
        match = (hdr_dig == exp).permute(1, 0, 2).flatten(1).all(-1)
        return (ok_h & match).reshape(2, n).all(0)
    return validate


# ---------------------------------------------------------------------------
# stream API
# ---------------------------------------------------------------------------


def _codec(cfg: EncoderConfig, device):
    """The codec of ``cfg`` on ``device``: None is the current CUDA device
    and raises without one; the CPU only when the caller passes it."""
    from ..codec import codec_for
    return codec_for(cfg, device)


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
    check, paged, auto, fused (see the module docstring).  ``repair_cap``
    is the fused strategy's window (default ``sf_batch``); a value <= 0
    raises.  (The JAX package treats 0 as unset; the port rejects it.)
    ``device`` as for ``encode_stream_superframes``."""
    codec = _codec(cfg, device)
    words_T = torch.as_tensor(words).to(codec.device).transpose(1, 2)
    raw_T, ok = codec.decode(words_T, strategy=strategy,
                             repair_cap=repair_cap, sf_batch=sf_batch)
    raw = raw_T[:, :, :cfg.superframe_words].transpose(1, 2) \
        .reshape(-1, NUM_BANDS)[:n_raw]
    return raw, ok


def roundtrip_stream(chunks, cfg: EncoderConfig, sf_batch: int = 64,
                     rs_mode: str = "check", fold=None, device=None):
    """Encode and decode a superframe stream in one pass (the write-verify
    scrub): chunks (n_sf, superframe_words, 9) -> (RAW planes
    (n_sf, 9, n_out), ok (n_sf,)), ok including the header check.

    ``fold`` reduces each micro-batch of decoded planes (b, 9, n_out) to a
    per-superframe result (b, ...) inside the pass, so the full planes are
    never kept; the call then returns (folded (n_sf, ...), ok).
    ``device`` as for ``encode_stream_superframes``."""
    codec = _codec(cfg, device)
    return codec.roundtrip(torch.as_tensor(chunks).to(codec.device),
                           rs_mode=rs_mode, fold=fold, sf_batch=sf_batch)
