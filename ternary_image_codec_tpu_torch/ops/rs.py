"""RS(26,k) over GF(27) for the PyTorch port.

Same code as the JAX package's ops/rs.py: systematic, data in positions
0..k-1, parity in k..25, codewords c(x) with c(alpha^j) = 0 for j = 1..r
(r = 26 - k, t = r // 2).  Every fixed GF(27) matrix stage is a GF(3)-linear
map over digits (``gf27.mod3_dot_pm``); blocks travel plane-major,
(3 digit, 26 coeff, B block), the block axis minor.

``correct_pm`` is the BM/Chien/Forney chain.  On a CUDA tensor it launches
the hand-written kernel (ops/rs_cuda.py, csrc/rs_correct.cu); on a CPU
tensor it runs ``correct_pm_ref``, the plain torch twin with the algebra
of the reference's ``_correct_pm``/``_bm_core`` (inversionless BM with a
pre-shifted B(x)), so the two agree bit for bit, ok flags included.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime import tracing
from . import gf27
from .gf27 import (m3, mod3, mod3_dot_pm, np_alpha_pow, np_gf_mul,
                   np_gf_neg, np_gf_solve, np_poly_mod)

N = 26


@functools.cache
def generator_poly(k: int) -> np.ndarray:
    """g(x) = prod_{i=1..r} (x - alpha^i), ascending-degree coefficients."""
    g = np.array([1], dtype=np.int64)
    for i in range(1, N - k + 1):
        root = int(np_alpha_pow(i))
        g = gf27.np_poly_mul(g, np.array([np_gf_neg(root), 1], dtype=np.int64))
    return g


@functools.cache
def _matrices(k: int):
    """GF(27) code matrices and their coeff-minor GF(3) lifts (host)."""
    r = N - k
    smax = r + 1
    g = generator_poly(k)
    # systematic generator G = [I_k | P]: x^i + sum_m P[i, m] x^(k+m) = 0
    # mod g, solved column-wise through Q_m = x^(k+m) mod g
    Q = np.zeros((r, r), dtype=np.int64)
    for m in range(r):
        e = np.zeros(k + m + 1, dtype=np.int64)
        e[-1] = 1
        Q[:, m] = np_poly_mod(e, g)
    P = np.zeros((k, r), dtype=np.int64)
    for i in range(k):
        e = np.zeros(i + 1, dtype=np.int64)
        e[-1] = 1
        P[i] = np_gf_solve(Q, np_gf_neg(np_poly_mod(e, g)))
    G = np.zeros((k, N), dtype=np.int64)
    G[:, :k] = np.eye(k, dtype=np.int64)
    G[:, k:] = P
    for i in range(k):
        for j in range(1, r + 1):
            if gf27.np_poly_eval(G[i], int(np_alpha_pow(j))) != 0:
                raise AssertionError(f"generator row {i} is not a codeword")
    C = _eval_consts(k)
    return {"r": r, "smax": smax, "g": g, "G": G,
            "G3": gf27.gf3_linmap(G),
            "S3": gf27.gf3_linmap(C["synd"]),
            "CH3": gf27.gf3_linmap(C["chien"]),
            "OM3": gf27.gf3_linmap(C["omega"]),
            "SP3": gf27.gf3_linmap(C["dsigma"])}


def _eval_consts(k: int):
    """GF(27) evaluation matrices of the decode chain."""
    r = N - k
    smax = r + 1
    pos = np.arange(N)[None, :]
    dsigma = np.zeros((smax, N), dtype=np.int64)
    for d in range(1, smax):
        if d % 3:
            # sigma'(y) = sum_{d >= 1} (d mod 3) sigma_d y^(d-1)
            dsigma[d] = np_gf_mul(d % 3, np_alpha_pow(-pos[0] * (d - 1)))
    return {
        # S_j = sum_i c_i alpha^((j+1) i)
        "synd": np_alpha_pow((np.arange(r)[None, :] + 1) * np.arange(N)[:, None]),
        # sigma(alpha^-i), Omega(alpha^-i)
        "chien": np_alpha_pow(-pos * np.arange(smax)[:, None]),
        "omega": np_alpha_pow(-pos * np.arange(r)[:, None]),
        "dsigma": dsigma,
    }


@functools.cache
def _matrices_pm(k: int):
    """Plane-major lifts (gf27.gf3_linmap_pm) of the code matrices."""
    M = _matrices(k)
    C = _eval_consts(k)
    return {
        "r": M["r"], "smax": M["smax"],
        "G2": gf27.gf3_linmap_pm(M["G"]),       # data (3,k,B)     -> (78, B)
        "S2": gf27.gf3_linmap_pm(C["synd"]),    # recv (3,26,B)    -> (3r, B)
        "CH2": gf27.gf3_linmap_pm(C["chien"]),  # sigma (3,smax,B) -> (78, B)
        "OM2": gf27.gf3_linmap_pm(C["omega"]),  # omega (3,r,B)    -> (78, B)
        "SP2": gf27.gf3_linmap_pm(C["dsigma"]),  # sigma (3,smax,B) -> (78, B)
    }


PM_KEYS = ("G2", "S2", "CH2", "OM2", "SP2")


@functools.cache
def pm_tensors(k: int, device: torch.device) -> dict:
    """``_matrices_pm(k)`` as int8 tensors on ``device`` (built once)."""
    M = _matrices_pm(k)
    return {name: torch.as_tensor(M[name], device=device) for name in PM_KEYS}


def np_encode(data: np.ndarray, k: int) -> np.ndarray:
    """Host encode: (..., k) symbols -> (..., 26) codewords."""
    M = _matrices(k)
    d = gf27.np_sym_to_dig(data).reshape(*np.shape(data)[:-1], 3 * k)
    cw = (d @ M["G3"].astype(np.int64)) % 3
    return gf27.np_dig_to_sym(cw.reshape(*cw.shape[:-1], N, 3))


# ---------------------------------------------------------------------------
# plane-major codec: blocks are (3, 26, B) int8
# ---------------------------------------------------------------------------


def _maps(k: int, device, maps):
    return maps if maps is not None else pm_tensors(k, torch.device(device))


def encode_pm(data_pm: torch.Tensor, k: int, maps=None) -> torch.Tensor:
    """(3, k, B) data digits -> (3, 26, B) codeword digits."""
    M = _maps(k, data_pm.device, maps)
    return mod3_dot_pm(M["G2"], data_pm).reshape(3, N, data_pm.shape[-1])


def syndromes_pm(recv_pm: torch.Tensor, k: int, maps=None) -> torch.Tensor:
    """(3, 26, B) received digits -> (3, r, B) syndrome digits."""
    M = _maps(k, recv_pm.device, maps)
    return mod3_dot_pm(M["S2"], recv_pm).reshape(3, N - k, recv_pm.shape[-1])


def syndromes_pm_bk(recv_bk: torch.Tensor, k: int, maps=None) -> torch.Tensor:
    """(3, B, 26) received digits -> (3, r, B) syndrome digits."""
    return syndromes_pm(recv_bk.transpose(1, 2), k, maps)


def _bm_core(S3d: torch.Tensor, r: int, smax: int):
    """Batched inversionless Berlekamp-Massey, (coeff, digit, B) layout.

    S3d (r, 3, B) syndrome digits -> (sigma (smax, 3, B), L (B,) int32).
    sigma carries an arbitrary nonzero per-block scale (Chien roots and
    Forney's -Omega/sigma' are invariant to it).  B(x) is kept pre-shifted
    (Bx = x^m B), so each iteration shifts one select's result; the update
    is sigma <- b*sigma - d*(x^m B), with no field inversion."""
    B_ = S3d.shape[-1]
    dev = S3d.device
    sigma = torch.zeros((smax, 3, B_), dtype=torch.int8, device=dev)
    sigma[0, 0] = 1
    Bx = torch.zeros((smax, 3, B_), dtype=torch.int8, device=dev)
    Bx[1, 0] = 1
    bdig = torch.zeros((1, 3, B_), dtype=torch.int8, device=dev)
    bdig[0, 0] = 1
    L = torch.zeros((B_,), dtype=torch.int32, device=dev)
    zrow = torch.zeros((1, 3, B_), dtype=torch.int8, device=dev)
    for n in range(r):
        # discrepancy d = sum_{i <= min(n, smax-1)} sigma_i * S_{n-i}
        cnt = min(n, smax - 1) + 1
        swin = S3d[:n + 1].flip(0)[:cnt]                   # S_n, S_{n-1}, ..
        d = mod3(m3(sigma[:cnt], swin, dim=1).to(torch.int16).sum(0))
        d = d.to(torch.int8)[None]                         # (1, 3, B)
        dz = d[0].to(torch.int16).sum(0) == 0              # (B,)
        upd = mod3(m3(bdig, sigma, dim=1).to(torch.int16)
                   - m3(d, Bx, dim=1)).to(torch.int8)
        sigma_new = torch.where(dz[None, None], sigma, upd)
        grow = (~dz) & (2 * L <= n)
        # next x^m B: grow -> x * sigma (m resets to 1); else x * Bx
        base = torch.where(grow[None, None], sigma, Bx)
        Bx = torch.cat([zrow, base[:smax - 1]], dim=0)
        bdig = torch.where(grow[None, None], d, bdig)
        L = torch.where(grow, n + 1 - L, L)
        sigma = sigma_new
    return sigma, L


@functools.cache
def _inv_dig(device: torch.device) -> torch.Tensor:
    """(27, 3) int8: digits of a^-1 for every symbol (inv(0) = 0)."""
    return torch.as_tensor(gf27.np_sym_to_dig(gf27.tables()["inv"])
                           .astype(np.int8), device=device)


def inv_pm(d: torch.Tensor) -> torch.Tensor:
    """Field inverse of plane-major digits (3, ...); inv(0) = 0."""
    sym = gf27.dig_to_sym(d, dim=0).to(torch.int64)
    return _inv_dig(d.device)[sym].movedim(-1, 0)


def correct_pm_ref(recv_pm: torch.Tensor, k: int, maps=None):
    """Plain torch twin of the K2 kernel: the whole RS(26,k) decode of
    plane-major blocks.  recv_pm (3, 26, B) digits -> (data (3, k, B),
    ok (B,) bool).  ok = (recheck zero and nroots <= t and nroots == L)
    or a zero syndrome; a zero-syndrome block returns its input as it is,
    any other its corrected digits mod 3 (a digit outside 0..2 counts as
    its value mod 3)."""
    M = _maps(k, recv_pm.device, maps)
    r = N - k
    smax, t = r + 1, r // 2
    B_ = recv_pm.shape[-1]
    S = syndromes_pm(recv_pm, k, M)                         # (3, r, B)
    synd_zero = (S.reshape(3 * r, B_) == 0).all(0)
    S3d = S.permute(1, 0, 2)                                # (r, 3, B)
    sigma, L = _bm_core(S3d, r, smax)                       # (smax, 3, B)
    sigma_pm = sigma.permute(1, 0, 2)                       # (3, smax, B)

    ev = mod3_dot_pm(M["CH2"], sigma_pm).reshape(3, N, B_)
    root = ev.to(torch.int16).sum(0) == 0                   # (26, B)
    nroots = root.sum(0)                                    # (B,)

    # Omega = S(x) sigma(x) mod x^r
    om_rows = []
    for j in range(r):
        i0 = max(0, j - smax + 1)
        terms = m3(S3d[i0:j + 1], sigma[:j + 1 - i0].flip(0), dim=1)
        om_rows.append(mod3(terms.to(torch.int16).sum(0)).to(torch.int8))
    Om_pm = torch.stack(om_rows, dim=0).permute(1, 0, 2)    # (3, r, B)

    num = mod3_dot_pm(M["OM2"], Om_pm).reshape(3, N, B_)
    den = mod3_dot_pm(M["SP2"], sigma_pm).reshape(3, N, B_)
    # error value Y = -Omega(X)/sigma'(X); corrected = recv - Y
    Y = mod3(-m3(num, inv_pm(den)).to(torch.int16))
    corr = torch.where(root[None], mod3(-Y), 0)
    fixed = mod3(recv_pm.to(torch.int16) + corr).to(torch.int8)

    S2c = mod3_dot_pm(M["S2"], fixed)                       # (3r, B)
    ok = (S2c == 0).all(0) & (nroots <= t) & (nroots == L)
    ok = ok | synd_zero
    fixed = torch.where(synd_zero[None, None], recv_pm.to(torch.int8), fixed)
    return fixed[:, :k], ok


def correct_pm(recv_pm: torch.Tensor, k: int, maps=None):
    """RS(26,k) decode of plane-major blocks (3, 26, B) -> ((3, k, B), ok).

    A CUDA tensor goes to the K2 kernel, a CPU tensor to ``correct_pm_ref``
    (whose docstring gives the contract both keep); any other device
    raises."""
    tracing.count("t3.k2.codewords", recv_pm.shape[-1])
    with tracing.span("t3.k2"):
        if recv_pm.device.type == "cuda":
            from . import rs_cuda
            return rs_cuda.rs_correct(recv_pm, k)
        if recv_pm.device.type == "cpu":
            return correct_pm_ref(recv_pm, k, maps)
    raise ValueError(f"correct_pm: unsupported device {recv_pm.device}")


def blocks_pm(blocks: torch.Tensor) -> torch.Tensor:
    """Codeword digits (..., 26, 3) -> K2's layout (3, 26, B), contiguous,
    the blocks in the row-major order of the leading axes."""
    return blocks.reshape(-1, N, 3).permute(2, 1, 0).contiguous()


def pm_blocks(data_pm: torch.Tensor, lead) -> torch.Tensor:
    """K2's data digits (3, k, B) -> (*lead, k, 3), ``blocks_pm``'s block
    order (a view)."""
    return data_pm.permute(2, 1, 0).reshape(*lead, data_pm.shape[1], 3)


def decode_dig(recv_dig: torch.Tensor, k: int, maps=None):
    """Digit decode: (B, 26, 3) -> (data digits (B, k, 3), ok (B,))."""
    data_pm, ok = correct_pm(blocks_pm(recv_dig.to(torch.int8)), k, maps)
    return pm_blocks(data_pm, ok.shape), ok


def encode(data: torch.Tensor, k: int) -> torch.Tensor:
    """Symbol-domain encode on the tensor's device: (..., k) GF(27)
    symbols -> (..., 26) int8 codewords."""
    lead = data.shape[:-1]
    pm = gf27.sym_to_dig(data.reshape(-1, k), dim=0).transpose(1, 2)
    cw = encode_pm(pm, k)                                    # (3, 26, B)
    return gf27.dig_to_sym(cw, dim=0).T.reshape(*lead, N)


def decode(recv: torch.Tensor, k: int):
    """Symbol-domain decode: (B, 26) received symbols -> (data (B, k) int8,
    ok (B,)); the correction is ``correct_pm``'s (K2 on the card)."""
    data, ok = decode_dig(gf27.sym_to_dig(recv), k)
    return gf27.dig_to_sym(data), ok


# ---------------------------------------------------------------------------
# page compaction
# ---------------------------------------------------------------------------


def first_dirty_pages(pdirty: torch.Tensor, C: int) -> torch.Tensor:
    """(..., P) dirty-page flags -> (..., C) indices of the first C dirty
    pages in ascending order; slots past the dirty count hold page 0 (their
    corrections are never read back, see ``slot_merge``)."""
    P = pdirty.shape[-1]
    idx = torch.arange(P, device=pdirty.device).expand_as(pdirty)
    pidx = torch.sort(torch.where(pdirty, idx, P), dim=-1).values[..., :C]
    return torch.where(pidx < P, pidx, 0)


def slot_merge(pdirty: torch.Tensor, C: int):
    """Slot-gather merge map: page p takes corrected slot rank(p) when it is
    one of the first C dirty pages.  Returns (slot, use_corr), both (..., P)."""
    rank = torch.cumsum(pdirty.to(torch.int32), dim=-1) - 1
    return rank.clamp(0, C - 1).to(torch.int64), pdirty & (rank < C)


def count_dirty_sent(dirty: torch.Tensor, use_corr: torch.Tensor) -> None:
    """Count (``t3.k2.dirty``) the codewords with a nonzero syndrome among
    those a paged chain sent to K2: ``dirty`` block flags (..., P, page),
    ``use_corr`` (..., P) from ``slot_merge``, which marks the pages that
    ``first_dirty_pages`` selected, its padding slots past the dirty
    count left out."""
    if tracing.active():
        tracing.count("t3.k2.dirty", (dirty & use_corr[..., None]).sum())


def pick_page(nblk: int, lo: int = 8, hi: int = 64, target: int = 24):
    """The divisor of nblk in [lo, hi] nearest ``target`` (the smaller of
    two as near); None when nblk has none."""
    cands = [d for d in range(lo, hi + 1) if nblk % d == 0]
    return min(cands, key=lambda d: abs(d - target)) if cands else None


def correct_pages(blocks: torch.Tensor, dirty: torch.Tensor, k: int, C: int,
                  maps=None):
    """The paged corrector: codeword digits (n, P, page, 26, 3) and their
    block dirty flags (n, P, page) -> (data (n, P, page, k, 3), ok
    (n, P, page)).  In each of the n rows the first C dirty pages
    (``first_dirty_pages``) are corrected, all n * C of them in one
    ``correct_pm`` call (one K2 launch on the card); a page among them
    takes its corrected digits and ok flags, any other page keeps its data
    with ok False on its dirty blocks (a dirty page past capacity fails
    safe)."""
    n, P, page = dirty.shape
    pdirty = dirty.any(-1)                                  # (n, P)
    psafe = first_dirty_pages(pdirty, C)                    # (n, C)
    sel = torch.gather(blocks, 1, psafe[..., None, None, None].expand(
        -1, -1, page, N, 3))                                # (n, C, page, .)
    d_c, ok_c = correct_pm(blocks_pm(sel), k, maps)
    slot, use_corr = slot_merge(pdirty, C)                  # (n, P)
    count_dirty_sent(dirty, use_corr)
    corr = torch.gather(pm_blocks(d_c, (n, C, page)), 1,
                        slot[..., None, None, None].expand(-1, -1, page, k, 3))
    data = torch.where(use_corr[..., None, None, None], corr,
                       blocks[..., :k, :])
    ok_pages = torch.gather(ok_c.view(n, C, page), 1,
                            slot[..., None].expand(-1, -1, page))
    return data, torch.where(use_corr[..., None], ok_pages, ~dirty)


def decode_paged_pm_bk(recv_bk: torch.Tensor, k: int, page: int = 256,
                       max_dirty_pages: int | None = None, maps=None):
    """Page-compacted decode of block-minor digits (3, B, 26) -> ((3, B, k),
    ok (B,)).  Only the first C dirty pages (C = max_dirty_pages, default
    max(8, npage // 8), at most npage) run the correction chain
    (``correct_pages``); blocks of dirty pages beyond capacity come back
    uncorrected with ok=False."""
    B = recv_bk.shape[1]
    npage = -(-B // page)
    C = max_dirty_pages if max_dirty_pages is not None else max(8, npage // 8)
    C = min(C, npage)
    rd = recv_bk.new_zeros((npage * page, N, 3))            # zero pad blocks
    rd[:B] = recv_bk.permute(1, 2, 0)
    S = syndromes_pm(rd.permute(2, 1, 0), k, maps)          # (3, r, Bp)
    dirty = (S != 0).flatten(0, 1).any(0).view(1, npage, page)
    data, ok = correct_pages(rd.view(1, npage, page, N, 3), dirty, k, C, maps)
    return data.view(-1, k, 3)[:B].permute(2, 0, 1), ok.view(-1)[:B]
