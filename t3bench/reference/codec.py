"""Plain reference encoder of the superframe wire format.

One superframe of ``n`` RAW words (9 symbols 0..26 each, 27 trits) becomes
int8 wire planes (9, 6 + H):

* the 26 useful trits of each word (trit 3b + d is digit d of symbol b;
  trit 26 is not carried) run as one trit stream; stream symbol i is
  trits 3i..3i+2, zero past the words;
* under P5 the stream is interleaved in w x h tiles (boustrophedon reading
  order within a tile, the last tile filtered to the indices it holds) over
  the stream length the decoder reads;
* symbol i goes to band i % 9, column i // 9; band b cuts its column into
  RS(26, k_b) codewords, data in positions 0..k-1 and parity in k..25, the
  code being every word c with c(alpha^j) = 0 for j = 1..26-k over
  GF(27) = GF(3)[x] / (x^3 + 2x + 1), alpha = x;
* a band's codewords fill its body row from the top; the beacon band's run
  down its payload rows (rows r % p != 0), the rows r % p == 0 carrying the
  beacon symbol; cells past the last whole codeword hold zero;
* every body cell but a beacon cell is scrambled: cell (row h, band b) is
  the (9h + b + 1)-th step of st <- (a st + b) mod 3, added to each digit;
* the 6 header words hold two RS(26,18) codewords of the 27 header
  symbols (a ternary CRC-12 in four of them).

Everything here is derived from those rules alone, in python, numpy and
plain torch; it imports nothing of the codec packages.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

NB = 9                  # bands = symbols a word
N = 26                  # RS code length
HEADER_WORDS = 6
KS = (24, 22, 20, 18)   # band profile P1..P4 -> k
MAGIC, VERSION = 0x0A2, 1
SUBWORD_CODE = {"S27": 0, "S24": 1, "S21": 2, "S18": 3, "S15": 4}
CRC_SLOTS = (20, 21, 22, 26)
CRC_TAPS = (3, 4, 7)    # g(x) = x^12 + x^7 + x^4 + x^3 + 1


# ---------------------------------------------------------------------------
# GF(27)
# ---------------------------------------------------------------------------

def digits(a: int):
    return a % 3, (a // 3) % 3, (a // 9) % 3


def symbol(d) -> int:
    return int(d[0]) % 3 + 3 * (int(d[1]) % 3) + 9 * (int(d[2]) % 3)


def gf_add(a: int, b: int) -> int:
    return symbol([x + y for x, y in zip(digits(a), digits(b))])


def gf_neg(a: int) -> int:
    return symbol([-x for x in digits(a)])


def gf_mul(a: int, b: int) -> int:
    """Polynomial product reduced by x^3 = x + 2, x^4 = x^2 + 2x."""
    p = [0] * 5
    for i, x in enumerate(digits(a)):
        for j, y in enumerate(digits(b)):
            p[i + j] += x * y
    p[1] += p[3]
    p[0] += 2 * p[3]
    p[2] += p[4]
    p[1] += 2 * p[4]
    return symbol(p[:3])


@functools.cache
def mul_table() -> np.ndarray:
    return np.array([[gf_mul(a, b) for b in range(27)] for a in range(27)],
                    dtype=np.int64)


def gf_pow(a: int, e: int) -> int:
    out = 1
    for _ in range(e % 26):
        out = gf_mul(out, a)
    return out


def gf_inv(a: int) -> int:
    for b in range(1, 27):
        if gf_mul(a, b) == 1:
            return b
    raise ZeroDivisionError("0 has no inverse in GF(27)")


def gf_solve(A, y):
    """x with A x = y over GF(27), by Gauss-Jordan elimination."""
    n = len(A)
    M = [list(A[i]) + [y[i]] for i in range(n)]
    for c in range(n):
        p = next(r for r in range(c, n) if M[r][c])
        M[c], M[p] = M[p], M[c]
        inv = gf_inv(M[c][c])
        M[c] = [gf_mul(inv, v) for v in M[c]]
        for r in range(n):
            if r != c and M[r][c]:
                f = M[r][c]
                M[r] = [gf_add(v, gf_neg(gf_mul(f, w)))
                        for v, w in zip(M[r], M[c])]
    return [M[r][n] for r in range(n)]


@functools.cache
def parity_matrix(k: int) -> np.ndarray:
    """(k, r) GF(27) matrix P: the parity of data d is sum_i d_i P[i].
    It solves sum_m p_m alpha^(j(k+m)) = -sum_i d_i alpha^(ji), j = 1..r,
    for each unit vector d."""
    r = N - k
    alpha = 3
    V = [[gf_pow(alpha, j * (k + m)) for m in range(r)]
         for j in range(1, r + 1)]
    P = np.zeros((k, r), dtype=np.int64)
    for i in range(k):
        P[i] = gf_solve(V, [gf_neg(gf_pow(alpha, j * i))
                            for j in range(1, r + 1)])
    return P


def rs_encode(data: torch.Tensor, k: int) -> torch.Tensor:
    """Codewords (..., 26) int64 of data symbols (..., k): the data, then
    the parity as a sum of GF(27) table products, digit-wise mod 3."""
    P = parity_matrix(k)
    lut = torch.as_tensor(mul_table()[P.T], device=data.device)   # (r, k, 27)
    p3 = torch.tensor([1, 3, 9], device=data.device)
    acc = torch.zeros(data.shape[:-1] + (N - k, 3), dtype=torch.int64,
                      device=data.device)
    for i in range(k):
        prod = lut[:, i][:, data[..., i]].movedim(0, -1)         # (..., r)
        acc += torch.div(prod[..., None], p3, rounding_mode="floor") % 3
    par = ((acc % 3) * p3).sum(-1)
    return torch.cat([data, par], dim=-1)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def band_ks(cfg: dict):
    return [KS[p % 4] for p in cfg["uep_band_profile"]]


def beacon_rows_count(H: int, cfg: dict) -> int:
    bc = cfg["beacon"]
    return -(-H // bc["words_period"]) if bc["enabled"] else 0


def geometry(cfg: dict) -> dict:
    """Body height H, per-band blocks and the stream lengths of one
    superframe of ``cfg["superframe_words"]`` RAW words."""
    n = cfg["superframe_words"]
    ks = band_ks(cfg)
    bc = cfg["beacon"]
    n_sy = -(-26 * n // 3)
    lens = [-(-(n_sy - b) // NB) for b in range(NB)]
    need = [-(-lens[b] // ks[b]) for b in range(NB)]
    H = max(nb * N for nb in need)

    def blocks(H):
        return [(H - (beacon_rows_count(H, cfg)
                      if bc["enabled"] and b == bc["band_slot"] else 0)) // N
                for b in range(NB)]
    while any(x < y for x, y in zip(blocks(H), need)):
        H += 1
    blk = blocks(H)
    L = min(NB * blk[b] * ks[b] + b for b in range(NB))
    return {"n": n, "n_sy": n_sy, "H": H, "ks": ks, "blocks": blk, "L": L,
            "n_out": L * 3 // 26, "total": HEADER_WORDS + H}


def payload_rows(H: int, cfg: dict, count: int) -> np.ndarray:
    """The first ``count`` rows of the beacon band that are not beacon
    cells."""
    p = cfg["beacon"]["words_period"]
    rows = np.array([r for r in range(H) if r % p], dtype=np.int64)
    return rows[:count]


def interleave_perm(L: int, w: int, h: int) -> np.ndarray:
    """out[i] = in[perm[i]]: tiles of w*h symbols read row by row, odd rows
    right to left; the last tile reads that order filtered to its size."""
    order = []
    for y in range(h):
        xs = range(w) if y % 2 == 0 else range(w - 1, -1, -1)
        order += [y * w + x for x in xs]
    order = np.array(order, dtype=np.int64)
    out = []
    for start in range(0, L, w * h):
        take = min(w * h, L - start)
        out.append(start + order[order < take])
    return np.concatenate(out)


def scramble_offsets(H: int, cfg: dict) -> np.ndarray:
    """(H, 9) offsets: cell (h, b) takes step 9h + b + 1 of the
    recurrence, in order."""
    a, b, s = cfg["scrambler_seed"]
    st = s % 3
    out = np.empty(NB * H, dtype=np.int64)
    for i in range(NB * H):
        st = (a * st + b) % 3
        out[i] = st
    return out.reshape(H, NB)


def crc12(trits) -> list:
    r = [0] * 12
    for t in list(trits) + [0] * 12:
        fb = (t + r[11]) % 3
        nx = [fb] + r[:11]
        for tap in CRC_TAPS:
            nx[tap] = (nx[tap] + fb) % 3
        r = nx
    return r


def header_symbols(cfg: dict) -> list:
    """The 27 header symbols at frame 0, the CRC-12 filled in."""
    bc = cfg["beacon"]
    s = [0] * 27
    s[0], s[1] = MAGIC % 27, (MAGIC // 27) % 27
    s[2] = VERSION
    s[3] = cfg["profile_id"] % 27
    u = cfg["uep_band_profile"]
    for g in range(3):
        s[4 + g] = 9 * (u[3 * g] % 3) + 3 * (u[3 * g + 1] % 3) \
            + u[3 * g + 2] % 3
    s[7], s[8] = cfg["tile"][0] % 27, cfg["tile"][1] % 27
    s[9], s[10], s[11] = (v % 27 for v in cfg["scrambler_seed"])
    s[12] = SUBWORD_CODE[cfg["subword"]] + (9 if cfg["centered"] else 0)
    s[16] = cfg["coset"] % 3
    s[23] = 1 if bc["enabled"] else 0
    s[24] = bc["band_slot"] % 27
    s[25] = min(bc["words_period"], 26)
    msg = [s[i] for i in range(27) if i not in CRC_SLOTS]
    crc = crc12([d for v in msg for d in digits(v)])
    for j, slot in enumerate(CRC_SLOTS):
        s[slot] = symbol(crc[3 * j:3 * j + 3])
    return s


def header_words(cfg: dict) -> np.ndarray:
    """(6, 9): word w, band b holds header cell 9w + b."""
    s = header_symbols(cfg)
    cells = torch.zeros(HEADER_WORDS * NB, dtype=torch.int64)
    cells[:26] = rs_encode(torch.tensor(s[:18]), 18)
    cells[26:52] = rs_encode(torch.tensor(s[18:] + [0] * 9), 18)
    return cells.reshape(HEADER_WORDS, NB).numpy()


def beacon_symbol(cfg: dict) -> int:
    """(profile + 5 (superframe_words mod 5) + 15 health) mod 27, health 0."""
    return (cfg["profile_id"] + 5 * (cfg["superframe_words"] % 5)) % 27


@functools.cache
def _plan(key):
    cfg = dict(key)
    cfg["beacon"] = dict(cfg["beacon"])
    g = geometry(cfg)
    H, ks, blk = g["H"], g["ks"], g["blocks"]
    bc = cfg["beacon"]
    w, h = cfg["tile"]
    p5 = cfg["profile_id"] == 4 and w and h
    # stream index of every data cell: band b, block j, coefficient c
    src, rows = {}, {}
    perm = interleave_perm(g["L"], w, h) if p5 else None
    for b in range(NB):
        col = np.arange(blk[b] * ks[b])
        i = NB * col + b
        if p5:
            i = np.where(i < g["L"], perm[np.minimum(i, g["L"] - 1)], -1)
        src[b] = i.reshape(blk[b], ks[b])
        cell = np.arange(blk[b] * N)
        if bc["enabled"] and b == bc["band_slot"]:
            rows[b] = payload_rows(H, cfg, blk[b] * N)
        else:
            rows[b] = cell
    return g, src, rows, scramble_offsets(H, cfg), header_words(cfg)


def _key(cfg: dict):
    keep = ("superframe_words", "profile_id", "uep_band_profile", "tile",
            "scrambler_seed", "beacon", "subword", "centered", "coset")
    return tuple((k, tuple(sorted(cfg[k].items())) if isinstance(cfg[k], dict)
                  else tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k])
                 for k in keep)


def stream_symbols(raw: torch.Tensor) -> torch.Tensor:
    """RAW words (m, n, 9) -> stream symbols (m, ceil(26n/3)) int64."""
    m, n = raw.shape[:2]
    r = raw.to(torch.int64)
    p3 = torch.tensor([1, 3, 9], device=raw.device)
    trits = (torch.div(r[..., None], p3, rounding_mode="floor") % 3) \
        .reshape(m, n, 27)[..., :26].reshape(m, 26 * n)
    trits = torch.nn.functional.pad(trits, (0, (-26 * n) % 3))
    return (trits.reshape(m, -1, 3) * p3).sum(-1)


def encode(raw: torch.Tensor, cfg: dict, parity: bool = True,
           chunk: int = 512) -> torch.Tensor:
    """RAW words (m, n, 9) of m superframes -> wire planes (m, 9, 6 + H)
    int8 on ``raw``'s device.  ``parity=False`` leaves every parity symbol
    zero: a wire that breaks the code's guarantee, for the control."""
    g, src, rows, off, hw = _plan(_key(cfg))
    dev = raw.device
    H, ks = g["H"], g["ks"]
    bc = cfg["beacon"]
    off_t = torch.as_tensor(off, device=dev)
    p3 = torch.tensor([1, 3, 9], device=dev)
    hdr = torch.as_tensor(hw.T, device=dev)
    out = []
    for part in raw.split(chunk):
        m = part.shape[0]
        S = stream_symbols(part)
        S = torch.nn.functional.pad(S, (0, 1))            # index -1: zero
        body = torch.zeros((m, NB, H), dtype=torch.int64, device=dev)
        for b in range(NB):
            idx = torch.as_tensor(src[b], device=dev)
            idx = torch.where((idx >= 0) & (idx < S.shape[1] - 1), idx, -1)
            data = S[:, idx]                              # (m, blocks, k)
            cw = rs_encode(data, ks[b]) if parity else \
                torch.nn.functional.pad(data, (0, N - ks[b]))
            body[:, b, torch.as_tensor(rows[b], device=dev)] = \
                cw.reshape(m, -1)
        d = torch.div(body[..., None], p3, rounding_mode="floor")
        d = (d + off_t.T[None, :, :, None]) % 3
        body = (d * p3).sum(-1)
        if bc["enabled"]:
            body[:, bc["band_slot"], ::bc["words_period"]] = beacon_symbol(cfg)
        out.append(torch.cat([hdr.expand(m, NB, HEADER_WORDS), body], 2)
                   .to(torch.int8))
    return torch.cat(out)


def expected_decode(raw: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The RAW planes (m, 9, n_out) a decode of ``raw``'s wire returns:
    the words, zero past them (words' band 8 below 9: trit 26 is never
    carried)."""
    g = geometry(cfg)
    planes = raw.transpose(1, 2)
    return torch.nn.functional.pad(planes, (0, g["n_out"] - raw.shape[1]))
