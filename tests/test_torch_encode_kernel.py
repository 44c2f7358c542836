"""K3 (the superframe encode kernel, csrc/encode.cu) against its plain
twin, ``encode.encode_superframes`` on the CPU.

* The kernel's host tables (``enc_cuda.host_consts``, its trit table and
  P5's interleave table) rebuild ``pipeline._encode_gather``'s source and
  power of every data digit exactly.
* A numpy model of the kernel (its RAW window, the digit words and byte
  permutes that make the stream symbols, their packed digits, the
  tensor-core parity on the uploaded B fragments, the scramble, the
  filled header, beacon and tail cells, the staged columns of each
  unit), built from the exact array the wrapper uploads, equals the twin's
  wire planes.  Every output cell is written
  exactly once.
* The wrapper: a CPU tensor goes to the twin, a wrong dtype or shape
  raises, and only a CUDA tensor reaches the kernel.

On the card (``cuda`` marker; ``chip_smoke.py`` runs the same checks
there): the kernel equals the twin at n = 1, 3, 64 and 2,025 and on a
transposed input.

Tolerance: zero.  This file does not import JAX.
"""
import numpy as np
import pytest
import torch

from ternary_image_codec_tpu_torch import config as c
from ternary_image_codec_tpu_torch import entry
from ternary_image_codec_tpu_torch.ops import (dec_cuda, enc_cuda, encode,
                                               interleave, pipeline)
from ternary_image_codec_tpu_torch.runtime import build

E = enc_cuda
LUMA = c.uep_luma_priority()
LAYOUTS = {
    "p2_luma": c.EncoderConfig(profile=c.ProfileID.P2_RS26_22, uep=LUMA),
    "p2_uniform": c.EncoderConfig(profile=c.ProfileID.P2_RS26_22,
                                  uep=c.uep_uniform(1)),
    "p3": c.EncoderConfig(profile=c.ProfileID.P3_RS26_20,
                          uep=c.uep_uniform(2), seed=c.ScramblerSeed(2, 1, 2)),
    "p1": c.EncoderConfig(profile=c.ProfileID.P1_RS26_24,
                          uep=c.uep_uniform(0), seed=c.ScramblerSeed(0, 2, 1)),
    "p5_beacon": c.EncoderConfig(profile=c.ProfileID.P5_RS26_22_2D, uep=LUMA,
                                 tile=c.Tile2D(26, 26),
                                 beacon=c.SparseBeaconCfg(13, 4, True)),
    "uep_nonresidue": c.EncoderConfig(
        profile=c.ProfileID.P2_RS26_22,
        uep=c.UEPLayout((0, 1, 2, 2, 1, 0, 1, 1, 2))),
    "p2_beacon2": c.EncoderConfig(profile=c.ProfileID.P2_RS26_22, uep=LUMA,
                                  beacon=c.SparseBeaconCfg(2, 0, True)),
}
SIZES = (8192, 1001)


def _layout(name, n_raw):
    return pipeline.stream_layouts(LAYOUTS[name], n_raw)[0]


# the kernel's own constants (csrc/encode.cu), as numpy
def digit_words() -> np.ndarray:
    """(256,) digit words d0 | d1 << 8 | d2 << 16 of each RAW byte read as
    int8, floor semantics (the twin's ``mod3(floor(x / 3^d))``)."""
    v = np.arange(256).astype(np.uint8).astype(np.int8).astype(np.int64) + 243
    return (v % 3) | (v // 3 % 3) << 8 | (v // 9 % 3) << 16


def trit_table():
    """(26,) (lo, selector) of stream symbol 26m + r: its first trit's byte
    among the 27 of group m, and the ``__byte_perm`` selector of its three
    digits in the digit words of bytes lo and lo + 1 (``trit_byte``,
    ``trit_sel``)."""
    T = 3 * np.arange(26)[:, None] + np.arange(3)
    w, t = np.divmod(T, 26)
    byte = 9 * w + t // 3
    lo = byte[:, 0]
    nib = 4 * (byte - lo[:, None]) + t % 3
    return lo, nib[:, 0] | nib[:, 1] << 4 | nib[:, 2] << 8 | 3 << 12


def spread(x):
    """Digits packed two bits each -> digit word d0 | d1 << 8 | d2 << 16."""
    return (x * 4161) & 0x030303


def scramble(d, o):
    """The symbol of digit word d with o added to each digit mod 3 (what
    the kernel's scramble table holds for a data cell's packed digits)."""
    w = d + 0x010101 * o
    w = w - 3 * (((w + 0x7D7D7D) >> 7) & 0x010101)
    return (w & 0xFF) + 3 * (w >> 8 & 0xFF) + 9 * (w >> 16 & 0xFF)


def byte_perm(x, y, sel):
    """``__byte_perm`` on int64 arrays of 32-bit words."""
    both = x | y << 32
    return sum(((both >> (8 * ((sel >> (4 * d)) & 7))) & 0xFF) << (8 * d)
               for d in range(4))


def _scalars(t):
    return {name: int(t[getattr(E, "C_" + name)]) for name in
            ("NRAW", "H", "UNITS", "P5", "L", "BCBAND", "BCP", "BCSYM",
             "SYMB", "STAGE")}


def _band(t, b):
    """(k, kind, blocks, parity map, staging offset) of band b."""
    return tuple(int(x) for x in t[E.BAND_OFF + E.BAND_WORDS * b:][:5])


def _units(t):
    n = int(t[E.C_UNITS])
    return t[E.UNIT_OFF:E.UNIT_OFF + n * E.UNIT_WORDS] \
        .reshape(n, E.UNIT_WORDS).astype(np.int64)


def _slots(u):
    """Unit u's slots in task order: (band, cw0, cw1, col0, col1,
    fill_from, first task)."""
    return [tuple(int(x) for x in u[E.UNIT_BAND + E.SLOT_WORDS * i:]
                  [:E.SLOT_WORDS]) for i in range(9)]


def _unit_band(u, b):
    """cw0, cw1, col0, col1, fill_from, first task of band b in unit u."""
    return next(r[1:] for r in _slots(u) if r[0] == b)


def _perm(layout, s):
    if not s["P5"]:
        return None
    cfg = layout.cfg
    return interleave.perm(s["L"], cfg.tile.w, cfg.tile.h)


def _symbol_index(t, layout, b, blocks):
    """Stream symbol of each data cell (blocks, k) of band b: 9 (blk k + c)
    + b, through P5's table; -1 at and past L."""
    s = _scalars(t)
    k = _band(t, b)[0]
    i = 9 * (np.asarray(blocks)[:, None] * k + np.arange(k)) + b
    perm = _perm(layout, s)
    if perm is None:
        return i
    return np.where(i < s["L"], perm[np.minimum(i, s["L"] - 1)], -1)


def _source(t, layout, grp, blocks):
    """(src, pw) of a group's data digits (bands, blocks, k, 3) from the
    kernel's tables: each stream symbol's group of three words, and the
    byte and digit of each of its trits."""
    n = _scalars(t)["NRAW"]
    sym = np.stack([_symbol_index(t, layout, b, blocks) for b in grp.bands])
    m, r = np.divmod(np.maximum(sym, 0), 26)
    lo, sel = trit_table()
    nib = (sel[r][..., None] >> (4 * np.arange(3))) & 0xF        # (.., 3)
    src = 27 * m[..., None] + lo[r][..., None] + (nib >> 2)
    pw = 3 ** (nib & 3)
    valid = (sym >= 0)[..., None] & (src < 9 * n)
    return (np.where(valid, src, 9 * n).astype(np.int64),
            np.where(valid, pw, 1).astype(np.int16))


def _bmatrix(t, pset):
    """(3 kt, 3 nt, 32, 8) int64: the B operand the uploaded fragments give
    (mma.m16n8k32 col layout: lane 4n + q, k-rows 4q.. in reg 0, 16 + 4q..
    in reg 1), from the [lane][kt][nt][reg] words."""
    w = t[E.BF_OFF + pset * E.BF_WORDS:E.BF_OFF + (pset + 1) * E.BF_WORDS] \
        .view(np.uint32).reshape(32, 3, 3, 2).astype(np.int64)
    by = (w[..., None] >> (8 * np.arange(4))) & 0xFF
    B = np.zeros((3, 3, 32, 8), dtype=np.int64)
    for lane in range(32):
        n, q = divmod(lane, 4)
        for reg in range(2):
            B[:, :, 16 * reg + 4 * q:16 * reg + 4 * q + 4, n] = \
                by[lane, :, :, reg, :]
    return B


def model(chunks: np.ndarray, layout) -> np.ndarray:
    """The kernel's arithmetic in numpy, unit by unit, from the uploaded
    table: RAW words (n, n_raw, 9) int8 -> wire planes (n, 9, 6 + H)."""
    t = E.host_consts(layout)
    s = _scalars(t)
    H = s["H"]
    n = chunks.shape[0]
    dw = digit_words()
    lo, sel = trit_table()
    off = t[E.SCR_OFF:E.HDR_OFF].reshape(9, 2).astype(np.int64)
    hdr = t[E.HDR_OFF:E.BAND_OFF].reshape(9, 6)
    p, bc_band = s["BCP"], s["BCBAND"]
    out = np.full((n, 9, 6 + H), -1, dtype=np.int64)
    raw = chunks.reshape(n, -1).view(np.uint8)
    for u in _units(t):
        m0, m1 = int(u[0]), int(u[1])
        # the unit's stream symbols: 26 from each group of 27 RAW bytes,
        # zeros past the words
        win = np.zeros((n, 27 * (m1 - m0)), dtype=np.int64)
        v = raw[:, 27 * m0:27 * m1]
        win[:, :v.shape[1]] = v
        g = dw[win].reshape(n, m1 - m0, 27)
        words = byte_perm(g[:, :, lo], g[:, :, lo + 1], sel)
        sym = (words & 0xFF) + 4 * (words >> 8 & 0xFF) \
            + 16 * (words >> 16 & 0xFF)                        # packed digits
        sym = sym.reshape(n, -1)
        for b in range(9):
            k, kind, _, pset, _ = _band(t, b)
            cw0, cw1, col0, col1, fill_from, _ = _unit_band(u, b)
            if col1 <= col0:
                continue
            st = np.full((n, col1), -1, dtype=np.int64)         # st[col]

            def put(cols, val):
                assert (st[:, cols] == -1).all(), "a cell written twice"
                st[:, cols] = val

            s01 = 13 * off[b]                              # scrambled zeros
            if col0 == 0:
                put(np.arange(6), hdr[b])
            h = np.arange(max(fill_from, col0 - 6), col1 - 6)
            put(6 + h, np.where((b == bc_band) & (h % max(p, 1) == 0),
                                s["BCSYM"], s01[h & 1]))
            if kind == E.BEACON:
                h = np.arange(-(-max(col0 - 6, 0) // p) * p,
                              min(col1 - 6, fill_from), p)
                put(6 + h, s["BCSYM"])
            if cw1 > cw0:
                row = (lambda j: j + j // (p - 1) + 1) if kind == E.BEACON \
                    else (lambda j: j)
                blk = np.arange(cw0, cw1)[:, None]
                idx = np.zeros((blk.size, 24), dtype=np.int64)
                idx[:, :k] = _symbol_index(t, layout, b, range(cw0, cw1))
                live = np.arange(24) < k
                ok = live & (idx >= 0)
                if ok.any():
                    assert (idx[ok] >= 26 * m0).all() \
                        and (idx[ok] < 26 * m1).all()
                pad = np.pad(sym, ((0, 0), (0, 1)))           # a zero last
                vals = pad[:, np.where(ok, idx - 26 * m0, -1)]
                hrow = row(blk * 26 + np.arange(24))
                put((6 + hrow)[:, live], scramble(spread(vals[:, :, live]),
                                                  off[b][hrow[:, live] & 1]))
                dig = (spread(vals)[..., None] >> (8 * np.arange(4))) & 0xFF
                A = dig.reshape(n, blk.size, 3, 32)            # k-tiles
                acc = np.einsum("nbtk,tuke->nbue", A, _bmatrix(t, pset))
                r_ = 26 - k
                hp = row(blk * 26 + k + np.arange(r_))
                o = off[b][hp & 1][None, :, None, :]
                par = ((acc[..., :r_] + o) % 3
                       * np.array([1, 3, 9])[:, None]).sum(2)
                put(6 + hp, par)
            out[:, b, col0:col1] = st[:, col0:col1]
    assert (out >= 0).all(), "a cell never written"
    return out.astype(np.int8)


def _chunks(n_raw, seed, n=2):
    r = np.random.default_rng(seed)
    x = r.integers(0, 27, size=(n, n_raw, 9), dtype=np.int8)
    x[-1] = r.integers(-128, 128, size=(n_raw, 9), dtype=np.int8)
    return x


@pytest.mark.parametrize("n_raw", SIZES)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_tables_rebuild_the_gather(name, n_raw):
    layout = _layout(name, n_raw)
    t = E.host_consts(layout)
    for grp in pipeline.k_groups(layout.geom, layout.cfg.beacon):
        for b in grp.bands:
            k, kind, nblk, _, _ = _band(t, b)
            assert (k, kind == E.BEACON, nblk) == (grp.k, grp.beacon,
                                                   grp.nblk)
        src, pw = _source(t, layout, grp, range(grp.nblk))
        want_src, want_pw = pipeline._encode_gather(layout, grp)
        assert np.array_equal(src, want_src) and np.array_equal(pw, want_pw)


@pytest.mark.parametrize("n_raw", SIZES)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_model_equals_twin(name, n_raw):
    layout = _layout(name, n_raw)
    codec = pipeline._codec(LAYOUTS[name], "cpu", n_raw)
    x = _chunks(n_raw, seed=n_raw + len(name))
    want = encode.encode_superframes(torch.as_tensor(x), layout,
                                     codec.tables()).numpy()
    assert np.array_equal(model(x, layout), want)


def _check_cover(layout):
    """Every output column of every band lies in exactly one unit, the
    units' codewords of a band are each of its codewords once, their tasks
    follow each other, and a unit's stream symbols hold every symbol its
    data reads."""
    t = E.host_consts(layout)
    s = _scalars(t)
    seen = np.zeros((9, 6 + s["H"]), dtype=np.int64)
    cws = [[] for _ in range(9)]
    for u in _units(t):
        task = 0
        assert sorted(r[0] for r in _slots(u)) == list(range(9))
        for b, cw0, cw1, col0, col1, _, task0 in _slots(u):
            seen[b, col0:col1] += 1
            cws[b] += range(cw0, cw1)
            assert task0 == task
            task += -(-(cw1 - cw0) // E.TILE)
            if cw1 > cw0:
                idx = _symbol_index(t, layout, b, range(cw0, cw1))
                idx = idx[idx >= 0]
                assert idx.size == 0 or (idx.min() >= 26 * u[0]
                                         and idx.max() < 26 * u[1])
        assert task == u[2]
    assert (seen == 1).all()
    for b in range(9):
        assert cws[b] == list(range(_band(t, b)[2]))
    p = E.plan(layout)
    assert p["smem"] <= 227 * 1024
    return p


@pytest.mark.parametrize("n_raw", SIZES)
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_units_cover_the_planes(name, n_raw):
    _check_cover(_layout(name, n_raw))


def test_entry_layout_tables():
    """``entry()``'s one 720p superframe (460,800 words, P2 luma UEP, a
    period-13 beacon in band 4), tables only: the source map of the first,
    a middle and the last unit of each group equals the gather's, the
    units cover the planes, and a block's shared memory fits."""
    layout = pipeline.stream_layouts(entry.CFG, entry.N_RAW)[0]
    t = E.host_consts(layout)
    for grp in pipeline.k_groups(layout.geom, layout.cfg.beacon):
        for B0 in (0, grp.nblk // 2, grp.nblk - 1):
            blocks = range(B0, min(B0 + 128, grp.nblk))
            src, pw = _source(t, layout, grp, blocks)
            want = pipeline._encode_gather(layout, grp, blocks)
            assert np.array_equal(src, want[0]) and np.array_equal(pw, want[1])
    p = _check_cover(layout)
    assert p["units"] == _units(t).shape[0] > 100


def test_parity_fragments_give_the_parity_map():
    """The B fragments hold ``par{k}`` at (slot, digit) x (parity symbol,
    digit) and zeros elsewhere, for every body k."""
    from ternary_image_codec_tpu_torch.ops import rs
    for k in (20, 22, 24):
        par = pipeline.parity_map(rs._matrices_pm(k)["G2"], k)
        words = dec_cuda.bfrag_words(E.parity_matrix(par, k))[:, :, :3]
        B = _bmatrix(np.concatenate([np.zeros(E.BF_OFF, np.int32),
                                     words.transpose(0, 2, 1, 3).reshape(-1)
                                     .view(np.int32)]), 0)
        M = B.transpose(0, 2, 1, 3).reshape(24, 4, 3, 8)   # slot, d, nt, c'
        r = 26 - k
        want = np.zeros((24, 4, 3, 8), dtype=np.int64)
        want[:k, :3, :, :r] = par.reshape(k, 3, r, 3).transpose(0, 1, 3, 2)
        assert np.array_equal(M, want)


def test_wrapper_routes_cpu_to_twin_and_checks_its_input():
    layout = _layout("p2_luma", 1001)
    codec = pipeline._codec(LAYOUTS["p2_luma"], "cpu", 1001)
    T = codec.tables()
    x = torch.as_tensor(_chunks(1001, seed=3))
    before = build.launches.copy()
    out = encode.encode_superframes(x, layout, T)
    assert build.launches == before
    assert torch.equal(out, codec.encode(x))
    assert torch.equal(torch.as_tensor(model(x.numpy(), layout)), out)
    with pytest.raises(TypeError):
        E.encode(x.to(torch.int16), layout)
    with pytest.raises(ValueError, match="needs \\(n, 1001, 9\\)"):
        E.encode(x[:, :1000], layout)
    with pytest.raises(ValueError, match="CUDA"):
        E.encode(x, layout)
    assert build.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this there)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p2_luma", "p5_beacon", "uep_nonresidue"])
def test_kernel_equals_twin_on_the_card(card, name):
    layout = _layout(name, 8192)
    codec = pipeline._codec(LAYOUTS[name], "cpu", 8192)
    T = codec.tables()
    for n in (1, 3, 64, 2025):
        x = torch.as_tensor(_chunks(8192, seed=n, n=n))
        got = E.encode(x.to(card), layout).cpu()
        assert torch.equal(got, encode.encode_superframes(x, layout, T))
    planes = x[:64].transpose(1, 2).contiguous().to(card)
    got = E.encode(planes.transpose(1, 2), layout).cpu()
    assert torch.equal(got, encode.encode_superframes(x[:64], layout, T))
