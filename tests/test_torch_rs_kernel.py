"""A numpy model of the K2 kernel (csrc/rs_correct.cu), built from the arrays
it compiles in (csrc/rs_tables.cuh, written by ``ops/rs_tables.py``), held
against the port's twin ``rs.correct_pm_ref`` and the JAX package's
``rs.decode_dig``.

The model does what each thread of the kernel does, step for step: the
78 digits of its codeword packed 4 to a 32-bit word; the syndrome digits as
dp4a sums of those words against the packed rows of the GF(3) map S2, one
mod 3 per digit; the clean-warp exit (a warp of 32 codewords whose every
syndrome is zero, lanes past B counted clean, returns its input's data);
then, for the other warps, the inversionless BM on the GF(27) tables of
the image, Chien, Omega and Forney at the roots, the correction added byte
by byte into the packed word's digits mod 3 with a byte-wise mod 3, and
the recheck by S2 again.  Tolerance: zero, ok flags and data on every codeword.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ternary_image_codec_tpu.ops import rs as jrs
from ternary_image_codec_tpu_torch.ops import gf27, rs, rs_tables

N = 26
KS = (18, 20, 22, 24)
WARP = 32


# the constants the kernel compiles in (test_header_is_generated)
HDR = {name: a for name, (_, _, a) in rs_tables.header_arrays().items()}


def _bytes(words):
    """uint32 words (..., n) -> their bytes (..., 4n), little-endian."""
    return np.ascontiguousarray(words).view(np.uint8)


def _dp4a_mod3(words, rows):
    """dp4a sums of packed digit words (B, n) against packed map rows
    (Q, n), signed bytes as the kernel's __dp4a takes them, one mod 3 each
    (the kernel's biased unsigned remainder) -> (B, Q)."""
    acc = _bytes(words).view(np.int8).astype(np.int64) \
        @ _bytes(rows).view(np.int8).astype(np.int64).T
    return (acc + 3 * 16384) % 3


def _mod3_bytes(w):
    """The kernel's byte-wise mod 3 of words whose bytes are 0..5."""
    w = w.astype(np.uint32)
    return w - np.uint32(3) * (((w + np.uint32(0x01010101)) >> np.uint32(2))
                               & np.uint32(0x01010101))


def _mod3_digits(w):
    """The kernel's mod 3 of words of four int8 digits: nibble sums, 2-bit
    sums, then ``_mod3_bytes``."""
    w = w.astype(np.uint32)
    u = lambda c: np.uint32(c)
    a = (w & u(0x0F0F0F0F)) + ((w >> u(4)) & u(0x0F0F0F0F)) \
        + ((w >> u(6)) & u(0x02020202))
    a = (a & u(0x03030303)) + ((a >> u(2)) & u(0x0F0F0F0F))
    a = (a & u(0x03030303)) + ((a >> u(2)) & u(0x03030303))
    return _mod3_bytes(a)


def _tables():
    img = HDR["kGfTableImage"].astype(np.int64)
    return {"mul": img[:729].reshape(27, 27), "add": img[729:1458].reshape(27, 27),
            "neg": img[1458:1485], "inv": img[1485:1512], "exp": img[1512:1538]}


def kernel_model(recv_pm: np.ndarray, k: int):
    """(3, 26, B) digits -> (data (3, k, B), ok (B,), warp_clean (nwarps,))."""
    r = N - k
    smax, t = r + 1, r // 2
    T = _tables()
    mul, add, neg, exp = T["mul"], T["add"], T["neg"], T["exp"]
    S2 = HDR["kS2"][r // 2 - 1, :3 * r]
    B = recv_pm.shape[-1]
    nw = -(-B // WARP)
    # lanes past B hold the zero codeword
    flat = np.zeros((nw * WARP, 80), dtype=np.uint8)
    flat[:B, :78] = recv_pm.reshape(78, B).T.astype(np.uint8)
    x = flat.view("<u4")                                       # (Bp, 20)
    sd = _dp4a_mod3(x, S2)                                     # (Bp, 3r)
    szero = (sd == 0).all(1)
    warp_clean = szero.reshape(nw, WARP).all(1)
    fx = x.copy()
    ok = np.ones(nw * WARP, dtype=bool)
    lanes = np.nonzero(~np.repeat(warp_clean, WARP))[0]
    if len(lanes):
        s = sd[lanes]
        S = s[:, :r] + 3 * s[:, r:2 * r] + 9 * s[:, 2 * r:]
        n_l = len(lanes)
        sig = np.zeros((n_l, smax), np.int64)
        sig[:, 0] = 1
        Bx = np.zeros((n_l, smax), np.int64)
        Bx[:, 1] = 1
        bd = np.ones(n_l, np.int64)
        L = np.zeros(n_l, np.int64)
        for n in range(r):
            d = np.zeros(n_l, np.int64)
            for i in range(n + 1):
                d = add[d, mul[sig[:, i], S[:, n - i]]]
            dz = d == 0
            grow = ~dz & (2 * L <= n)
            base = np.where(grow[:, None], sig, Bx)
            upd = add[mul[bd[:, None], sig], neg[mul[d[:, None], Bx]]]
            sig = np.where(dz[:, None], sig, upd)
            Bx = np.concatenate([np.zeros((n_l, 1), np.int64), base[:, :-1]], 1)
            bd = np.where(grow, d, bd)
            L = np.where(grow, n + 1 - L, L)
        ev = np.zeros((n_l, N), np.int64)
        for i in range(N):
            for d in range(smax):
                ev[:, i] = add[ev[:, i], mul[sig[:, d], exp[(-i * d) % 26]]]
        root = ev == 0                                         # (n_l, 26)
        nroots = root.sum(1)
        om = np.zeros((n_l, r), np.int64)
        for j in range(r):
            for i in range(j + 1):
                om[:, j] = add[om[:, j], mul[S[:, i], sig[:, j - i]]]
        cb = _mod3_digits(x[lanes]).view(np.uint8)             # (n_l, 80)
        for i in range(N):
            num = np.zeros(n_l, np.int64)
            for d in range(r):
                num = add[num, mul[om[:, d], exp[(-i * d) % 26]]]
            den = np.zeros(n_l, np.int64)
            for d in range(1, smax):
                if d % 3:
                    term = mul[sig[:, d], exp[(-i * (d - 1)) % 26]]
                    den = add[den, mul[d % 3, term]]
            y = mul[num, T["inv"][den]]
            for e, yd in enumerate((y % 3, (y // 3) % 3, y // 9)):
                cb[:, e * N + i] += np.where(root[:, i], yd, 0).astype(np.uint8)
        fixed = _mod3_bytes(cb.view("<u4"))
        rezero = (_dp4a_mod3(fixed, S2) == 0).all(1)
        sz = szero[lanes]
        ok[lanes] = (rezero & (nroots <= t) & (nroots == L)) | sz
        fx[lanes] = np.where(sz[:, None], x[lanes], fixed)
    out = fx.view(np.uint8)[:B, :78].reshape(B, 3, N)[:, :, :k]
    return out.transpose(1, 2, 0).astype(np.int8), ok[:B], warp_clean


def _recv(k, nerr, seed):
    """(data digits (3, k, B), received digits (3, 26, B)): codeword b
    carries nerr[b] symbol errors at random positions."""
    rng = np.random.default_rng(seed)
    B = len(nerr)
    data = rng.integers(0, 27, size=(B, k))
    cw = rs.np_encode(data, k)
    for b in range(B):
        for p in rng.choice(N, size=nerr[b], replace=False):
            cw[b, p] = gf27.np_gf_add(cw[b, p], 1 + rng.integers(0, 26))
    pm = lambda s: np.ascontiguousarray(
        gf27.np_sym_to_dig(s).transpose(2, 1, 0)).astype(np.int8)
    return pm(data), pm(cw)


def _mixed(k, B):
    """Errors per codeword: warps 0, 3, 6 .. clean; in the others codeword
    b carries b % (t + 2) errors, so clean, <= t and t + 1 all occur."""
    t = (N - k) // 2
    b = np.arange(B)
    return np.where((b // WARP) % 3 == 0, 0, b % (t + 2))


def test_table_image_matches_field():
    """The image the kernel copies to shared memory is gf27.tables()."""
    img = HDR["kGfTableImage"]
    assert img.shape == (1552,)
    T, ref = _tables(), gf27.tables()
    for name in ("mul", "add", "inv", "exp"):
        assert np.array_equal(T[name], ref[name]), name
    assert np.array_equal(T["neg"], gf27.np_gf_neg(np.arange(27)))
    assert not img[1538:].any()


@pytest.mark.parametrize("k", KS)
def test_packed_map_matches_code_matrices(k):
    """Row q of kS2, unpacked, is row q of _matrices_pm(k)'s S2 over the
    plane-major digits; the padding (rows past 3r, bytes past 78) is zero."""
    r = N - k
    got = _bytes(HDR["kS2"][r // 2 - 1]).reshape(24, 80)
    assert np.array_equal(got[:3 * r, :78],
                          rs._matrices_pm(k)["S2"].reshape(3 * r, 78))
    assert not got[:3 * r, 78:].any() and not got[3 * r:].any()


def test_header_is_generated():
    """The committed header is what rs_tables.header_source() writes now."""
    assert rs_tables.HEADER.read_text() == rs_tables.header_source()


def test_dp4a_syndromes_match_twin():
    """dp4a sums with one mod 3 give the twin's syndrome digits, on
    random digits too (not only received words near a codeword)."""
    rng = np.random.default_rng(11)
    for k in KS:
        r = N - k
        recv = rng.integers(0, 3, (3, N, 200)).astype(np.int8)
        flat = np.zeros((200, 80), np.uint8)
        flat[:, :78] = recv.reshape(78, 200).T
        got = _dp4a_mod3(flat.view("<u4"), HDR["kS2"][r // 2 - 1, :3 * r])
        want = rs.syndromes_pm(torch.as_tensor(recv), k).reshape(3 * r, 200)
        assert np.array_equal(got.T, want.numpy())


def test_mod3_bytes():
    v = np.arange(5 ** 4)
    digs = np.stack([(v // 5 ** i) % 5 for i in range(4)], 1)
    w = (digs << np.array([0, 8, 16, 24])).sum(1).astype(np.uint32)
    got = _bytes(_mod3_bytes(w)[:, None]).reshape(-1, 4)
    assert np.array_equal(got, digs % 3)


def test_mod3_digits():
    """Every int8 value in every byte of a word, and random words: each
    byte becomes its digit mod 3."""
    v = np.arange(256, dtype=np.uint32)
    words = np.concatenate([v << np.uint32(8 * j) for j in range(4)]
                           + [np.random.default_rng(5).integers(
                               0, 2 ** 32, 4096, dtype=np.uint32)])
    got = _bytes(_mod3_digits(words)[:, None]).reshape(-1, 4)
    assert np.array_equal(got, _bytes(words[:, None]).view(np.int8)
                          .reshape(-1, 4).astype(np.int64) % 3)


@pytest.mark.parametrize("k", KS)
def test_model_matches_twin_and_reference(k):
    """t and t + 1 errors and clean warps at 320 codewords, plus a tail of
    B % 32 != 0: the model equals the twin and the JAX package's
    decode_dig on every codeword."""
    for B in (320, 301):
        nerr = _mixed(k, B)
        data, recv = _recv(k, nerr, seed=40 + k + B)
        got, got_ok, clean = kernel_model(recv, k)
        want, want_ok = rs.correct_pm_ref(torch.as_tensor(recv), k)
        assert np.array_equal(got_ok, want_ok.numpy())
        assert np.array_equal(got, want.numpy())
        assert np.array_equal(clean, (np.pad(nerr, (0, -B % WARP))
                                      .reshape(-1, WARP) == 0).all(1))
        within = nerr <= (N - k) // 2
        assert got_ok[within].all()
        assert np.array_equal(got[:, :, within], data[:, :, within])
    jd, jok = jrs.decode_dig(jnp.asarray(recv.transpose(2, 1, 0)), k)
    assert np.array_equal(got_ok, np.asarray(jok))
    assert np.array_equal(got, np.asarray(jd).transpose(2, 1, 0))


def test_clean_warp_exit_on_the_fused_window():
    """The fused repair window's traffic (64 superframe slots x 6 pages x
    16 blocks, k=22, damaged codewords in the first 5 pages of 20 slots)
    and one warp whose only dirty lane is its last: every clean warp
    leaves after its syndromes, the last-lane warp does not, and the
    output equals the twin's."""
    k, t = 22, 2
    nerr = np.zeros((64, 6, 16), np.int64)
    rng = np.random.default_rng(9)
    for s in range(20):
        for p in range(5):
            nerr[s, p, rng.integers(16)] = 1 + (s + p) % t
    nerr = nerr.reshape(-1)
    nerr[40 * 96 + 31] = 1
    _, recv = _recv(k, nerr, seed=12)
    got, got_ok, clean = kernel_model(recv, k)
    dirty_warps = np.nonzero(~clean)[0]
    assert np.array_equal(dirty_warps, np.r_[0:60, 120])
    want, want_ok = rs.correct_pm_ref(torch.as_tensor(recv), k)
    assert np.array_equal(got_ok, want_ok.numpy()) and got_ok.all()
    assert np.array_equal(got, want.numpy())


def test_all_clean_input_never_repairs():
    """Every warp clean: the model's exit returns the input's data."""
    _, recv = _recv(20, np.zeros(256, np.int64), seed=3)
    got, got_ok, clean = kernel_model(recv, 20)
    assert clean.all() and got_ok.all()
    assert np.array_equal(got, recv[:, :20])


@pytest.mark.parametrize("k", KS)
def test_model_matches_twin_on_digits_out_of_range(k):
    """Digits outside 0..2 count as their value mod 3, as in the twin (the
    port's contract; the JAX package's decode_dig takes digits 0..2):
    received words near codewords with every digit moved by a multiple of
    3 (clean warps among them, which return their input as it is), and
    random int8 digits over all 256 values (failed blocks, mostly)."""
    rng = np.random.default_rng(70 + k)
    nerr = _mixed(k, 320)
    data, recv = _recv(k, nerr, seed=80 + k)
    moved = (recv + 3 * rng.integers(-42, 42, recv.shape)).astype(np.int8)
    noise = rng.integers(-128, 128, (3, N, 320)).astype(np.int8)
    noise.reshape(-1)[:256] = np.arange(-128, 128)
    within = nerr <= (N - k) // 2
    for recv in (moved, noise):
        got, got_ok, _ = kernel_model(recv, k)
        want, want_ok = rs.correct_pm_ref(torch.as_tensor(recv), k)
        assert np.array_equal(got_ok, want_ok.numpy())
        assert np.array_equal(got, want.numpy())
    got, got_ok, _ = kernel_model(moved, k)
    assert got_ok[within].all()
    assert np.array_equal(got[:, :, within] % 3, data[:, :, within])
