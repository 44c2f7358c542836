"""K1 against the JAX package, on the CPU.

* K1's plain twin (``dec_cuda.check_decode_ref``): superframes encoded by
  the JAX package from seeded numpy RAW words go through the twin, the
  reference's XLA check path (``_stream_fns(cfg, 8, rs_mode="check",
  ok_per_sf=True)``) and the Pallas kernel ``dec_pallas.check_decode_fn``
  in interpret mode; clean and with two dirty superframes.
* The kernel's host-side tables: a numpy model of the CUDA kernel's
  lookups and address arithmetic (the clamped bulk-copy spans of the two
  parts of a body and their patched edges, the descramble table, the tensor-core check on the
  uploaded B fragments with its stores into the stream-ordered buffer,
  the word-major gather from that buffer), built from the exact array
  ``dec_cuda`` uploads, is held
  against the twin on encoded and on random bodies, strided and
  contiguous.  The kernel itself is held against the twin on the card by
  ``chip_smoke.py``.

Tolerance: zero, ok flags included.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.ops import dec_pallas
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu_torch import config as tconfig
from ternary_image_codec_tpu_torch import SuperframeCodec
from ternary_image_codec_tpu_torch.ops import dec_cuda

N_SF = 6
HIT = [1, 4]
CPU = "cpu"      # the port defaults to the card; the CPU must be asked for


def _cfgs(profile, sfw, uep=("uep_luma_priority",), seed=(1, 1, 1)):
    """(JAX config, port config), each from its own package's config
    module with the same arguments (uep: helper name, then its args)."""
    return tuple(m.EncoderConfig(profile=m.ProfileID[profile],
                                 uep=getattr(m, uep[0])(*uep[1:]),
                                 superframe_words=sfw,
                                 seed=m.ScramblerSeed(*seed))
                 for m in (jconfig, tconfig))


def _words(jcfg, seed):
    """JAX-encoded wire planes (N_SF, 9, total) and the same with two
    superframes damaged in their bodies."""
    _l, _dl, enc, _dec = jpipe._stream_fns(jcfg, 8, rs_mode="check",
                                           ok_per_sf=True)
    r = np.random.default_rng(seed)
    chunks = r.integers(0, 27, size=(N_SF, jcfg.superframe_words, 9),
                        dtype=np.int8)
    clean = np.asarray(enc(jnp.asarray(chunks)))
    dirty = clean.copy()
    for i, sf in enumerate(HIT):
        col = jpipe.HEADER_WORDS + 100 + 37 * i
        dirty[sf, (3 * i) % 9, col] = (dirty[sf, (3 * i) % 9, col] + 1 + i) % 27
    return clean, dirty


CASES = [("P2_RS26_22", 256), ("P1_RS26_24", 512)]


@pytest.mark.parametrize("profile,sfw", CASES)
def test_check_ref_matches_xla_and_pallas(profile, sfw):
    jcfg, cfg = _cfgs(profile, sfw)
    codec = SuperframeCodec(cfg, device=CPU)
    _l, dlay, _enc, dec_chk = jpipe._stream_fns(jcfg, 8, rs_mode="check",
                                                ok_per_sf=True)
    assert dec_cuda.supported(codec.dlayout) == dec_pallas.supported(dlay)
    assert dec_cuda.supported(codec.dlayout)
    pallas = jax.jit(dec_pallas.check_decode_fn(dlay, interpret=True))
    clean, dirty = _words(jcfg, seed=sfw)
    for words in (clean, dirty):
        body = words[:, :, jpipe.HEADER_WORDS:]
        got, got_ok = dec_cuda.check_decode_ref(torch.as_tensor(body),
                                                codec.tables())
        want, want_ok = dec_chk(jnp.asarray(words))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
        p_out, p_ok = pallas(jnp.asarray(body))
        assert np.array_equal(got.numpy(), np.asarray(p_out))
        assert np.array_equal(got_ok.numpy(), np.asarray(p_ok))
    assert not got_ok.numpy()[HIT].any()
    assert got_ok.numpy()[[i for i in range(N_SF) if i not in HIT]].all()


def test_supported_gates():
    jcfg = jconfig.EncoderConfig(profile=jconfig.ProfileID.P5_RS26_22_2D,
                                 tile=jconfig.Tile2D(8, 4),
                                 uep=jconfig.uep_luma_priority(),
                                 superframe_words=256)
    _l, dlay, _e, _d = jpipe._stream_fns(jcfg, 8, rs_mode="check",
                                         ok_per_sf=True)
    assert not dec_cuda.supported(dlay)
    assert not dec_pallas.supported(dlay)


def test_kernel_wrapper_rejects_cpu_tensors():
    codec = SuperframeCodec(_cfgs("P2_RS26_22", 256)[1], device=CPU)
    body = torch.zeros((1, 9, codec.dlayout.H), dtype=torch.int8)
    with pytest.raises(ValueError):
        dec_cuda.check_decode(body, codec.dlayout)


def test_codec_never_falls_back_to_cpu():
    cfg = _cfgs("P2_RS26_22", 256)[1]
    if torch.cuda.is_available():
        assert SuperframeCodec(cfg, device="cuda").device.type == "cuda"
        assert SuperframeCodec(cfg).device.type == "cuda"
    else:
        for dev in ("cuda", None):
            with pytest.raises(RuntimeError, match="device"):
                SuperframeCodec(cfg, device=dev)


# ---------------------------------------------------------------------------
# numpy model of the kernel (csrc/check_decode.cu) on the uploaded table
# ---------------------------------------------------------------------------


def _split_consts(consts):
    """The uploaded uint32 table -> (lut (2, 9, 256), bfrag (32, 3, 4, 2),
    k (9,)), by the offsets the kernel uses."""
    assert consts.dtype == np.uint32 and consts.shape == (dec_cuda.CONST_WORDS,)
    lut = consts[:dec_cuda.LUT_WORDS].reshape(2, 9, 256)
    bfrag = consts[dec_cuda.BFRAG_OFF:dec_cuda.BAND_OFF].reshape(32, 3, 4, 2)
    return lut, bfrag, consts[dec_cuda.BAND_OFF:].astype(np.int64)


def _bytes(word):
    return [int(np.int8(np.uint8((int(word) >> 8 * j) & 255))) for j in range(4)]


def _m_from_fragments(bfrag):
    """Undo the per-lane fragment layout of mma.m16n8k32 (B = M^T, col)."""
    M = np.zeros((24, 128), dtype=np.int64)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for nt in range(3):
            for kt in range(4):
                for reg in range(2):
                    col = 32 * kt + 16 * reg + 4 * q
                    M[8 * nt + g, col:col + 4] = _bytes(bfrag[lane, nt, kt, reg])
    return M


def _stage(buf, base, sf_stride, row_stride, n_sf, H, s, h):
    """What the kernel's shared-memory region h holds for part h of
    superframe s (rows 0..3, or rows 4..8), read from the byte buffer buf
    (whose index 0 is 16-aligned): the clamped 16-aligned bulk copy, then
    the edge bytes patched by plain loads; unwritten bytes are 0x5A.
    Returns the part's rows, (n_rows, H)."""
    nrow = 5 if h else 4
    part_bytes = ((nrow - 1) * row_stride + H + 32 + 127) // 128 * 128
    lo_bound = (base + 15) & ~15
    hi_bound = (base + (n_sf - 1) * sf_stride + 8 * row_stride + H) & ~15
    start = base + s * sf_stride + (4 * row_stride if h else 0)
    end = start + (nrow - 1) * row_stride + H
    lo = start & ~15
    clo = max(lo, lo_bound)
    chi = min((end + 15) & ~15, hi_bound)
    assert clo % 16 == 0 and chi % 16 == 0 and chi > clo
    assert chi - lo <= part_bytes and end - lo <= part_bytes
    region = np.full(part_bytes, 0x5A, dtype=np.uint8)
    region[clo - lo:chi - lo] = buf[clo:chi]
    head = max(clo - start, 0)
    tail = max(end - chi, 0)
    assert head < 16 and tail < 16
    region[start - lo:start - lo + head] = buf[start:start + head]
    region[chi - lo:chi - lo + tail] = buf[chi:chi + tail]
    at = start - lo
    return np.stack([region[at + j * row_stride:at + j * row_stride + H]
                     for j in range(nrow)])


def _model_check(rows, nblk, lut, M, ks, stream):
    """The check pass: steps of 16 codewords of one band; lane (g, q) loads
    the lookup words of blocks 16p + 2g and 16p + 2g + 1 (a block past the
    band's last reads the last), symbols 8kt + q and 8kt + 4 + q (slot
    (3, 0) reads symbol min(24 + q, 25), slot (3, 1) is zero); the
    products over the n-tiles below 3r; columns 8nt + 2q, + 1 below 3r
    tested for divisibility by 3; data symbols (byte 0) stored into the
    stream buffer at 9 * (blk * k + c) + band."""
    bad = False
    for bd in range(9):
        k = int(ks[bd])
        r3 = 3 * (26 - k)
        for p in range(-(-nblk // 16)):
            A = np.zeros((16, 128), dtype=np.int64)
            for lane in range(32):
                g, q = lane // 4, lane % 4
                for cw in range(2):
                    blk = min(16 * p + 2 * g + cw, nblk - 1)
                    row = rows[bd, blk * 26:blk * 26 + 26]
                    for kt in range(4):
                        for hh in range(2):
                            if (kt, hh) == (3, 1):
                                continue
                            i = 8 * kt + 4 * hh + q
                            word = int(lut[q & 1, bd, row[min(i, 25)]])
                            col = 32 * kt + 16 * hh + 4 * q
                            A[8 * cw + g, col:col + 4] = _bytes(word)
                            if i < k:
                                stream[9 * (blk * k + i) + bd] = word & 255
            C = A @ M.T                                 # (16, 24) int32 sums
            for lane in range(32):
                g, q = lane // 4, lane % 4
                for nt in range(3):
                    if 8 * nt >= r3:
                        continue                        # n-tile not computed
                    for e in range(2):
                        c = 8 * nt + 2 * q + e
                        if c < r3:
                            bad |= bool(C[g, c] % 3 or C[8 + g, c] % 3)
    return bad


def _model_gather(stream, n_out):
    """The gather pass, vectorised over the words of one superframe."""
    w = np.arange(n_out, dtype=np.int64)
    T0 = 26 * w
    i0 = T0 // 3
    off = T0 - 3 * i0
    s = np.zeros((10, n_out), dtype=np.int64)
    for j in range(9):
        s[j] = stream[i0 + j]
    s[9] = np.where(off == 2, stream[np.minimum(i0 + 9, len(stream) - 1)], 0)
    m = np.choose(off, [256, 86, 29])
    u = np.choose(off, [27, 9, 3])
    d = (s * m) >> 8
    out = np.zeros((9, n_out), dtype=np.int64)
    for b in range(9):
        out[b] = d[b] + u * s[b + 1] - 27 * d[b + 1]
    out[8] %= 9
    return out.astype(np.int8)


def _model(buf, base, sf_stride, row_stride, n_sf, layout):
    lut, bfrag, ks = _split_consts(dec_cuda.host_consts(layout))
    M = _m_from_fragments(bfrag)
    assert np.array_equal(M, dec_cuda.syndrome_matrix())
    nblk, H, n_out = layout.geom.blocks[0], layout.geom.H, layout.n_out_words
    # the kernel's stream buffer: 9 * nblk * max(k), rounded up to 128;
    # unwritten bytes are 0xA5, which no symbol is
    stream = np.full(-(-9 * nblk * int(ks.max()) // 128) * 128, 0xA5,
                     dtype=np.int64)
    outs, oks = [], []
    for s in range(n_sf):
        rows = np.concatenate([_stage(buf, base, sf_stride, row_stride, n_sf,
                                      H, s, h) for h in (0, 1)])
        stream[:] = 0xA5
        oks.append(not _model_check(rows, nblk, lut, M, ks, stream))
        outs.append(_model_gather(stream, n_out))
    return np.stack(outs), np.array(oks)


# P2 with luma UEP (k = 20 on bands 0, 3, 6, 22 elsewhere) and P1 with
# k = 24 in every band, each at two superframe sizes and scrambler seeds
MODEL_CASES = [("P2_RS26_22", 256, ("uep_luma_priority",), (1, 1, 1)),
               ("P2_RS26_22", 512, ("uep_luma_priority",), (2, 1, 0)),
               ("P1_RS26_24", 256, ("uep_uniform", 0), (1, 1, 1)),
               ("P1_RS26_24", 512, ("uep_uniform", 0), (0, 2, 1))]


@pytest.mark.parametrize("body_kind", ["encoded", "random"])
@pytest.mark.parametrize("profile,sfw,uep,seed", MODEL_CASES)
def test_kernel_model_matches_twin(profile, sfw, uep, seed, body_kind):
    cfg = _cfgs(profile, sfw, uep, seed)[1]
    codec = SuperframeCodec(cfg, device=CPU)
    layout = codec.dlayout
    assert dec_cuda.supported(layout)
    H = layout.geom.H
    rng = np.random.default_rng(sfw + seed[0])
    if body_kind == "encoded":
        chunks = rng.integers(0, 27, size=(N_SF, sfw, 9), dtype=np.int8)
        words = codec.encode(torch.as_tensor(chunks)).numpy()
        for sf in HIT:
            words[sf, sf % 9, 6 + 3 * sf] = (words[sf, sf % 9, 6 + 3 * sf] + 5) % 27
    else:
        # wire bytes over all 256 values, invalid symbols included
        words = rng.integers(-128, 128, size=(N_SF, 9, 6 + H), dtype=np.int8)
        words.reshape(-1)[:256] = np.arange(-128, 128, dtype=np.int8)
    words = np.ascontiguousarray(words)
    tables = codec.tables()
    want, want_ok = dec_cuda.check_decode_ref(
        torch.as_tensor(words[:, :, 6:]), tables)
    if body_kind == "encoded":
        assert not want_ok.numpy()[HIT].any() and want_ok.numpy().sum() == N_SF - 2
    # the encoder's strided view: body at byte 6 of each (6 + H)-byte row
    got, got_ok = _model(words.view(np.uint8).reshape(-1), 6, 9 * (6 + H),
                         6 + H, N_SF, layout)
    assert np.array_equal(got, want.numpy()) and np.array_equal(got_ok, want_ok.numpy())
    # a contiguous copy, placed at an offset that is not 16-aligned
    body = np.ascontiguousarray(words[:, :, 6:])
    buf = np.zeros(body.size + 64, dtype=np.uint8)
    buf[19:19 + body.size] = body.view(np.uint8).reshape(-1)
    got, got_ok = _model(buf, 19, 9 * H, H, N_SF, layout)
    assert np.array_equal(got, want.numpy()) and np.array_equal(got_ok, want_ok.numpy())


def test_descramble_lut_floor_digits():
    """Every int8 wire byte, in every band at either column parity,
    descrambles as the twin does, digit by digit and as a symbol."""
    seed = tconfig.ScramblerSeed(2, 2, 1)
    lut = dec_cuda.descramble_lut(seed)
    codec = SuperframeCodec(tconfig.EncoderConfig(superframe_words=256,
                                                  seed=seed), device=CPU)
    from ternary_image_codec_tpu_torch.ops.pipeline import descramble_grid
    H = codec.dlayout.H
    v = np.resize(np.arange(-128, 128, dtype=np.int8), (9, H))
    grid = descramble_grid(torch.as_tensor(v[None]), codec.tables())[0].numpy()
    word = lut[np.arange(H)[None, :] & 1, np.arange(9)[:, None], v.view(np.uint8)]
    for d in range(3):
        assert np.array_equal((word >> (8 + 8 * d)) & 255, grid[..., d])
    assert np.array_equal(word & 255, grid[..., 0] + 3 * grid[..., 1]
                          + 9 * grid[..., 2])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this there)")
    return torch.device("cuda")


# the card test adds P2 at 16,384 words, whose body and stream buffer do
# not fit in shared memory: the kernel then reads them in global memory
KERNEL_CASES = [(p, s, 1) for p, s in CASES] + [("P2_RS26_22", 16384, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("profile,sfw,staged", KERNEL_CASES)
def test_kernel_matches_twin(profile, sfw, staged, cuda_device):
    cfg = _cfgs(profile, sfw)[1]
    codec = SuperframeCodec(cfg, device=cuda_device)
    r = np.random.default_rng(0)
    words = codec.encode(torch.as_tensor(
        r.integers(0, 27, size=(40, sfw, 9), dtype=np.int8)))
    words[HIT[0], 2, 50] = (words[HIT[0], 2, 50] + 4) % 27
    body = words[:, :, jpipe.HEADER_WORDS:]
    assert dec_cuda.plan(body, codec.dlayout)["staged"] == staged
    want, want_ok = dec_cuda.check_decode_ref(body, codec.tables())
    for b in (body, body.contiguous()):
        got, got_ok = dec_cuda.check_decode(b, codec.dlayout)
        assert torch.equal(got, want) and torch.equal(got_ok, want_ok)
    assert not bool(got_ok[HIT[0]]) and int(got_ok.sum()) == 39
