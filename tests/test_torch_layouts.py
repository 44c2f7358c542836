"""The port against the JAX package on every kind of layout it encodes:
the sparse beacon splice, P5's 2D interleave (with and without a beacon),
UEP groupings that are not residue classes and a subword mode that only
travels in the header.

For each config: the stream encode; the stream decode under check, paged,
auto, fused, full and none on clean words, on correctable damage (uniform
bands, the beacon band's payload, the header), on more flagged superframes
than the fused window, on t+1 errors in one codeword and on a damaged
beacon cell (never read: outputs and flags as on clean words); the
frames-batched fused decode; the roundtrip with ``feed``/``fold``; the
profile API; ``serve_codec_fns``.  Seeded numpy inputs, about 4
superframes each.  Tolerance: zero, ok flags included.

The decodes are held to the reference's per-superframe programs (one
XLA:CPU compile each for check, paged, full and none), auto and fused to
their composition as the reference composes them; two layouts hold that
composition to the reference's own auto and fused dispatches.

This file holds tests/test_pipeline_v3.py's seven beacon configs; the
others are in test_torch_layouts_p5.py.  The helpers here serve both.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.io import serve as jserve
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu.ops import wirepack as jwp
import ternary_image_codec_tpu_torch as port
from ternary_image_codec_tpu_torch import config as tconfig
from ternary_image_codec_tpu_torch.codec import SuperframeCodec, codec_for
from ternary_image_codec_tpu_torch.io import serve as tserve
from ternary_image_codec_tpu_torch.ops import gf27
from ternary_image_codec_tpu_torch.ops import pipeline as tpipe
from test_pipeline_v3 import BEACON_CFGS

CPU = "cpu"      # the port defaults to the card; the CPU must be asked for
SFB = 4          # sf_batch: one micro-batch of the 4 superframes
N_SF = 4
CAP = 2          # the fused repair window: fewer than the spread damage's 3
HW = jpipe.HEADER_WORDS
STRATEGIES = ["check", "paged", "auto", "fused", "full", "none"]
REPAIRING = ("paged", "auto", "fused", "full")
# t+1 errors on the first coefficients of an RS(26, k) codeword that the
# decoder flags (an error pattern's fate does not depend on the data)
OVERCAP = {24: (1, 11), 22: (1, 1, 2), 20: (1, 1, 1, 1)}


def port_cfg(j):
    """The port's EncoderConfig with the fields of the JAX package's ``j``."""
    t = tconfig
    return t.EncoderConfig(
        profile=t.ProfileID(int(j.profile)),
        uep=t.UEPLayout(tuple(j.uep.band_profile)),
        tile=t.Tile2D(j.tile.w, j.tile.h),
        seed=t.ScramblerSeed(j.seed.a, j.seed.b, j.seed.s0),
        beacon=t.SparseBeaconCfg(j.beacon.words_period, j.beacon.band_slot,
                                 j.beacon.enabled),
        superframe_words=j.superframe_words,
        subword=t.SubwordMode(int(j.subword)), centered=j.centered,
        coset=t.CosetID(int(j.coset)))


def cfg_id(j) -> str:
    """A test id naming the fields that set the layout."""
    parts = [j.profile.name.split("_")[0],
             "uep" + "".join(map(str, j.uep.band_profile)), f"{j.superframe_words}w"]
    if j.tile.w and j.tile.h:
        parts.append(f"tile{j.tile.w}x{j.tile.h}")
    if j.beacon.enabled:
        parts.append(f"beacon{j.beacon.words_period}s{j.beacon.band_slot}")
    if j.subword != jconfig.SubwordMode.S27:
        parts.append(j.subword.name)
    return "-".join(parts)


def raw_words(n, seed):
    """n seeded RAW words, trit 26 zero."""
    t = np.random.default_rng(seed).integers(0, 3, size=(n, 27))
    t[:, 26] = 0
    return (t.reshape(-1, 9, 3) * np.array([1, 3, 9])).sum(-1).astype(np.int8)


@functools.cache
def case(jcfg):
    """(raw words, the reference's wire words (N_SF, total, 9)) of a seeded
    stream whose tail superframe is zero-padded."""
    raw = raw_words(N_SF * jcfg.superframe_words - 37,
                    seed=jcfg.superframe_words + jcfg.beacon.words_period)
    words = np.array(jpipe.encode_stream_superframes(jnp.asarray(raw), jcfg,
                                                     sf_batch=SFB))
    return raw, words


def _hit(w, sf, row, band, delta):
    """Add ``delta`` (GF(27)) to body cell (row, band) of superframe sf."""
    w[sf, HW + row, band] = gf27.np_gf_add(w[sf, HW + row, band], delta)


def _geometry(jcfg):
    """(body height, beacon band or -1, beacon period, uniform bands)."""
    geom = jpipe.build_encode_layout(jcfg, jcfg.superframe_words).geom
    bc = jcfg.beacon
    b0 = bc.band_slot if bc.enabled else -1
    return geom, b0, bc.words_period, [b for b in range(9) if b != b0]


def damaged(jcfg, words):
    """Damaged copies of the wire words, by name:

    * ``correctable``: superframe 1 has one error in each of 4 uniform
      bands (distinct codewords) and, with a beacon, one in the beacon
      band's first codeword; superframe 3 has 2 header symbol errors;
    * ``spread``: correctable, and one error in superframe 0: 3 flagged
      superframes, one more than the fused window;
    * ``overcap``: correctable, and t+1 errors in one codeword of a
      uniform band in superframe 2;
    * ``beacon_cell``: (beacon configs) two beacon cells changed, nothing
      else."""
    geom, b0, p, uni = _geometry(jcfg)
    out = {}
    w = words.copy()
    for i, b in enumerate(uni[:4]):
        _hit(w, 1, 26 * i + 3 * i + 1, b, 5 + i)
    if b0 >= 0:
        _hit(w, 1, 1, b0, 7)             # payload row 1: codeword 0, coeff 0
    for cell in (4, 30):
        w[3, cell // 9, cell % 9] = (w[3, cell // 9, cell % 9] + 5) % 27
    out["correctable"] = w
    s = w.copy()
    _hit(s, 0, 5, uni[4], 2)
    out["spread"] = s
    o = w.copy()
    b = uni[5]
    for i, e in enumerate(OVERCAP[geom.ks[b]]):
        _hit(o, 2, 2 * 26 + i, b, e)
    out["overcap"] = o
    if b0 >= 0:
        c = words.copy()
        _hit(c, 0, 0, b0, 4)
        _hit(c, 2, 2 * p, b0, 9)
        out["beacon_cell"] = c
    return out


@functools.cache
def reference_sf(jcfg, name, rs_mode):
    """The reference's single-phase decode of damage case ``name`` ("clean"
    or a key of ``damaged``) per superframe: (RAW planes (N_SF, 9, n_out),
    ok (N_SF,)), headers RS-decoded on every page outside check, as its
    public strategies and its repair dispatches run it."""
    words = case(jcfg)[1] if name == "clean" else damaged(jcfg,
                                                          case(jcfg)[1])[name]
    _l, _d, _e, dec = jpipe._stream_fns(jcfg, SFB, rs_mode=rs_mode,
                                        ok_per_sf=True,
                                        hdr_all_pages=rs_mode != "check")
    raw_T, ok = dec(jnp.swapaxes(jnp.asarray(words), 1, 2))
    return np.asarray(raw_T), np.asarray(ok)


def reference_decode(jcfg, name, strategy):
    """The reference's ``decode_stream_superframes`` of damage case
    ``name``, from its per-superframe programs: check, paged, full and none
    are one program each with ok = all of its flags; auto is check, then
    the flagged superframes' paged decodes with ok = all of theirs
    (pipeline.py:1655-1693); fused is check, then the paged decodes of the
    first CAP superframes of a stable sort of the flags, ok failing when
    more were flagged (``_fused_auto_fn``).  Returns (RAW planes, ok);
    ``test_compositions_match_the_reference`` holds auto and fused to the
    reference's own dispatches."""
    if strategy not in ("auto", "fused"):
        raw_T, ok = reference_sf(jcfg, name, strategy)
        return raw_T, bool(ok.all())
    raw_T, ok_c = reference_sf(jcfg, name, "check")
    fix_T, ok_p = reference_sf(jcfg, name, "paged")
    raw_T = raw_T.copy()
    if strategy == "auto":
        idx = np.flatnonzero(~ok_c)
        ok = bool(ok_p[idx].all())
    else:
        idx = np.argsort(ok_c, kind="stable")[:CAP]
        ok = bool(ok_p[idx].all()) and int((~ok_c).sum()) <= len(idx)
    raw_T[idx] = fix_T[idx]
    return raw_T, ok


def _words_of(jcfg, raw_T):
    raw, _ = case(jcfg)
    sfw = jcfg.superframe_words
    return raw_T[:, :, :sfw].transpose(0, 2, 1).reshape(-1, 9)[:len(raw)]


def decode_both(jcfg, name, strategy):
    """The stream decode of damage case ``name`` by both packages; asserts
    equal outputs and ok and returns (RAW words, ok)."""
    raw, words = case(jcfg)
    words = words if name == "clean" else damaged(jcfg, words)[name]
    want_T, want_ok = reference_decode(jcfg, name, strategy)
    got, got_ok = port.decode_stream_superframes(
        torch.as_tensor(words), port_cfg(jcfg), len(raw), sf_batch=SFB,
        strategy=strategy, repair_cap=CAP, device=CPU)
    assert np.array_equal(got.numpy(), _words_of(jcfg, want_T))
    assert bool(got_ok) == want_ok
    if strategy not in ("auto", "fused"):
        # and the per-superframe flags of the single-phase decode
        words_T = torch.as_tensor(np.ascontiguousarray(
            words.transpose(0, 2, 1)))
        planes, ok_sf = codec_for(port_cfg(jcfg), CPU).decode_planes(
            words_T, strategy, SFB)
        sf_T, sf_ok = reference_sf(jcfg, name, strategy)
        assert np.array_equal(planes.numpy(), sf_T)
        assert np.array_equal(ok_sf.numpy(), sf_ok)
    return got.numpy(), bool(got_ok)


def check_encode(jcfg):
    raw, words = case(jcfg)
    got = port.encode_stream_superframes(torch.as_tensor(raw),
                                         port_cfg(jcfg), sf_batch=SFB,
                                         device=CPU)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), words)


def check_decode(jcfg, strategy):
    """Every damage case under one strategy, against the reference, and
    what each must give."""
    raw, words = case(jcfg)
    got, ok = decode_both(jcfg, "clean", strategy)
    assert ok and np.array_equal(got, raw)
    for name in damaged(jcfg, words):
        got, ok = decode_both(jcfg, name, strategy)
        if name == "beacon_cell":
            assert ok and np.array_equal(got, raw), name
        elif name == "correctable":
            assert ok == (strategy != "check"), name
            if strategy in REPAIRING:
                assert np.array_equal(got, raw), name
        elif name == "spread":
            assert ok == (strategy not in ("check", "fused")), name
        else:
            assert ok == (strategy == "none"), name


def check_frames_fused(jcfg):
    """Two frames of 2 superframes against the reference's fused decode of
    the 4 superframes of both (``reference_decode``)."""
    tcfg = port_cfg(jcfg)
    words = case(jcfg)[1]
    for name, w in (("clean", words), *damaged(jcfg, words).items()):
        ws = w.reshape(2, N_SF // 2, *w.shape[1:])
        want, want_ok = reference_decode(jcfg, name, "fused")
        want = want.reshape(2, N_SF // 2, *want.shape[1:])
        got, got_ok = port.decode_frames_fused(
            torch.as_tensor(ws), tcfg, sf_batch=SFB, repair_cap=CAP,
            device=CPU)
        assert np.array_equal(got.numpy(), want), name
        assert bool(got_ok) == want_ok, name
        planes = np.ascontiguousarray(ws.transpose(0, 1, 3, 2))
        got_p, ok_p = port.decode_frames_fused(
            torch.as_tensor(planes), tcfg, sf_batch=SFB, repair_cap=CAP,
            wire="planes", device=CPU)
        assert torch.equal(got_p, got) and bool(ok_p) == bool(got_ok), name


def check_compositions(jcfg):
    """The reference's own auto and fused dispatches (its public
    ``decode_stream_superframes``) equal ``reference_decode``'s
    compositions, and the port, on every damage case."""
    raw, words = case(jcfg)
    for name, w in (("clean", words), *damaged(jcfg, words).items()):
        for strategy in ("auto", "fused"):
            want, want_ok = jpipe.decode_stream_superframes(
                jnp.asarray(w), jcfg, len(raw), sf_batch=SFB,
                strategy=strategy, repair_cap=CAP)
            comp_T, comp_ok = reference_decode(jcfg, name, strategy)
            assert np.array_equal(np.asarray(want), _words_of(jcfg, comp_T))
            assert bool(want_ok) == comp_ok, (name, strategy)
            got, got_ok = decode_both(jcfg, name, strategy)
            assert np.array_equal(got, np.asarray(want))


def check_roundtrip_feed_fold(jcfg):
    """RAW planes built inside the pass by ``feed`` (a row of seeded source
    planes and a variant added mod 27), round-tripped under check, and cut
    to their first superframe_words words by ``fold``.  The feed is
    integer work: the pixel bridge is held to the reference in
    test_torch_bridge.py, and the reference's jitted ingest9 rounds some
    pixel pairs unlike its eager run (pair (86, 224), (130, 40), (178, 246)
    of this file's first pixel stream; ROADMAP, recorded divergences)."""
    sfw = jcfg.superframe_words
    src = np.stack([raw_words(sfw, seed=sfw + i).T for i in range(3)])
    sidx = np.array([2, 0, 1, 2], dtype=np.int32)
    var = np.array([3, 25, 7, 0], dtype=np.int8)

    def jmake(s, i, v):                          # one superframe (9, sfw)
        return ((s[i].astype(jnp.int16) + v) % 27).astype(jnp.int8)

    def tmake(s, i, v):                          # (b, 9, sfw)
        return ((s[i.long()].to(torch.int16) + v[:, None, None]) % 27) \
            .to(torch.int8)

    rt = jpipe.roundtrip_stream_fn(
        jcfg, SFB, rs_mode="check", raw_wire="planes",
        fold=lambda out: out[:, :sfw], feed=(jnp.asarray(src), jmake))
    want, want_ok = rt(jnp.asarray(sidx), jnp.asarray(var))
    got, got_ok = port.roundtrip_stream(
        (torch.as_tensor(sidx), torch.as_tensor(var)), port_cfg(jcfg),
        sf_batch=SFB, raw_wire="planes", feed=(torch.as_tensor(src), tmake),
        fold=lambda out: out[:, :, :sfw], device=CPU)
    assert got.shape == (N_SF, 9, sfw)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_ok.all()
    # lossless: trit 26 of the fed words is the only thing dropped
    fed = tmake(torch.as_tensor(src), torch.as_tensor(sidx),
                torch.as_tensor(var))
    fed[:, 8] %= 9
    assert torch.equal(got, fed)


def _as_dict(hdr):
    return None if hdr is None else dataclasses.asdict(hdr)


def check_profile(jcfg):
    """One frame of n words as one superframe: encode, then decode clean,
    with body errors (a beacon payload cell and a beacon cell among them)
    and with 2 header errors."""
    n = jcfg.superframe_words - 11
    raw = raw_words(n, seed=n)
    want = np.asarray(jpipe.encode_profile_from_raw(jnp.asarray(raw), jcfg, 5))
    got = port.encode_profile_from_raw(torch.as_tensor(raw), port_cfg(jcfg),
                                       5, device=CPU)
    assert np.array_equal(got.numpy(), want)
    _geom, b0, p, uni = _geometry(jcfg)
    dirty = want.copy()
    for i, b in enumerate(uni[:5]):
        dirty[HW + 30 * i + 2, b] = (dirty[HW + 30 * i + 2, b] + 1 + i) % 27
    if b0 >= 0:
        dirty[HW + p + 1, b0] = (dirty[HW + p + 1, b0] + 3) % 27
        dirty[HW + p, b0] = (dirty[HW + p, b0] + 3) % 27
    dirty[0, 2] = (dirty[0, 2] + 1) % 27
    dirty[4, 1] = (dirty[4, 1] + 2) % 27
    for w in (want, dirty):
        jw, jh, jok = jpipe.decode_profile_to_raw(jnp.asarray(w))
        tw, th, tok = port.decode_profile_to_raw(torch.as_tensor(w),
                                                 device=CPU)
        assert tok == jok and _as_dict(th) == _as_dict(jh)
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert tok and th.frame_seq == 5 and np.array_equal(tw.numpy()[:n],
                                                            raw)


def check_serve(jcfg):
    """``serve_codec_fns``: packed bytes and checksums of the encode, then
    (ok, wire checksum, out checksum) of the check decode of clean and
    damaged bytes."""
    raw, words = case(jcfg)
    tcfg = port_cfg(jcfg)
    sfw = jcfg.superframe_words
    chunks = np.zeros((N_SF * sfw, 9), np.int8)
    chunks[:len(raw)] = raw
    chunks = chunks.reshape(N_SF, sfw, 9)
    jenc, jdec, jgeom = jserve.serve_codec_fns(jcfg, len(raw), sf_batch=SFB)
    tenc, tdec, tgeom = tserve.serve_codec_fns(tcfg, len(raw), sf_batch=SFB,
                                               device=CPU)
    assert tgeom == jgeom
    jby, jck = jenc(jnp.asarray(chunks))
    tby, tck = tenc(torch.as_tensor(chunks))
    assert np.array_equal(tby.numpy(), np.asarray(jby))
    assert int(tck) == int(jck)
    dirty = damaged(jcfg, words)["correctable"]
    dby = np.asarray(jwp.pack_wire(jnp.asarray(dirty.transpose(0, 2, 1))))
    for by, ok in ((np.asarray(jby), True), (dby, False)):
        want = [np.asarray(x) for x in jdec(jnp.asarray(by))]
        got = [x.numpy() for x in tdec(torch.as_tensor(by))]
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        assert bool(got[0]) == ok


# ---------------------------------------------------------------------------
# the seven beacon configs of tests/test_pipeline_v3.py
# ---------------------------------------------------------------------------

IDS = [cfg_id(c) for c in BEACON_CFGS]


@pytest.mark.parametrize("jcfg", BEACON_CFGS, ids=IDS)
def test_encode(jcfg):
    check_encode(jcfg)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("jcfg", BEACON_CFGS, ids=IDS)
def test_decode(jcfg, strategy):
    check_decode(jcfg, strategy)


@pytest.mark.parametrize("jcfg", BEACON_CFGS, ids=IDS)
def test_frames_fused(jcfg):
    check_frames_fused(jcfg)


def test_compositions_match_the_reference():
    """On the flagship streaming layout (P5 26x26, luma UEP, beacon 13 in
    band 4)."""
    check_compositions(BEACON_CFGS[4])


@pytest.mark.parametrize("jcfg", BEACON_CFGS, ids=IDS)
def test_roundtrip_feed_fold(jcfg):
    check_roundtrip_feed_fold(jcfg)


@pytest.mark.parametrize("jcfg", BEACON_CFGS, ids=IDS)
def test_profile(jcfg):
    check_profile(jcfg)


@pytest.mark.parametrize("jcfg", BEACON_CFGS, ids=IDS)
def test_serve(jcfg):
    check_serve(jcfg)


def test_beacon_capacity_is_per_superframe():
    """The beacon band's paged repair holds 4 dirty pages a superframe, not
    4 a batch: a superframe with 5 dirty pages of its beacon band (91
    codewords, 6 pages) is flagged and keeps the fifth page as it is, one
    with 4 in the same micro-batch repairs; each as the reference's per
    superframe decode.  A uniform k-group holds C = min(g*npage, max(6, g))
    pages a superframe: in band 1's group (k=22, 5 bands of 7 pages) 7
    dirty pages are flagged and keep the seventh, band 2's first, as it
    is; 6 repair."""
    jcfg = jconfig.EncoderConfig(
        profile=jconfig.ProfileID.P2_RS26_22, uep=jconfig.uep_luma_priority(),
        beacon=jconfig.SparseBeaconCfg(13, 4, True), superframe_words=2048)
    geom, b0, p, _uni = _geometry(jcfg)
    assert geom.blocks[b0] > 5 * 16 and geom.blocks[1] > 5 * 16
    raw = raw_words(4 * 2048, seed=13)
    words = np.array(jpipe.encode_stream_superframes(jnp.asarray(raw), jcfg,
                                                     sf_batch=SFB))
    for sf, pages in ((0, 5), (1, 4)):
        for pg in range(pages):
            j = pg * 16 * 26 + 3                # payload cell of the page
            _hit(words, sf, j + j // (p - 1) + 1, b0, 1 + pg)
    for sf, pages in ((2, [(1, pg) for pg in range(6)] + [(2, 0)]),
                      (3, [(1, pg) for pg in range(6)])):
        for band, pg in pages:
            _hit(words, sf, pg * 16 * 26 + 3, band, 1 + pg)
    words_T = np.ascontiguousarray(words.transpose(0, 2, 1))
    _l, _d, _e, dec = jpipe._stream_fns(jcfg, SFB, rs_mode="paged",
                                        ok_per_sf=True, hdr_all_pages=True)
    want, want_ok = dec(jnp.asarray(words_T))
    got, got_ok = SuperframeCodec(port_cfg(jcfg), device=CPU).paged(
        torch.as_tensor(words_T), SFB)
    assert np.asarray(want_ok).tolist() == [False, True, False, True]
    assert got_ok.tolist() == [False, True, False, True]
    assert np.array_equal(got.numpy(), np.asarray(want))
    n_out = got.shape[-1]
    for sf in range(4):
        part = got.numpy()[sf, :, :2048].T
        assert np.array_equal(part, raw[sf * 2048:(sf + 1) * 2048]) \
            == bool(sf % 2)
    assert n_out >= 2048


REJECTED = {
    # every row of the beacon band would carry the beacon
    "period1_with_data": dict(beacon=(1, 3)),
    # the header stores min(period, 26)
    "period27": dict(beacon=(27, 3)),
    # the header stores each tile side mod 27
    "tile27x1": dict(profile="P5_RS26_22_2D", tile=(27, 1)),
    # the header carries one trit per band
    "band_profile_p4": dict(uep=(3, 1, 1, 1, 1, 1, 1, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejected_layouts_raise(name):
    """Layouts the header cannot carry raise ValueError in both packages,
    from the stream encode and from the profile encode."""
    kw = REJECTED[name]

    def one(m):
        args = {"superframe_words": 256,
                "profile": m.ProfileID[kw.get("profile", "P2_RS26_22")]}
        if "beacon" in kw:
            args["beacon"] = m.SparseBeaconCfg(*kw["beacon"], True)
        if "tile" in kw:
            args["tile"] = m.Tile2D(*kw["tile"])
        if "uep" in kw:
            args["uep"] = m.UEPLayout(kw["uep"])
        return m.EncoderConfig(**args)

    raw = raw_words(300, seed=1)
    jcfg, tcfg = one(jconfig), one(tconfig)
    with pytest.raises(ValueError):
        jpipe.encode_stream_superframes(jnp.asarray(raw), jcfg)
    with pytest.raises(ValueError):
        jpipe.encode_profile_from_raw(jnp.asarray(raw), jcfg)
    with pytest.raises(ValueError):
        port.encode_stream_superframes(raw, tcfg, device=CPU)
    with pytest.raises(ValueError):
        port.encode_profile_from_raw(raw, tcfg, device=CPU)


def test_no_performance_warning_for_tiles_off_234():
    """A P5 tile whose width does not divide 234 (8x4 here) draws the
    reference's PerformanceWarning, which quotes a TPU frame rate; the port
    builds the same layout without a warning (a recorded divergence)."""
    jcfg = jconfig.EncoderConfig(profile=jconfig.ProfileID.P5_RS26_22_2D,
                                 tile=jconfig.Tile2D(8, 4),
                                 superframe_words=200)
    with pytest.warns(jpipe.PerformanceWarning):
        jl = jpipe.build_encode_layout(jcfg, 200)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tl = tpipe.build_encode_layout(port_cfg(jcfg), 200)
    assert tl.geom.__dict__ == jl.geom.__dict__
