"""The port's superframe stream vs the JAX package's, end to end.

Encode, decode under every ported strategy (check, paged, auto, fused) and
the fused roundtrip, on seeded numpy RAW words: clean, with correctable
body and header damage, with damage beyond a codeword's capacity, with
more flagged superframes than the fused repair window, and with a window
wider than the stream.  Tolerance: zero, ok flags included.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu_torch import config as tconfig
from ternary_image_codec_tpu_torch import (SuperframeCodec,
                                           decode_stream_superframes,
                                           encode_stream_superframes,
                                           roundtrip_stream)
from ternary_image_codec_tpu_torch.ops import gf27

SFB = 8          # sf_batch shared with the reference's cached programs
N_SF = 6
CPU = "cpu"      # the port defaults to the card; the CPU must be asked for


def _cfgs(profile, sfw):
    """(JAX config, port config), each from its own package's config
    module with the same arguments."""
    return tuple(m.EncoderConfig(profile=m.ProfileID[profile],
                                 uep=m.uep_luma_priority(),
                                 superframe_words=sfw)
                 for m in (jconfig, tconfig))


JCFG, CFG = _cfgs("P2_RS26_22", 256)
JCFG_P1, CFG_P1 = _cfgs("P1_RS26_24", 512)
JAX_OF = {CFG: JCFG, CFG_P1: JCFG_P1}
HW = jpipe.HEADER_WORDS


def _raw(cfg, n_sf=N_SF, seed=0):
    r = np.random.default_rng(seed)
    t = r.integers(0, 3, size=(n_sf * cfg.superframe_words, 27))
    t[:, 26] = 0
    return (t.reshape(-1, 9, 3) * np.array([1, 3, 9])).sum(-1).astype(np.int8)


def _words(cfg, raw):
    """The reference's wire words (n_sf, total, 9) for raw."""
    return np.array(jpipe.encode_stream_superframes(jnp.asarray(raw),
                                                    JAX_OF[cfg], sf_batch=SFB))


def _body_errors(w, sf, seed, n=8):
    """n symbol errors in distinct bands of superframe sf's body."""
    r = np.random.default_rng(seed)
    bands = r.choice(9, n, replace=False)
    cols = HW + r.choice(w.shape[1] - HW, n, replace=False)
    w[sf, cols, bands] = (w[sf, cols, bands] + r.integers(1, 27, n)) % 27


def _header_errors(w, sf, seed):
    """2 symbol errors among the 52 used header cells of superframe sf."""
    cells = np.random.default_rng(seed).choice(52, 2, replace=False)
    w[sf, cells // 9, cells % 9] = (w[sf, cells // 9, cells % 9] + 5) % 27


def _overcap(w, sf):
    """3 GF(27) errors in one k=22 codeword (band 1, block 2): beyond t=2,
    and a pattern the decoder flags."""
    cols = HW + 2 * 26 + np.arange(3)
    w[sf, cols, 1] = gf27.np_gf_add(w[sf, cols, 1], [1, 1, 2])


def _decode_both(words, cfg, n_raw, strategy, repair_cap=None):
    want, want_ok = jpipe.decode_stream_superframes(
        jnp.asarray(words), JAX_OF[cfg], n_raw, sf_batch=SFB,
        strategy=strategy, repair_cap=repair_cap)
    got, got_ok = decode_stream_superframes(
        torch.as_tensor(words), cfg, n_raw, sf_batch=SFB, strategy=strategy,
        repair_cap=repair_cap, device=CPU)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bool(got_ok) == bool(want_ok)
    return got.numpy(), bool(got_ok)


@pytest.mark.parametrize("cfg", [CFG, CFG_P1], ids=["p2_256", "p1_512"])
def test_encode_matches_reference(cfg):
    raw = _raw(cfg, n_sf=3)[:-100]         # tail superframe zero-padded
    want = np.asarray(jpipe.encode_stream_superframes(
        jnp.asarray(raw), JAX_OF[cfg], sf_batch=SFB))
    got = encode_stream_superframes(torch.as_tensor(raw), cfg, sf_batch=SFB,
                                    device=CPU)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("strategy", ["check", "paged", "auto", "fused"])
def test_decode_clean(strategy):
    raw = _raw(CFG)
    got, ok = _decode_both(_words(CFG, raw), CFG, len(raw), strategy,
                           repair_cap=4 if strategy == "fused" else None)
    assert ok and np.array_equal(got, raw)


@pytest.mark.parametrize("strategy", ["check", "paged", "auto", "fused"])
def test_decode_correctable_damage(strategy):
    raw = _raw(CFG, seed=1)
    w = _words(CFG, raw)
    _body_errors(w, 1, seed=11)
    _body_errors(w, 3, seed=12, n=3)
    _header_errors(w, 3, seed=13)
    _header_errors(w, 5, seed=14)
    got, ok = _decode_both(w, CFG, len(raw), strategy,
                           repair_cap=4 if strategy == "fused" else None)
    # check only verifies; the repairing strategies restore the input
    assert ok == (strategy != "check")
    if strategy != "check":
        assert np.array_equal(got, raw)


@pytest.mark.parametrize("strategy", ["paged", "auto", "fused"])
def test_decode_overcap_fails_safe(strategy):
    raw = _raw(CFG, seed=2)
    w = _words(CFG, raw)
    _body_errors(w, 1, seed=21)
    _overcap(w, 4)
    got, ok = _decode_both(w, CFG, len(raw), strategy,
                           repair_cap=4 if strategy == "fused" else None)
    assert not ok
    # every superframe but the overcap one still decodes to its input
    sfw = CFG.superframe_words
    keep = np.ones(len(raw), dtype=bool)
    keep[4 * sfw:5 * sfw] = False
    assert np.array_equal(got[keep], raw[keep])


def test_per_superframe_flags_under_overcap():
    """Per-superframe ok of the paged decode, and its outputs where the
    reference's flag is True."""
    raw = _raw(CFG, seed=2)
    w = _words(CFG, raw)
    _body_errors(w, 1, seed=21)
    _overcap(w, 4)
    words_T = np.ascontiguousarray(w.transpose(0, 2, 1))
    _l, _d, _e, dec = jpipe._stream_fns(JCFG, SFB, rs_mode="paged",
                                        ok_per_sf=True, hdr_all_pages=True)
    want, want_ok = dec(jnp.asarray(words_T))
    want, want_ok = np.asarray(want), np.asarray(want_ok)
    got, got_ok = SuperframeCodec(CFG, device=CPU).paged(
        torch.as_tensor(words_T), SFB)
    assert np.array_equal(got_ok.numpy(), want_ok)
    assert not want_ok[4] and want_ok[[0, 1, 2, 3, 5]].all()
    assert np.array_equal(got.numpy()[want_ok], want[want_ok])


def test_fused_window_overflow_fails_safe():
    raw = _raw(CFG, seed=3)
    w = _words(CFG, raw)
    for sf, seed in ((0, 31), (2, 32), (5, 33)):
        _body_errors(w, sf, seed=seed, n=2)
    _got, ok = _decode_both(w, CFG, len(raw), "fused", repair_cap=2)
    assert not ok                     # 3 flagged > window of 2


def test_fused_window_wider_than_stream():
    raw = _raw(CFG, seed=4)
    w = _words(CFG, raw)
    _body_errors(w, 2, seed=41)
    _header_errors(w, 4, seed=42)
    got, ok = _decode_both(w, CFG, len(raw), "fused", repair_cap=SFB)
    assert ok and np.array_equal(got, raw)


@pytest.mark.parametrize("cap", [0, -3])
def test_repair_cap_nonpositive_raises(cap):
    # Divergence from the reference: its decode_stream_superframes treats
    # repair_cap=0 as unset (`repair_cap if repair_cap else ...`) and falls
    # back to the T3_REPAIR_SFB default; the port rejects any cap <= 0.
    raw = _raw(CFG, n_sf=2)
    words = encode_stream_superframes(torch.as_tensor(raw), CFG, device=CPU)
    with pytest.raises(ValueError):
        decode_stream_superframes(words, CFG, len(raw), strategy="fused",
                                  repair_cap=cap, device=CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["check", "paged", "auto", "fused"])
def test_card_decodes_contiguous_words(strategy):
    """Contiguous (n_sf, total, 9) words, as a file or the reference hands
    them over, decode on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this there)")
    raw = _raw(CFG, seed=1)
    w = _words(CFG, raw)
    _body_errors(w, 1, seed=11)
    _header_errors(w, 3, seed=13)
    kw = dict(sf_batch=SFB, strategy=strategy,
              repair_cap=4 if strategy == "fused" else None)
    want, want_ok = decode_stream_superframes(torch.as_tensor(w), CFG,
                                              len(raw), device=CPU, **kw)
    got, got_ok = decode_stream_superframes(
        torch.as_tensor(w, device="cuda"), CFG, len(raw), **kw)
    assert torch.equal(got.cpu(), want) and bool(got_ok) == bool(want_ok)


def test_roundtrip_matches_reference():
    raw = _raw(CFG, seed=5)
    chunks = raw.reshape(N_SF, CFG.superframe_words, 9)
    rt = jpipe.roundtrip_stream_fn(JCFG, SFB)
    want, want_ok = rt(jnp.asarray(chunks))
    got, got_ok = roundtrip_stream(torch.as_tensor(chunks), CFG, sf_batch=SFB,
                                   device=CPU)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert got_ok.all()
    # fold: a per-superframe checksum instead of the planes
    sums, ok = roundtrip_stream(
        torch.as_tensor(chunks), CFG, sf_batch=4, device=CPU,
        fold=lambda x: x.to(torch.int64).sum(dim=(1, 2)))
    assert np.array_equal(sums.numpy(),
                          np.asarray(want).astype(np.int64).sum(axis=(1, 2)))
    assert ok.all()
