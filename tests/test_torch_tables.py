"""PyTorch port vs the JAX package: every host-built table, bit for bit.

The port re-derives each constant (it imports no jax); these tests hold
the derivations against the reference's arrays, and hold a codec built
from its own tables against one built from the reference's
(``tables_from_reference``).  Tolerance: zero (integer tables).
"""
import numpy as np
import pytest
import torch

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.ops import gf27 as jgf27
from ternary_image_codec_tpu.ops import header as jheader
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu.ops import rs as jrs
from ternary_image_codec_tpu.ops import scramble as jscramble
from ternary_image_codec_tpu_torch import config as tconfig
from ternary_image_codec_tpu_torch import SuperframeCodec, tables_from_reference
from ternary_image_codec_tpu_torch.ops import gf27, header, rs, scramble
from ternary_image_codec_tpu_torch.ops import pipeline as tpipe

CPU = "cpu"      # the port defaults to the card; the CPU must be asked for


def _cfgs(profile, sfw, seed=(1, 1, 1)):
    """(JAX config, port config), each from its own package's config
    module with the same arguments."""
    return tuple(m.EncoderConfig(profile=m.ProfileID[profile],
                                 uep=m.uep_luma_priority(),
                                 superframe_words=sfw,
                                 seed=m.ScramblerSeed(*seed))
                 for m in (jconfig, tconfig))


def _headers(m):
    """Two SuperframeHeaders of config module m: the default and one with
    every field the stream sets moved off its default."""
    return (m.SuperframeHeader(),
            m.SuperframeHeader(uep=m.uep_luma_priority(), frame_seq=1234,
                               seed=m.ScramblerSeed(2, 0, 1)))


def _jax_stream_header(jcfg):
    """The reference's stream header of jcfg (as its _stream_fns builds it)."""
    return jconfig.SuperframeHeader(
        profile=jcfg.profile, uep=jcfg.uep, tile=jcfg.tile, seed=jcfg.seed,
        beacon=jcfg.beacon, subword=jcfg.subword, centered=jcfg.centered,
        coset=jcfg.coset)


CONFIGS = {
    "p2_luma_256": _cfgs("P2_RS26_22", 256),
    "p1_luma_512_seed210": _cfgs("P1_RS26_24", 512, seed=(2, 1, 0)),
}


def _jax_reference_tables(cfg):
    """The tables the JAX package computes for cfg, as numpy arrays."""
    lay = jpipe.build_encode_layout(cfg, cfg.superframe_words)
    H = lay.geom.H
    ks = sorted({18, *lay.geom.ks})
    return {
        "rs_pm": {k: {name: np.asarray(v) for name, v
                      in jrs._matrices_pm(k).items()} for k in ks},
        "header_words": np.asarray(lay.header_words),
        "off_enc": np.asarray(jpipe._pm_offsets(H, cfg.seed, 1.0)),
        "off_dec": np.asarray(jpipe._pm_offsets(H, cfg.seed, -1.0)),
        "unpack702_bw": np.asarray(jpipe._unpack702_bw()),
    }


def test_field_tables():
    ref, got = jgf27.tables(), gf27.tables()
    for name in ("prim", "exp", "log", "mul", "inv"):
        assert np.array_equal(np.asarray(ref[name]), got[name]), name
    sel = np.random.default_rng(0).integers(0, 27, size=(6, 4))
    assert np.array_equal(jgf27.gf3_linmap(sel), gf27.gf3_linmap(sel))
    assert np.array_equal(jgf27.gf3_linmap_pm(sel), gf27.gf3_linmap_pm(sel))


@pytest.mark.parametrize("k", [18, 20, 22, 24])
def test_rs_matrices(k):
    ref, got = jrs._matrices(k), rs._matrices(k)
    for name in ("g", "G", "G3", "S3", "CH3", "OM3", "SP3"):
        assert np.array_equal(np.asarray(ref[name]), got[name]), name
    ref_pm, got_pm = jrs._matrices_pm(k), rs._matrices_pm(k)
    for name in rs.PM_KEYS:
        assert np.array_equal(np.asarray(ref_pm[name]), got_pm[name]), name
    data = np.random.default_rng(k).integers(0, 27, size=(5, k))
    assert np.array_equal(jrs.np_encode(data, k), rs.np_encode(data, k))


@pytest.mark.parametrize("seed", [(1, 1, 1), (2, 1, 0), (0, 2, 1), (2, 2, 2)])
def test_scramble_offsets(seed):
    a, b, s0 = seed
    assert np.array_equal(jscramble.np_offsets(40, a, b, s0),
                          scramble.np_offsets(40, a, b, s0))
    assert np.array_equal(np.asarray(jscramble.offsets(40, a, b, s0)),
                          scramble.offsets(40, a, b, s0).numpy())
    for sign in (1, -1):
        assert np.array_equal(
            np.asarray(jpipe._pm_offsets(30, jconfig.ScramblerSeed(a, b, s0),
                                         float(sign))),
            scramble.pm_offsets(30, tconfig.ScramblerSeed(a, b, s0), sign))


def test_header_pack():
    for jh, th in zip(_headers(jconfig), _headers(tconfig)):
        assert np.array_equal(jheader.pack(jh), header.pack(th))
    assert np.array_equal(jheader.crc12_matrix(), header.crc12_matrix())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts(name):
    jcfg, cfg = CONFIGS[name]
    jl = jpipe.build_encode_layout(jcfg, jcfg.superframe_words)
    tl, tdl = tpipe.stream_layouts(cfg)
    for field in ("n_raw_words", "n_sy", "total_words"):
        assert getattr(jl, field) == getattr(tl, field), field
    assert jl.geom.__dict__ == tl.geom.__dict__
    assert np.array_equal(jl.header_words, tl.header_words)
    jdl = jpipe.build_decode_layout(_jax_stream_header(jcfg), tl.geom.H)
    assert (jdl.L_out, jdl.n_out_words) == (tdl.L_out, tdl.n_out_words)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_inputs_match_jax(name):
    jcfg, cfg = CONFIGS[name]
    ref, got = _jax_reference_tables(jcfg), tpipe.reference_inputs(cfg)
    assert sorted(ref["rs_pm"]) == sorted(got["rs_pm"])
    for k in ref["rs_pm"]:
        for key in rs.PM_KEYS:
            assert np.array_equal(ref["rs_pm"][k][key], got["rs_pm"][k][key])
    for key in ("header_words", "off_enc", "off_dec", "unpack702_bw"):
        assert np.array_equal(ref[key], got[key]), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_codec_from_reference_tables(name):
    jcfg, cfg = CONFIGS[name]
    own = SuperframeCodec(cfg, device=CPU).tables()
    carried = tables_from_reference(_jax_reference_tables(jcfg), cfg,
                                    device=CPU).tables()
    assert sorted(own) == sorted(carried)
    for key in own:
        assert own[key].dtype == carried[key].dtype, key
        assert torch.equal(own[key], carried[key]), key
