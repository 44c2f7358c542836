"""The port's RGB entry, ``SuperframeCodec.encode_rgb``/``decode_rgb``, on
the CPU: bit for bit against the benchmark's plain references
(``t3bench/reference/pixels.py`` for the pixel schema,
``t3bench/reference/codec.py`` for the wire) on seeded frames, a frame
whose last superframe is padded, an odd pixel count and the boundary
pixels; the wire against the JAX package's encode of its eager
``ingest9_planes``; a planted lower-precision colour row caught by the
reference; and the spans and counter of the RGB calls.  Tolerance: zero.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import rgb_ties

from t3bench.lib import port as bench_port
from t3bench.reference import codec as ref
from t3bench.reference import pixels
from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu.ops import wordcodec as JW
from ternary_image_codec_tpu_torch.codec import codec_for
from ternary_image_codec_tpu_torch.ops import quant as Q
from ternary_image_codec_tpu_torch.ops import wordcodec as W
from ternary_image_codec_tpu_torch.runtime import tracing

SFW = 256
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "t3bench", "configs", "p2_8k_rgb.json")) as f:
    CFG = dict(json.load(f), superframe_words=SFW)
PCFG = bench_port.encoder_config(CFG)
JCFG = jconfig.EncoderConfig(profile=jconfig.ProfileID.P2_RS26_22,
                             uep=jconfig.uep_luma_priority(),
                             superframe_words=SFW)


@pytest.fixture(scope="module")
def codec():
    return codec_for(PCFG, "cpu")


@pytest.fixture(autouse=True)
def empty_report():
    tracing.report(reset=True)
    yield
    tracing.report(reset=True)


def frame(h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8)


def expected(rgb):
    """The references' (wire planes, RGB) of one frame."""
    h, w = rgb.shape[:2]
    raw = pixels.superframes(pixels.ingest(rgb), SFW)
    back = pixels.words(ref.expected_decode(raw, CFG), SFW)
    return ref.encode(raw, CFG), pixels.egress(back, h, w)


@pytest.fixture(scope="module")
def boundary():
    """A frame of boundary pixels: every triple of 0, 1, 127, 128, 254,
    255, and the triples at the rows' tie points, where contracting the
    last product and sum of a row into one rounding (an FMA) moves the
    lround: each row's value held exactly beside that single rounding
    (float64 before the one cast to float32)."""
    return rgb_ties.boundary_pixels()[None]             # (1, n, 3)


@pytest.mark.parametrize("h,w", [(16, 32), (23, 45), (40, 70)],
                         ids=["one_superframe", "odd_padded", "padded"])
def test_rgb_round_trip_is_the_reference(codec, h, w):
    rgb = frame(h, w, h * w)
    wire = codec.encode_rgb(rgb)
    want_wire, want_rgb = expected(rgb)
    assert wire.dtype == torch.int8 and torch.equal(wire, want_wire)
    out, ok = codec.decode_rgb(wire, "auto", size=(h, w))
    assert bool(ok) and out.dtype == torch.uint8
    assert torch.equal(out, want_rgb)


def test_boundary_pixels(codec, boundary):
    n = boundary.shape[1]
    wire = codec.encode_rgb(boundary)
    want_wire, want_rgb = expected(boundary)
    assert torch.equal(wire, want_wire)
    out, ok = codec.decode_rgb(wire, size=(1, n))
    assert bool(ok) and torch.equal(out, want_rgb)
    # the frame bridges are the streaming bridges' chains
    planes = W.ingest9_planes(boundary[0, :n // 2 * 2].reshape(-1, 2, 3)
                              .permute(2, 1, 0))
    words = torch.empty((-(-n // 2), 9), dtype=torch.int8)
    assert torch.equal(W.ingest9(boundary, words)[:n // 2], planes.T)
    assert torch.equal(W.egress9(planes).reshape(-1, 3),
                       W.egress9_planes(planes).permute(2, 1, 0)
                       .reshape(-1, 3))


def test_damaged_wire_is_repaired(codec):
    rgb = frame(23, 45, 5)
    wire = codec.encode_rgb(rgb).clone()
    wire[1, 4, 10] = (wire[1, 4, 10] + 5) % 27
    out, ok = codec.decode_rgb(wire, "auto", size=(23, 45))
    assert bool(ok) and torch.equal(out, expected(rgb)[1])


def test_wire_is_the_jax_encode_of_its_eager_ingest(codec):
    """The JAX package's eager ``ingest9_planes`` (its jitted program
    rounds some pixel pairs otherwise) and its encode."""
    rgb = frame(16, 64, 11)                             # 2 superframes
    planes = np.ascontiguousarray(rgb.reshape(-1, 2, 3).permute(2, 1, 0)
                                  .numpy())
    words = np.asarray(JW.ingest9_planes(jnp.asarray(planes))).T
    want = np.asarray(jpipe.encode_stream_superframes(
        jnp.asarray(words), JCFG, sf_batch=8))
    got = codec.encode_rgb(rgb)
    assert np.array_equal(got.transpose(1, 2).numpy(), want)


ROWS = Q.ycbcr_rows


def rows_f16(r, g, b):
    h = [v.to(torch.float16) for v in (r, g, b)]
    return [v.to(torch.float32) for v in ROWS(*h)]


def rows_fused(r, g, b):
    y, cb, cr = ROWS(r, g, b)
    head = Q.f32(0.299) * r + Q.f32(0.587) * g
    return torch.addcmul(head, b, Q.f32(0.114)), cb, cr


@pytest.mark.parametrize("rows", [rows_f16, rows_fused],
                         ids=["float16", "addcmul"])
def test_lower_precision_rows_are_caught(codec, boundary, monkeypatch, rows):
    want_wire, _ = expected(boundary)
    assert torch.equal(codec.encode_rgb(boundary), want_wire)
    monkeypatch.setattr(Q, "ycbcr_rows", rows)
    assert not torch.equal(codec.encode_rgb(boundary), want_wire)


def test_sizes_and_types(codec):
    rgb = frame(16, 32, 1)
    with pytest.raises(ValueError):
        codec.encode_rgb(rgb.to(torch.int16))
    with pytest.raises(ValueError):
        codec.encode_rgb(rgb.reshape(-1, 3))
    wire = codec.encode_rgb(rgb)
    with pytest.raises(TypeError):
        codec.decode_rgb(wire)                  # the wire carries no size
    with pytest.raises(ValueError):
        codec.decode_rgb(wire, size=(40, 70))
    out, _ = codec.decode_rgb(wire, "fused", size=(16, 32))
    assert torch.equal(out, expected(rgb)[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            codec_for(PCFG)


def test_spans_and_pixel_counter(codec):
    rgb = frame(23, 45, 3)
    out, ok = codec.decode_rgb(codec.encode_rgb(rgb), size=(23, 45))
    assert tracing.report() == {"spans": {}, "counts": {}}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out, ok = codec.decode_rgb(codec.encode_rgb(rgb), size=(23, 45))
    rep = tracing.report(reset=True)
    spans = set(rep["spans"])
    assert {"t3.encode_rgb", "t3.encode_rgb/t3.ingest",
            "t3.encode_rgb/t3.encode", "t3.decode_rgb",
            "t3.decode_rgb/t3.decode", "t3.decode_rgb/t3.egress",
            "t3.decode_rgb/t3.decode/t3.sync.auto"} <= spans
    assert not {p for p in spans
                if not p.startswith(("t3.encode_rgb", "t3.decode_rgb"))}
    for p in ("t3.encode_rgb", "t3.decode_rgb", "t3.encode_rgb/t3.ingest",
              "t3.decode_rgb/t3.egress"):
        assert rep["spans"][p]["calls"] == 1
    assert rep["counts"]["t3.pixels"] == 2 * 23 * 45
