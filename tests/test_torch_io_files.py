"""The port's image files, format adapters and video writer (io/image.py's
PIL leg, io/formats.py, io/video.py) against the JAX package on the CPU.

Files written by both packages from the same pixels or words must be
byte-equal, and words equal.  The optional libraries follow
tests/test_absent_libs.py: HEIF/AVIF and real EXR bindings and ffmpeg are
skipped where absent, the EXR branch also runs against
tests/test_video_formats.py's fake of the classic OpenEXR bindings, and
the writer's stub leg runs with ffmpeg hidden.
"""
import os
import sys

import numpy as np
import pytest
import torch

from ternary_image_codec_tpu.config import SubwordMode as RSub
from ternary_image_codec_tpu.io import formats as RF
from ternary_image_codec_tpu.io import image as RI
from ternary_image_codec_tpu.io import video as RV
from ternary_image_codec_tpu_torch.config import SubwordMode
from ternary_image_codec_tpu_torch.io import formats as F
from ternary_image_codec_tpu_torch.io import image as I
from ternary_image_codec_tpu_torch.io import video as V

from test_absent_libs import _golden, _pattern_rgb
from test_video_formats import _fake_openexr, _frames

S15, S21 = SubwordMode.S15, SubwordMode.S21


def _rgb(w=24, h=16, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# --- PIL loaders and savers ------------------------------------------------


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_savers_byte_equal_and_loader(kind, tmp_path):
    rgb = _rgb()
    ours, ref = str(tmp_path / f"p.{kind}"), str(tmp_path / f"r.{kind}")
    save = I.save_image_png if kind == "png" else I.save_image_jpg
    save(ours, torch.as_tensor(rgb))               # a tensor comes off its device
    (RI.save_image_png if kind == "png" else RI.save_image_jpg)(ref, rgb)
    assert _same_file(ours, ref)
    got = I.load_image_rgb8(ours)
    assert got.dtype == np.uint8 and got.flags.writeable
    assert np.array_equal(got, RI.load_image_rgb8(ref))
    if kind == "png":
        assert np.array_equal(got, rgb)


@pytest.mark.parametrize("sub,centered,codec", [
    (S15, False, "word13"), (S15, False, "word9"), (SubwordMode.S18, True,
                                                    "word13")])
def test_image_file_words_roundtrip(sub, centered, codec, tmp_path,
                                    monkeypatch):
    """image_to_words_subword / words_to_image_subword against the
    reference's, the S27 canvas shrunk (as tests/test_torch_bridge.py) so
    the centred case stays small."""
    from ternary_image_codec_tpu import config as rcfg
    from ternary_image_codec_tpu_torch import config as pcfg
    from ternary_image_codec_tpu_torch.io import image as pimage
    small = {RSub.S27: (128, 72), RSub.S18: (96, 48), RSub.S15: (64, 40)}
    for mod in (rcfg, RI, pcfg, pimage):
        monkeypatch.setattr(mod, "std_res_for", lambda m: small[RSub(int(m))])
    png = str(tmp_path / "in.png")
    I.save_image_png(png, _rgb(50, 30, 3))
    words, dims = I.image_to_words_subword(png, sub, centered, codec, "cpu")
    rwords, rdims = RI.image_to_words_subword(png, RSub(int(sub)), centered,
                                              codec)
    assert dims == rdims
    assert np.array_equal(words.numpy(), np.asarray(rwords))
    w, h = small[RSub(int(sub))]
    ours, ref = str(tmp_path / "o.png"), str(tmp_path / "r.png")
    I.words_to_image_subword(words, sub, w, h, ours, codec, device="cpu")
    RI.words_to_image_subword(rwords, RSub(int(sub)), w, h, ref, codec)
    assert _same_file(ours, ref)


# --- format adapters -------------------------------------------------------


def test_format_probes_equal():
    for fmt in ("heif", "avif", "tiff", "exr", "TIFF", "nope"):
        assert F.format_available(fmt) == RF.format_available(fmt)
    assert F.format_available("tiff")


def test_tiff_words_and_file(tmp_path):
    rgb = _rgb(854, 480, 1)
    src = str(tmp_path / "in.tiff")
    from PIL import Image
    Image.fromarray(rgb, "RGB").save(src, format="TIFF")
    words, dims = F.image_file_to_words(src, "tiff", S15, False,
                                        device="cpu")
    rwords, rdims = RF.image_file_to_words(src, "tiff", RSub.S15, False)
    assert dims == rdims == (854, 480)
    assert np.array_equal(words.numpy(), rwords)
    ours, ref = str(tmp_path / "o.tiff"), str(tmp_path / "r.tiff")
    F.words_to_image_file(words, "tiff", S15, 854, 480, ours, device="cpu")
    RF.words_to_image_file(rwords, "tiff", RSub.S15, 854, 480, ref)
    assert _same_file(ours, ref)


def test_unknown_format_and_missing_heif(tmp_path):
    with pytest.raises(F.FormatUnavailable):
        F.image_file_to_words(str(tmp_path / "x.bmp"), "bmp", S15, False,
                              device="cpu")
    with pytest.raises(F.FormatUnavailable):
        F._save("bmp", str(tmp_path / "x.bmp"), _rgb())
    if F.format_available("heif"):
        pytest.skip("pillow-heif present; its stub path is not reachable")
    for fmt in ("heif", "avif"):
        with pytest.raises(F.FormatUnavailable):
            F.image_file_to_words(str(tmp_path / f"x.{fmt}"), fmt, S15,
                                  False, device="cpu")
        with pytest.raises(F.FormatUnavailable):
            F._save(fmt, str(tmp_path / f"x.{fmt}"), _rgb())


def test_heif_when_present(tmp_path):
    pillow_heif = pytest.importorskip("pillow_heif")
    pillow_heif.register_heif_opener()
    p = str(tmp_path / "g.heif")
    F._save("heif", p, _pattern_rgb())
    assert np.array_equal(F._load_heif_avif(p), RF._load_heif_avif(p))
    words, dims = F.image_file_to_words(p, "heif", S15, False, device="cpu")
    rwords, rdims = RF.image_file_to_words(p, "heif", RSub.S15, False)
    assert dims == rdims and np.array_equal(words.numpy(), rwords)


def test_exr_when_present(tmp_path):
    pytest.importorskip("OpenEXR")
    g = _golden()
    p = str(tmp_path / "g.exr")
    F._save("exr", p, _pattern_rgb())
    assert np.array_equal(F._load_exr(p), _pattern_rgb())
    words, dims = F.image_file_to_words(p, "exr", S15, False, device="cpu")
    assert np.array_equal(words.numpy(), g["exr_words"])
    assert dims == tuple(g["exr_wh"])


@pytest.fixture
def fake_exr(monkeypatch):
    store = {}
    mod, imath = _fake_openexr(store)
    monkeypatch.setitem(sys.modules, "OpenEXR", mod)
    monkeypatch.setitem(sys.modules, "Imath", imath)
    return store


def test_exr_through_openexr_bindings(fake_exr):
    """Through the classic bindings (faked): the saved planes equal the
    reference's, the load is lossless for u8 data, and the words equal the
    committed golden of tests/test_absent_libs.py."""
    rgb = _pattern_rgb()
    F._save("exr", "ours.exr", rgb)
    RF._save("exr", "ref.exr", rgb)
    for c in "RGB":
        assert np.array_equal(fake_exr["ours.exr"]["planes"][c],
                              fake_exr["ref.exr"]["planes"][c])
    assert np.array_equal(F._load_exr("ours.exr"), rgb)
    g = _golden()
    words, dims = F.image_file_to_words("ours.exr", "exr", S15, False,
                                        device="cpu")
    assert np.array_equal(words.numpy(), g["exr_words"])
    assert dims == tuple(g["exr_wh"])
    # grey Y files replicate; HDR overshoot clamps
    v = np.asarray([[-0.5, 0.0], [0.5, 3.7]], dtype=np.float32)
    fake_exr["y.exr"] = {"size": (2, 2), "planes": {"Y": v}}
    assert np.array_equal(F._load_exr("y.exr"), RF._load_exr("y.exr"))
    F.words_to_image_file(words, "exr", S15, *dims, "back.exr", device="cpu")
    RF.words_to_image_file(g["exr_words"], "exr", RSub.S15, *dims, "rb.exr")
    for c in "RGB":
        assert np.array_equal(fake_exr["back.exr"]["planes"][c],
                              fake_exr["rb.exr"]["planes"][c])


# --- video -----------------------------------------------------------------


def test_video_stub_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(V, "ffmpeg_available", lambda: False)
    cfg = V.FFVideoConfig(width=64, height=36)
    wr = V.FFVideoWriter(device="cpu")
    assert not wr.open(str(tmp_path / "x.mp4"), cfg)
    assert not wr.add_frame_rgb(np.zeros((36, 64, 3), np.uint8))
    frames = _frames(1)
    assert V.write_video_from_words_sequence(
        str(tmp_path / "x.mp4"), cfg, frames, S21, 64, 36, device="cpu") is None
    assert V.write_video_centered_in_canvas_from_rawN_sequence(
        str(tmp_path / "x.mp4"), cfg, frames, S21, device="cpu") is None
    assert not V.ffmpeg_from_png_pattern("f_%05d.png", str(tmp_path / "y.mp4"))
    assert wr.stats() == V.FFVideoStats()


def test_png_sequence_equals_reference(tmp_path):
    frames = _frames(3)
    ours = V.write_png_sequence_from_words(str(tmp_path / "o"), frames, S21,
                                           64, 36, device="cpu")
    ref = RV.write_png_sequence_from_words(str(tmp_path / "r"), frames,
                                           RSub.S21, 64, 36)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref]
    assert all(_same_file(a, b) for a, b in zip(ours, ref))


def test_frames_to_the_pipe(tmp_path, monkeypatch):
    """The frames the writer hands ffmpeg, plain and centred in a canvas,
    equal the reference writer's (add_frame_rgb captured on both)."""
    got = {"ours": [], "ref": []}
    for key, mod in (("ours", V), ("ref", RV)):
        monkeypatch.setattr(mod.FFVideoWriter, "add_frame_rgb",
                            lambda self, rgb, k=key: got[k].append(
                                np.asarray(I.host_rgb(rgb))) or True)
    frames = _frames(2)
    cfg = V.FFVideoConfig(width=96, height=60)
    wr, rwr = V.FFVideoWriter(device="cpu"), RV.FFVideoWriter()
    wr._cfg, rwr._cfg = cfg, RV.FFVideoConfig(width=96, height=60)
    for f in frames:
        wr.add_frame_words(f, S21, 64, 36)
        rwr.add_frame_words(f, RSub.S21, 64, 36)
    small = {RSub.S15: (64, 36)}
    monkeypatch.setattr(V, "std_res_for", lambda m: small[RSub(int(m))])
    monkeypatch.setattr(RV, "std_res_for", lambda m: small[RSub(int(m))])
    for f in frames:
        wr.add_frame_words_centered_in_canvas(f, S15)
        rwr.add_frame_words_centered_in_canvas(f, RSub.S15)
    assert len(got["ours"]) == len(got["ref"]) == 4
    assert got["ours"][2].shape == (60, 96, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got["ours"], got["ref"]))


def test_real_ffmpeg_when_present(tmp_path):
    if not V.ffmpeg_available():
        pytest.skip("no ffmpeg binary")
    cfg = V.FFVideoConfig(width=64, height=36, fps=30.0, preset="veryfast")
    st = V.write_video_from_words_sequence(str(tmp_path / "v.mp4"), cfg,
                                           _frames(3), S21, 64, 36,
                                           device="cpu")
    assert st is not None and st.frames_written == 3
    assert os.path.getsize(tmp_path / "v.mp4") > 0
