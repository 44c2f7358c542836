"""Entry points run on the card unless the caller asks for the CPU.

Without a ``device`` every entry point takes the current CUDA device; on a
machine with no card it raises a RuntimeError naming the ``device``
argument and never returns CPU tensors.  ``device="cpu"`` runs on the CPU
(the parity tests in the other test_torch_*.py files hold that path
bit-exact against the JAX package), and inputs move to the chosen device.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ternary_image_codec_tpu_torch as port
from ternary_image_codec_tpu_torch import entry as step_entry
from ternary_image_codec_tpu_torch import profiles
from ternary_image_codec_tpu_torch.bench import (full_mode_bench, headline,
                                                 rs_bench, serve_bench)
from ternary_image_codec_tpu_torch.cli import demo_write_video, main_bare
from ternary_image_codec_tpu_torch.codec import codec_for, resolve_device
from ternary_image_codec_tpu_torch.io import formats, image, serve, video
from ternary_image_codec_tpu_torch.ops import pipeline, proto
from ternary_image_codec_tpu_torch.parallel import dryrun, launch
from ternary_image_codec_tpu_torch.runtime import build
from ternary_image_codec_tpu_torch.parallel import mesh as pmesh

CFG = port.EncoderConfig(profile=port.ProfileID.P2_RS26_22,
                         uep=port.uep_luma_priority(), superframe_words=256)


def _raw(n_sf=2):
    r = np.random.default_rng(7)
    t = r.integers(0, 3, size=(n_sf * CFG.superframe_words, 27))
    t[:, 26] = 0
    return (t.reshape(-1, 9, 3) * np.array([1, 3, 9])).sum(-1).astype(np.int8)


def _calls(tmp):
    """Each entry point, called without a device (files in ``tmp``)."""
    raw = _raw()
    chunks = raw.reshape(2, CFG.superframe_words, 9)
    words = port.encode_stream_superframes(torch.as_tensor(raw), CFG,
                                           device="cpu")
    profile = port.encode_profile_from_raw(raw[:1000], CFG, device="cpu")
    rgb = np.zeros((48, 64, 3), dtype=np.uint8)
    S15 = port.config.SubwordMode.S15
    png = str(tmp / "in.png")
    image.save_image_png(png, rgb)
    words13 = np.zeros(64 * 48, dtype=np.int32)
    pp, rp = proto.ProtoParams(), proto.AnisoRCParams()
    art = proto.proto_aniso_rc_encode(rgb, rp, device="cpu")
    haar = profiles.ProtoConfig(profile=profiles.ProtoProfile.HAAR_TERNARY)
    vcfg = video.FFVideoConfig(width=64, height=48)
    return {
        "SuperframeCodec": lambda: port.SuperframeCodec(CFG),
        "codec_for": lambda: codec_for(CFG),
        "tables_from_reference": lambda: port.tables_from_reference(
            pipeline.reference_inputs(CFG), CFG),
        "encode_stream_superframes": lambda: port.encode_stream_superframes(
            raw, CFG),
        "decode_stream_superframes": lambda: port.decode_stream_superframes(
            words, CFG, len(raw), strategy="check"),
        "roundtrip_stream": lambda: port.roundtrip_stream(
            torch.as_tensor(chunks), CFG),
        "decode_frames_fused": lambda: port.decode_frames_fused(
            words[None], CFG),
        "encode_profile_from_raw": lambda: port.encode_profile_from_raw(
            raw[:1000], CFG),
        "decode_profile_to_raw": lambda: port.decode_profile_to_raw(profile),
        "decode_header_from_words": lambda: port.decode_header_from_words(
            profile),
        "rgb_to_words": lambda: image.rgb_to_words(rgb, S15, False),
        "serve_codec_fns": lambda: serve.serve_codec_fns(CFG, len(raw))[0](
            torch.as_tensor(chunks)),
        "words_to_rgb": lambda: image.words_to_rgb(words13, S15, 64, 48),
        "image_to_words_subword": lambda: image.image_to_words_subword(
            png, S15, False),
        "words_to_image_subword": lambda: image.words_to_image_subword(
            words13, S15, 64, 48, str(tmp / "out.png")),
        "image_file_to_words": lambda: formats.image_file_to_words(
            png, "tiff", S15, False),
        "words_to_image_file": lambda: formats.words_to_image_file(
            words13, "tiff", S15, 64, 48, str(tmp / "out.tiff")),
        "proto_tile_haar_ternary": lambda: proto.proto_tile_haar_ternary(
            rgb, pp),
        "proto_reconstruct_y_from_tiles":
            lambda: proto.proto_reconstruct_y_from_tiles(
                None, np.zeros(48 * 48, np.int8), 8, 6, pp),
        "proto_spectral_sketch": lambda: proto.proto_spectral_sketch(rgb, pp),
        "proto_aniso_rc_encode": lambda: proto.proto_aniso_rc_encode(rgb, rp),
        "proto_aniso_rc_reconstruct":
            lambda: proto.proto_aniso_rc_reconstruct(art, rp),
        "encode_prototype_ternary": lambda: profiles.encode_prototype_ternary(
            rgb, haar),
        "FFVideoWriter": lambda: video.FFVideoWriter(),
        "write_video_from_words_sequence":
            lambda: video.write_video_from_words_sequence(
                str(tmp / "v.mp4"), vcfg, [words13], S15, 64, 48),
        "write_png_sequence_from_words":
            lambda: video.write_png_sequence_from_words(
                str(tmp / "seq"), [words13], S15, 64, 48),
        "selftest_rs_unit": lambda: main_bare.selftest_rs_unit(),
        "selftest_api_roundtrip": lambda: main_bare.selftest_api_roundtrip(),
        "make_frames": lambda: demo_write_video.make_frames(16, 8, 1),
        "spawn": lambda: launch.spawn(dryrun.dryrun_rank, 1, timeout_s=300),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(1),
        "entry": lambda: step_entry.entry(),
        # the benchmark tools, without --device
        "bench.headline": lambda: headline.main(
            ["--wh", "512x128", "--iters", "1", "--dirty-iters", "1",
             "--dirty-d", "2"]),
        "bench.rs_bench": lambda: rs_bench.main(
            ["--blocks", "1024", "--iters", "1", "--errors", "16"]),
        "bench.full_mode_bench": lambda: full_mode_bench.main(
            ["--wh", "512x128", "--iters", "1"]),
        "bench.serve_bench": lambda: serve_bench.main(
            ["--frames", "1", "--group", "1", "--wh", "256x128", "--path",
             str(tmp / "serve.t3v")]),
    }


ENTRIES = ["FFVideoWriter", "SuperframeCodec", "bench.full_mode_bench",
           "bench.headline", "bench.rs_bench", "bench.serve_bench", "codec_for",
           "decode_frames_fused", "decode_header_from_words",
           "decode_profile_to_raw", "decode_stream_superframes",
           "dryrun_multichip", "encode_profile_from_raw",
           "encode_prototype_ternary",
           "encode_stream_superframes", "entry", "image_file_to_words",
           "image_to_words_subword", "make_frames", "proto_aniso_rc_encode",
           "proto_aniso_rc_reconstruct", "proto_reconstruct_y_from_tiles",
           "proto_spectral_sketch", "proto_tile_haar_ternary", "rgb_to_words",
           "roundtrip_stream", "selftest_api_roundtrip", "selftest_rs_unit",
           "serve_codec_fns", "spawn", "tables_from_reference",
           "words_to_image_file",
           "words_to_image_subword", "words_to_rgb",
           "write_png_sequence_from_words", "write_video_from_words_sequence"]

# entry points whose result is host data (files, numpy, flags): on the card
# they must run and, where they decode, launch a kernel there
HOST_RESULTS = {"bench.full_mode_bench", "bench.headline", "bench.rs_bench",
                "bench.serve_bench", "decode_header_from_words",
                "dryrun_multichip",
                "encode_prototype_ternary", "spawn",
                "selftest_api_roundtrip", "selftest_rs_unit",
                "words_to_image_file", "words_to_image_subword",
                "write_png_sequence_from_words",
                "write_video_from_words_sequence"}


def test_every_entry_point_listed(tmp_path):
    assert sorted(_calls(tmp_path)) == ENTRIES


@pytest.mark.parametrize("entry", ENTRIES)
def test_default_device_is_the_card(entry, tmp_path):
    call = _calls(tmp_path)[entry]
    if torch.cuda.is_available():
        before = build.launches["rs_correct"]
        out = call()
        first = out[0] if isinstance(out, tuple) else out     # codec or tensor
        if entry == "decode_header_from_words":
            # a header is host data: K2 decoded its blocks on the card
            assert out[1] and build.launches["rs_correct"] > before
        elif entry in ("selftest_rs_unit", "selftest_api_roundtrip"):
            assert out and build.launches["rs_correct"] > before
        elif entry.startswith("bench."):
            # a tool's exit code: its checks passed on the card
            assert out == 0
            if entry != "bench.serve_bench":
                assert build.launches["rs_correct"] > before
        elif entry == "FFVideoWriter":
            assert out.device.type == "cuda"
        elif entry == "proto_aniso_rc_encode":
            assert out.trits.device.type == "cuda"
        elif entry == "make_frames":
            assert out[0].device.type == "cuda"
        elif entry == "entry":
            fn, (raw,) = out
            assert raw.device.type == "cuda" and fn(raw).device.type == "cuda"
        elif entry not in HOST_RESULTS:
            assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device"):
            call()


def test_mesh_default_device():
    """A mesh takes the device its rank was given, else the current CUDA
    device: without a card (and outside a rank) it raises as every entry
    point does; with one, it asks for the process group it lacks."""
    for make in (pmesh.make_mesh, pmesh.make_mesh_pp):
        if torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="process group"):
                make()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.rank_devices(2)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                resolve_device(dev)
    else:
        # an unindexed CUDA device is the current one: one cached codec
        current = torch.device("cuda", torch.cuda.current_device())
        for dev in (None, "cuda", current):
            assert resolve_device(dev) == current
        assert codec_for(CFG) is codec_for(CFG, current)


def test_cpu_when_asked_and_inputs_move():
    """numpy in, CPU tensors out; a CPU codec stays on the CPU."""
    raw = _raw()
    words = port.encode_stream_superframes(raw, CFG, device="cpu")
    assert isinstance(words, torch.Tensor) and words.device.type == "cpu"
    out, ok = port.decode_stream_superframes(words.numpy(), CFG, len(raw),
                                             device="cpu")
    assert out.device.type == "cpu" and bool(ok)
    assert np.array_equal(out.numpy(), raw)
    assert codec_for(CFG, "cpu") is codec_for(CFG, torch.device("cpu"))
    assert codec_for(CFG, "cpu").device.type == "cpu"


def test_beacon_codec_on_the_card():
    """A beacon layout decodes on the card by default: its paged decode
    launches K2 and never K1 (the paged corrector runs no check decode).
    Without a card its codec raises as every entry point does."""
    cfg = dataclasses.replace(
        CFG, beacon=port.config.SparseBeaconCfg(13, 4, True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            codec_for(cfg)
        return
    raw = _raw()
    words = port.encode_stream_superframes(raw, cfg)
    words[1, 30, 4] = (words[1, 30, 4] + 1) % 27       # a beacon payload cell
    before = build.launches.copy()
    out, ok = port.decode_stream_superframes(words, cfg, len(raw),
                                             strategy="paged")
    assert bool(ok) and np.array_equal(out.cpu().numpy(), raw)
    ran = build.launches - before
    assert ran["check_decode"] == 0 and ran["rs_correct"] > 0
