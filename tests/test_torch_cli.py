"""The port's CLI tools (``ternary_image_codec_tpu_torch.cli``) with
``--device cpu`` against the JAX package's tools on the same input.

Each tool runs twice, in two directories with the same relative
arguments and inputs: the reference tool, then the port's.  Required:
the same exit code and standard output (the JSON reports field by field;
none holds a timing), and every file either writes byte-equal, except a
Haar .t3proto, whose spectral-sketch trits may differ in at most 2 of 64
(tests/test_torch_proto.py).  Without ``--device`` a tool runs on the card
and raises where there is none.
"""
import json
import os

import numpy as np
import pytest
import torch

from ternary_image_codec_tpu.cli import (demo_write_video as r_demo,
                                         main as r_main, main_bare as r_bare,
                                         main_video_t3v as r_video,
                                         minitest_aniso_rc as r_aniso,
                                         minitest_codec as r_codec,
                                         minitest_images as r_images,
                                         minitest_t3containers as r_cont,
                                         minitest_trits as r_trits,
                                         t3dump as r_dump, t3proto_tool as r_t3t)
from ternary_image_codec_tpu.io import video as RV
from ternary_image_codec_tpu_torch.cli import (channel_qa, demo_write_video,
                                               main, main_bare, main_video_t3v,
                                               minitest_aniso_rc,
                                               minitest_codec,
                                               minitest_images,
                                               minitest_t3containers,
                                               minitest_trits, sigs, t3dump,
                                               t3proto_tool)
from ternary_image_codec_tpu_torch.config import SubwordMode
from ternary_image_codec_tpu_torch.io import containers as C
from ternary_image_codec_tpu_torch.io import image as I
from ternary_image_codec_tpu_torch.io import legacy_containers as LC
from ternary_image_codec_tpu_torch.io import video as V

SKETCH_TOL = 2


def _png(path, w, h, seed):
    I.save_image_png(str(path), np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 3), dtype=np.uint8))


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.fixture
def both(tmp_path, monkeypatch, capsys):
    """run(ref_main, our_main, argv, setup) -> {side: (rc, stdout, dir)}:
    the reference tool in tmp/ref, then the port's with --device cpu in
    tmp/ours; ``setup(dir)`` makes the inputs in each."""
    def run(ref_main, our_main, argv, setup=None):
        res = {}
        for side, fn, extra in (("ref", ref_main, []),
                                ("ours", our_main, ["--device", "cpu"])):
            d = tmp_path / side
            d.mkdir(exist_ok=True)
            monkeypatch.chdir(d)
            if setup is not None:
                setup(d)
            capsys.readouterr()
            rc = fn(argv + extra)
            res[side] = (rc, capsys.readouterr().out, d)
        return res
    return run


def _same(res, skip=()):
    (rc, out, d), (rc2, out2, d2) = res["ref"], res["ours"]
    assert rc2 == rc and out2 == out
    names = _files(d)
    assert _files(d2) == names
    for n in names:
        if n not in skip:
            assert (d / n).read_bytes() == (d2 / n).read_bytes(), n


def _report(res):
    return json.loads(res["ours"][1])


def test_main(both):
    res = both(r_main.main, main.main,
               ["in.png", "o.t3v", "--roundtrip-png", "rt.png"],
               lambda d: _png(d / "in.png", 16, 16, 3))
    _same(res)
    assert res["ours"][0] == 0


def test_main_bare(both):
    res = both(r_bare.main, main_bare.main, ["--outdir", "demo", "--verbose"])
    _same(res)
    assert res["ours"][0] == 0
    out = res["ours"][1]
    assert "RS unit: OK" in out and "API roundtrip: OK" in out
    assert "RS(26,18): corrected 4 errors OK" in out


def test_minitest_trits(both):
    res = both(r_trits.main, minitest_trits.main,
               ["--cases-t1", "4", "--cases-t2", "20", "--cases-t3", "3",
                "--seed", "5"])
    _same(res)
    rep = _report(res)["report"]
    assert rep["final_status"] == "PASS" and rep["rs_gf_selftest"] == "OK"


# the standard resolutions shrunk in both packages' modules that read them
# (as tests/test_torch_bridge.py shrinks the S27 canvas): the tools' logic
# is the same at any size
SMALL_RES = {15: (64, 40), 18: (128, 72), 21: (96, 54), 24: (160, 90),
             27: (192, 108)}


@pytest.fixture
def small_res(monkeypatch):
    from ternary_image_codec_tpu.io import image as RI
    from ternary_image_codec_tpu_torch.io import image as PI
    for mod in (RI, PI, r_codec, minitest_codec, r_cont,
                minitest_t3containers):
        monkeypatch.setattr(mod, "std_res_for",
                            lambda m: SMALL_RES[int(m)])


@pytest.mark.parametrize("codec", ["word13", "word9"])
def test_minitest_codec(both, small_res, codec):
    res = both(r_codec.main, minitest_codec.main, ["--codec", codec])
    _same(res)
    assert _report(res)["report"]["final_status"] == "PASS"


def _smooth_png(path, w, h):
    y, x = np.mgrid[0:h, 0:w]
    I.save_image_png(str(path), np.stack(
        [60 + x, 90 + y, 120 + (x + y) // 2], axis=-1).astype(np.uint8))


@pytest.mark.parametrize("mode,codec,image", [
    ("S15", "word13", "smooth"), ("S18", "word9", "smooth"),
    ("S15", "word9", "noise")])
def test_minitest_images(both, small_res, mode, codec, image):
    """A smooth image passes the +-4 check; noise fails it (CHECK, exit
    1), in both packages alike."""
    make = ((lambda d: _smooth_png(d / "in.png", 40, 24)) if image == "smooth"
            else (lambda d: _png(d / "in.png", 40, 24, 9)))
    res = both(r_images.main, minitest_images.main,
               ["--in", "in.png", "--mode", mode, "--codec", codec], make)
    _same(res)
    status = _report(res)["report"]["final_status"]
    assert (status, res["ours"][0]) == (("PASS", 0) if image == "smooth"
                                        else ("CHECK", 1))


def test_minitest_aniso_rc(both):
    res = both(r_aniso.main, minitest_aniso_rc.main,
               ["--in", "in.png", "--png", "rec.png", "--json", "--angles",
                "6"], lambda d: _png(d / "in.png", 70, 45, 4))
    _same(res)
    rep = _report(res)["aniso_rc"]
    assert (rep["W"], rep["H"], rep["angles"]) == (96, 64, 6)


def _proto_equal(a, b):
    """Two .t3proto files: byte-equal, or a Haar file whose sketch part
    differs in at most SKETCH_TOL trits."""
    if a.read_bytes() == b.read_bytes():
        return
    pa, pb = LC.t3proto_read(str(a)), LC.t3proto_read(str(b))
    assert pa[:3] == pb[:3] and pa[5] == pb[5]
    assert pa[0] == LC.ProtoProfile.HAAR_TERNARY
    n_sk = json.loads(pa[5])["layout"]["len_sketch"]
    head = pa[3].size - n_sk
    assert np.array_equal(pa[3][:head], pb[3][:head])
    assert (pa[3][head:] != pb[3][head:]).sum() <= SKETCH_TOL


@pytest.mark.parametrize("profile,extra", [
    ("haar", []), ("rc", []), ("rc", ["--no-pack", "--rc-angles", "4"]),
    ("haar", ["--no-balanced", "--haar-tile", "4", "--haar-thresh", "9"])])
def test_t3proto_tool(both, profile, extra):
    """encode, then info, export, repack and cat on its output."""
    res = both(r_t3t.main, t3proto_tool.main,
               ["encode", "--in", "in.png", "--out", "s.t3proto",
                "--profile", profile] + extra,
               lambda d: _png(d / "in.png", 64, 40, 7))
    _same(res, skip=("s.t3proto",))
    _proto_equal(res["ref"][2] / "s.t3proto", res["ours"][2] / "s.t3proto")
    # the rest runs on the port's file in both directories
    (res["ref"][2] / "s.t3proto").write_bytes(
        (res["ours"][2] / "s.t3proto").read_bytes())
    has_bal = "--no-balanced" not in extra
    has_pack = "--no-pack" not in extra
    runs = [["info", "s.t3proto"], ["info", "s.t3proto", "--json"],
            ["cat", "--out", "m.t3proto", "s.t3proto", "s.t3proto"],
            ["repack", "s.t3proto", "--to", "bogus", "--out", "x.t3proto"]]
    if has_bal:
        runs += [["export-bal", "s.t3proto", "--out", "bal.bin"],
                 ["export-unb", "s.t3proto", "--out", "unb.bin"],
                 ["repack", "s.t3proto", "--to", "packed", "--out",
                  "p.t3proto"]]
    if has_pack:
        runs += [["repack", "s.t3proto", "--to", "balanced", "--strict",
                  "--keep-packed", "--out", "b.t3proto"],
                 ["repack", "s.t3proto", "--force-exact", "30", "--out",
                  "f.t3proto"]]
    for argv in runs:
        _same(both(r_t3t.main, t3proto_tool.main, argv))
    if has_pack:
        _same(both(r_t3t.main, t3proto_tool.main,
                   ["repack", "p.t3proto" if has_bal else "s.t3proto", "--to",
                    "balanced", "--guess", "--out", "g.t3proto"]))


def test_t3proto_tool_guess_vs_strict(both):
    def setup(d):
        LC.t3proto_write(str(d / "nc.t3proto"), LC.ProtoProfile.NONE, 4, 4,
                         None, np.arange(16, dtype=np.uint8), "{}")
    for flag in ("--strict", "--guess"):
        res = both(r_t3t.main, t3proto_tool.main,
                   ["repack", "nc.t3proto", "--to", "balanced", flag,
                    "--out", "o.t3proto"], setup)
        _same(res)
        assert res["ours"][0] == (1 if flag == "--strict" else 0)


def test_t3dump(both):
    r = np.random.default_rng(0)
    words = r.integers(0, 3 ** 13, size=64 * 40, dtype=np.uint32)
    frames = [r.integers(0, 3 ** 13, size=48 * 30, dtype=np.uint32)
              for _ in range(2)]

    def setup(d):
        C.t3p_write(str(d / "x.t3p"), SubwordMode.S18, 64, 40, words,
                    '{"k":1}')
        C.t3v_write(str(d / "v.t3v"), SubwordMode.S15, 48, 30, frames,
                    '{"fps":30}')
    for argv in (["x.t3p", "--json"], ["x.t3p"],
                 ["x.t3p", "--extract-png", "0", "--out", "f.png"],
                 ["v.t3v", "--json"],
                 ["v.t3v", "--extract-png", "all", "--outdir", "frames"],
                 ["v.t3v", "--extract-png", "1", "--out", "g.png"],
                 ["x.bin"]):
        _same(both(r_dump.main, t3dump.main, argv, setup))
    rep = _report(both(r_dump.main, t3dump.main, ["x.t3p", "--json"], setup))
    raw = words.astype("<u4").tobytes()
    assert rep["t3p"]["crc12_raw"] == f"{sigs.crc12_0x80F(raw):03X}"


def test_minitest_t3containers(both, small_res):
    res = both(r_cont.main, minitest_t3containers.main,
               ["--modes", "S15,S27", "--outdir", "out"])
    _same(res)
    assert _report(res)["t3containers"]["final_status"] == "PASS"


def test_main_video_t3v_and_resume(both):
    def setup(d):
        for i in range(2):
            _png(d / f"in{i}.png", 16, 16, 3 + i)
    argv = ["in0.png", "in1.png", "full.t3v", "--frames-dir", "frames",
            "--mp4", "v.mp4"]
    res = both(r_video.main, main_video_t3v.main, argv, setup)
    if not V.ffmpeg_available():
        _same(res)
    d = res["ours"][2]
    want = (d / "full.t3v").read_bytes()
    offs = LC.t3vi_read(str(d / "full.t3v.t3vi"))
    # a crash mid-frame 1, then --resume: the same bytes again
    (d / "part.t3v").write_bytes(want[:offs[1] + 7])
    assert main_video_t3v.main(["in0.png", "in1.png", "part.t3v",
                                "--frames-dir", "frames", "--resume",
                                "--device", "cpu"]) == 0
    assert (d / "part.t3v").read_bytes() == want


def test_demo_write_video_png_fallback(both, monkeypatch):
    monkeypatch.setattr(V, "ffmpeg_available", lambda: False)
    monkeypatch.setattr(RV, "ffmpeg_available", lambda: False)
    res = both(r_demo.main, demo_write_video.main,
               ["--out", "d.mp4", "--frames", "2", "--png-dir", "pngs"])
    _same(res)
    assert len(os.listdir(res["ours"][2] / "pngs")) == 2


def _reference_tool(name):
    """A script of the repository's tools/ directory, as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [["--json"], []], ids=["json", "table"])
def test_channel_qa(both, extra):
    """The same draws and the same rates: stdout byte for byte, as JSON
    and as the table."""
    res = both(_reference_tool("channel_qa").main, channel_qa.main,
               ["--blocks", "64", "--seed", "3"] + extra)
    _same(res)
    assert res["ours"][0] == 0
    if extra:
        rep = _report(res)
        assert sorted(rep) == ["RS(26,18) t=4", "RS(26,20) t=3",
                               "RS(26,22) t=2", "RS(26,24) t=1"]
        for name, rows in rep.items():
            t = int(name[-1])
            assert rows["0"]["exact"] == rows[str(t)]["exact"] == 1.0
            assert len(rows) == 2 * t + 2


def test_tools_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    tools = [(main, ["a.png", "b.t3v"]), (main_bare, []), (channel_qa, []),
             (minitest_trits, []), (minitest_codec, []),
             (minitest_images, ["--in", "a.png"]),
             (minitest_aniso_rc, ["--in", "a.png"]),
             (minitest_t3containers, []), (t3dump, ["x.t3p"]),
             (main_video_t3v, ["a.png", "b.t3v"]), (demo_write_video, []),
             (t3proto_tool, ["info", "x.t3proto"])]
    for tool, argv in tools:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tool.main(argv)


def test_smoke_phase9_rehearsal(tmp_path):
    """chip_smoke.py's phase 9 on the CPU at a small size: the prototype
    stages and their comparison, the .t3proto files of both profiles and
    every tool leg with its checks (a PNG of 72x40, so main and AnisoRC
    take the resize pad)."""
    import chip_smoke as cs
    cpu = torch.device("cpu")
    rgb = cs.proto_image(torch, cpu, 72, 40)
    calls, out = cs.proto_stages(rgb, cpu)
    assert cs.proto_equal(torch, out, cs.proto_stages(rgb.clone(), cpu)[1],
                          "rehearsal") == 0
    assert all(cs.proto_bound_ms(name, 72, 40, out) > 0 for name in calls)
    paths, ms = cs.proto_files(torch, rgb, cpu, rgb.clone(), str(tmp_path))
    assert sorted(paths) == sorted(ms) == ["ANISO_RC", "HAAR_TERNARY"]
    png = str(tmp_path / "frame.png")
    I.save_image_png(png, rgb)
    legs = []
    res = cs.tool_legs(torch, cpu, str(tmp_path), paths["HAAR_TERNARY"], png,
                       lambda leg, fn: legs.append(leg) or fn())
    assert legs == ["main_bare", "minitest_trits", "minitest_codec",
                    "t3proto_tool", "main", "minitest_aniso_rc"]
    assert sorted(res) == sorted(legs)
