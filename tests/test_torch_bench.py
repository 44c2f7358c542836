"""The port's benchmark entry points (``ternary_image_codec_tpu_torch/bench``)
against the JAX package, on the CPU at small sizes.

The damage model on a JAX-encoded stream decodes under the port's
frames-batched fused decode as under the JAX package's fused program; the
headline's clean and e2e checksums equal the JAX ``roundtrip_stream_fn``'s
on the same frames; rs_bench's corrections equal ``rs.decode_jit``'s; the
serve benchmark writes the JAX tool's T3V6 file byte for byte; a wrong
decoded word makes a tool fail.  Tolerance: zero, ok flags included.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu.ops import rs as jrs
from ternary_image_codec_tpu.ops import wordcodec as jwc
from ternary_image_codec_tpu_torch import config as tconfig
from ternary_image_codec_tpu_torch import decode_frames_fused
from ternary_image_codec_tpu_torch.bench import (damage, full_mode_bench,
                                                 headline, rs_bench,
                                                 serve_bench)
from ternary_image_codec_tpu_torch.codec import codec_for
from ternary_image_codec_tpu_torch.ops import pipeline as tpipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SFB = 8
SMALL = ["--device", CPU, "--wh", "512x128", "--iters", "2",
         "--dirty-iters", "2", "--dirty-d", "2"]
# bench.py's JSON keys, and the port's
HEADLINE_KEYS = {"metric", "value", "unit", "e2e_fps", "dirty_fps",
                 "dirty_over_clean_decode", "dirty_model", "backend",
                 "device", "k1_launches", "k2_launches"}
RS_KEYS = {"encode_Msym_s", "check_Msym_s", "paged_fix_Msym_s",
           "encode_Mtrit_s"}


def _cfgs(sfw):
    return tuple(m.EncoderConfig(profile=m.ProfileID.P2_RS26_22,
                                 uep=m.uep_luma_priority(),
                                 superframe_words=sfw)
                 for m in (jconfig, tconfig))


def _bench_raw(n_raw, rng):
    """bench.py's RAW words (trit 26 zero) from ``rng``."""
    t = rng.integers(0, 3, size=(n_raw, 27)).astype(np.int8)
    t[:, 26] = 0
    return (t.reshape(n_raw, 9, 3) * np.array([1, 3, 9])).sum(-1) \
        .astype(np.int8)


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --- (a) the damage model through the fused decode ---------------------------

@pytest.mark.parametrize("overcap", [0.25, 0.0])
def test_damage_fused_decode_matches_jax(overcap):
    jcfg, cfg = _cfgs(512)
    F, n_sf = 3, 8
    raw = _bench_raw(F * n_sf * 512, np.random.default_rng(3))
    words = np.asarray(jpipe.encode_stream_superframes(
        jnp.asarray(raw), jcfg, sf_batch=SFB))            # (F*n_sf, total, 9)
    total = words.shape[1]
    planes = torch.as_tensor(np.ascontiguousarray(
        words.reshape(F, n_sf, total, 9).transpose(0, 1, 3, 2)))
    ev, (fi_sf, si_sf) = damage.damage(n_sf, total, F, D=4, overcap=overcap,
                                       hdr=0.5)
    dirty = damage.apply(planes, ev)
    changed = (dirty != planes).flatten(2).any(2)
    assert changed.sum() == len(fi_sf) and changed[fi_sf, si_sf].all()
    cap = len(fi_sf)
    got, ok = decode_frames_fused(dirty, cfg, sf_batch=SFB, repair_cap=cap,
                                  wire="planes", device=CPU)
    want, want_ok = jpipe._fused_auto_fn(jcfg, SFB, cap)(
        jnp.asarray(dirty.flatten(0, 1).numpy()))
    assert bool(ok) == bool(want_ok) == (overcap == 0)
    assert np.array_equal(got.flatten(0, 1).numpy(), np.asarray(want))
    # per superframe: the paged flags equal the reference's; only overcap
    # superframes (the head of the dirty list) may stay flagged, and with
    # overcap some do (a random t+1 pattern lands inside another codeword's
    # decoding sphere with probability ~0.41 at r = 4, so not every one)
    flat = dirty.flatten(0, 1)
    _fix, ok_sf = codec_for(cfg, CPU).paged(flat, SFB)
    _l, _d, _e, jpaged = jpipe._stream_fns(jcfg, SFB, rs_mode="paged",
                                           ok_per_sf=True, hdr_all_pages=True)
    assert np.array_equal(ok_sf.numpy(),
                          np.asarray(jpaged(jnp.asarray(flat.numpy()))[1]))
    n_over = int(round(overcap * len(fi_sf)))
    over = np.zeros(F * n_sf, dtype=bool)
    over[fi_sf[:n_over] * n_sf + si_sf[:n_over]] = True
    flagged = ~ok_sf.numpy()
    assert not (flagged & ~over).any() and flagged.any() == (n_over > 0)
    out = got[:, :, :, :512].permute(0, 1, 3, 2).reshape(F, n_sf * 512, 9)
    keep = torch.as_tensor(~over.reshape(F, n_sf)).repeat_interleave(512, 1)
    assert torch.equal(out[keep], torch.as_tensor(raw).view(F, -1, 9)[keep])


# --- (b) the one-frame case is chip_smoke.py's old bench_damage --------------

# chip_smoke.bench_damage(5, 60) before it became a call of damage.damage
OLD_BENCH_DAMAGE_5_60 = {
    "si_sf": [3, 1, 2, 4, 0],
    "si": [3] * 8 + [1] * 8 + [2] * 8 + [4] * 8 + [0] * 10,
    "bi": [1, 2, 3, 7, 8, 0, 4, 5, 8, 0, 3, 5, 2, 1, 7, 4, 0, 4, 3, 8, 6, 5,
           7, 1, 6, 4, 2, 8, 7, 1, 3, 0, 2, 6, 8, 1, 0, 3, 4, 5, 1, 1],
    "pi": [16, 35, 46, 23, 50, 55, 37, 19, 40, 52, 16, 45, 31, 9, 46, 44, 55,
           38, 22, 39, 50, 46, 31, 48, 46, 54, 25, 20, 29, 40, 17, 42, 54, 22,
           35, 37, 49, 27, 45, 28, 0, 4],
    "dlt": [13, 24, 2, 18, 7, 7, 18, 20, 24, 6, 23, 22, 9, 2, 21, 22, 12, 5,
            4, 10, 20, 9, 1, 18, 20, 5, 15, 11, 14, 1, 17, 7, 15, 11, 16, 3,
            10, 17, 20, 10, 18, 5]}


def test_one_frame_damage_is_the_old_bench_damage():
    import chip_smoke as cs
    (fi, si, bi, pi, dlt), (fi_sf, si_sf) = damage.damage(5, 60, frames=1)
    want = OLD_BENCH_DAMAGE_5_60
    assert not fi.any() and not fi_sf.any()
    got = {"si_sf": si_sf, "si": si, "bi": bi, "pi": pi, "dlt": dlt}
    for key, arr in got.items():
        assert arr.tolist() == want[key], key
    old_sf, old = cs.bench_damage(5, 60)
    assert old_sf.tolist() == want["si_sf"]
    assert [a.tolist() for a in old] == [want[k] for k in ("si", "bi", "pi",
                                                           "dlt")]


# --- (c) the headline's checksums against the JAX roundtrip ------------------

def test_headline_checksums_match_jax(capsys):
    assert headline.main(SMALL) == 0
    res = _json(capsys)
    assert HEADLINE_KEYS <= set(res)
    # divergences from bench.py: per card, no vs_baseline (another device's
    # target)
    assert res["unit"] == "frames/s/card" and res["backend"] == "torch-cpu"
    assert "vs_baseline" not in res
    assert res["dirty_model"] == {"D": 2, "E": 8, "overcap": 0.0, "hdr": 0.25}
    for key in ("value", "e2e_fps", "dirty_fps", "dirty_over_clean_decode"):
        assert res[key] > 0, key
    assert set(res["k1_launches"]) == {"clean", "e2e", "dirty"}
    # the warm-up batch: frames base + 1 and base + 2
    jcfg, _ = _cfgs(8192)
    sf, iters, n_raw = 8192, 2, 512 * 128 // 2
    n_sf = n_raw // sf
    rng = np.random.default_rng(0)
    base = _bench_raw(n_raw, rng).reshape(n_sf, sf, 9)
    chunks = np.concatenate([(base + i) % 27 for i in (1, 2)])
    rt = jpipe.roundtrip_stream_fn(
        jcfg, 128, rs_mode="check",
        fold=lambda o: jnp.sum(o.astype(jnp.int32)))
    chks, ok = rt(jnp.asarray(chunks))
    assert bool(ok.all())
    assert int(jnp.sum(chks)) % (1 << 32) == res["checksums"]["clean"][0]
    # e2e: bench.py's RGB draws after the RAW ones, then RAW planes by the
    # reference's eager ingest9 (its jitted ingest rounds some pixels
    # otherwise, the reference fault the port does not follow), round-tripped
    # with the egress9 fold
    rgb = rng.integers(0, 256, size=(n_sf * sf, 3, 2)).astype(np.uint8)
    rgb = np.ascontiguousarray(rgb.reshape(n_sf, sf, 3, 2)
                               .transpose(0, 2, 3, 1))
    planes = jnp.stack([jwc.ingest9_planes(jnp.asarray(rgb[s] + np.uint8(v)))
                        for v in range(1, iters + 1) for s in range(n_sf)])
    rt_e2e = jpipe.roundtrip_stream_fn(
        jcfg, 128, rs_mode="check", raw_wire="planes",
        fold=lambda o: jnp.sum(jwc.egress9_planes(o[:, :sf])
                               .astype(jnp.int32)),
        feed=(planes, lambda src, i: src[i]))
    chks, ok = rt_e2e(jnp.arange(iters * n_sf))
    assert bool(ok.all())
    assert int(jnp.sum(chks)) % (1 << 32) == res["checksums"]["e2e"][0]


def test_repair_cap_is_its_own_argument(monkeypatch, capsys):
    """Divergence from bench.py, which sizes the fused window from
    ``T3_REPAIR_SFB``: ``--repair-cap`` is the window, by default every
    dirty superframe of a set (2 frames x 2 here), and the environment
    variable is not read."""
    monkeypatch.setenv("T3_REPAIR_SFB", "1")
    argv = SMALL + ["--skip-e2e"]
    res = headline.run(argv)
    assert res["repair_cap"] == 4 and res["dirty_fps"] > 0
    assert headline.run(argv + ["--repair-cap", "6"])["repair_cap"] == 6
    # a window smaller than the dirty superframes fails safe: the leg fails
    assert headline.main(argv + ["--repair-cap", "3"]) == 1
    assert "dirty repair failed" in capsys.readouterr().err


# --- (d) rs_bench's corrections against rs.decode_jit ------------------------

def test_rs_bench_matches_decode_jit(capsys):
    held = {}
    res = rs_bench.run(["--device", CPU, "--blocks", "2048", "--iters", "1"],
                       held=held)
    assert res["metric"] == "rs26_throughput" and res["blocks"] == 2048
    for k in rs_bench.KS:
        assert RS_KEYS <= set(res[f"k{k}"]), k
        recv, got, ok = held[k]                  # (3, B, 26), (3, B, k), (B,)
        sym = lambda d: (d[0] + 3 * d[1] + 9 * d[2]).astype(np.int8)
        want, want_ok = jrs.decode_jit(jnp.asarray(sym(recv)), k)
        assert np.array_equal(ok, np.asarray(want_ok)) and ok.all()
        assert np.array_equal(sym(got), np.asarray(want))


# --- (e) the serve benchmark's file is the JAX tool's ------------------------

def test_serve_bench_file_matches_jax_tool(tmp_path, capsys):
    port, ref = str(tmp_path / "port.t3v"), str(tmp_path / "jax.t3v")
    args = ["--frames", "2", "--wh", "256x128"]
    assert serve_bench.main(args + ["--device", CPU, "--path", port,
                                    "--keep-file"]) == 0
    res = _json(capsys)
    assert {"serve_write_fps", "serve_read_fps", "serve_fps", "frames",
            "group", "frame_mb", "enc_split_s", "dec_split_s"} <= set(res)
    assert res["frames"] == 4 and res["group"] == 4
    assert {"stage_h2d", "d2h", "crc", "io"} <= set(res["enc_split_s"])
    assert {"read", "h2d"} <= set(res["dec_split_s"])
    # the JAX tool removes its file at the end: keep it
    code = ("import os, runpy, sys\n"
            "os.remove = lambda path: None\n"
            f"sys.argv = ['serve_bench.py', '--cpu', *{args!r}, '--path', "
            f"{ref!r}]\n"
            "runpy.run_path('tools/serve_bench.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=300,
                         capture_output=True, text=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


# --- (f) a wrong decoded word fails the tool ---------------------------------

def _wrong_word(decoder):
    def decode(body, dlayout, T):
        out, ok = decoder(body, dlayout, T)
        out = out.clone()
        out[0, 0, 0] = (out[0, 0, 0] + 1) % 27
        return out, ok
    return decode


@pytest.mark.parametrize("tool, argv, rs_mode", [
    (headline, SMALL, "check"),
    (headline, SMALL + ["--skip-e2e"], "paged"),
    (full_mode_bench, ["--device", CPU, "--wh", "512x128", "--iters", "1"],
     "full")], ids=["headline clean", "headline dirty", "full_mode_bench"])
def test_wrong_word_fails_the_tool(tool, argv, rs_mode, monkeypatch, capsys):
    monkeypatch.setitem(tpipe.BODY_DECODERS, rs_mode,
                        _wrong_word(tpipe.BODY_DECODERS[rs_mode]))
    assert tool.main(argv) == 1
    cap = capsys.readouterr()
    assert "FAILED" in cap.err and "{" not in cap.out


def test_full_mode_bench_has_one_program(monkeypatch):
    """Divergence from tools/full_mode_bench.py: no T3_FULL_V3 A/B (the
    knob is not ported); one row a leg, whatever the environment says."""
    argv = ["--device", CPU, "--wh", "512x128", "--iters", "1"]
    monkeypatch.setenv("T3_FULL_V3", "0")
    res = full_mode_bench.run(argv)
    assert set(res["ms_per_frame"]) == {"clean", "dirty"}
    assert not any("V3" in key for key in res)


def test_wrong_correction_fails_rs_bench(monkeypatch, capsys):
    from ternary_image_codec_tpu_torch.ops import rs
    paged = rs.decode_paged_pm_bk

    def wrong(*a, **kw):
        data, ok = paged(*a, **kw)
        data = data.clone()
        data[0, 0, 0] = (data[0, 0, 0] + 1) % 3
        return data, ok
    monkeypatch.setattr(rs, "decode_paged_pm_bk", wrong)
    assert rs_bench.main(["--device", CPU, "--blocks", "512", "--iters",
                          "1", "--errors", "64"]) == 1
    assert "FAILED" in capsys.readouterr().err


def test_failed_leg_exits_nonzero():
    """As a process: a wrong decoded word makes the headline exit 1 and
    print no JSON line."""
    code = ("import sys\n"
            "from ternary_image_codec_tpu_torch.ops import pipeline as p\n"
            "from ternary_image_codec_tpu_torch.bench import headline\n"
            "check = p.BODY_DECODERS['check']\n"
            "def wrong(body, dl, T):\n"
            "    out, ok = check(body, dl, T)\n"
            "    out = out.clone(); out[0, 0, 0] = (out[0, 0, 0] + 1) % 27\n"
            "    return out, ok\n"
            "p.BODY_DECODERS['check'] = wrong\n"
            "raise SystemExit(headline.main(sys.argv[1:]))\n")
    argv = SMALL + ["--skip-e2e", "--skip-dirty"]
    out = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT,
                         timeout=300, capture_output=True, text=True)
    assert out.returncode == 1 and "FAILED" in out.stderr
    assert out.stdout.strip() == ""


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py phase 11 runs the "
                    "tools there)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_headline_on_the_card_holds_kernel_inputs(cuda_device, capsys):
    """The headline at 512x128 on the card: its exactness checks pass and
    every K1 and K2 input of its kept calls equals the twin's result."""
    import chip_smoke as cs
    held = {}
    argv = [a for a in SMALL if a not in ("--device", CPU)]
    assert headline.main(argv, keep=cs.bench_keep(torch, cuda_device,
                                                  held)) == 0
    res = _json(capsys)
    assert res["k1_launches"]["clean"] > 0 and res["k2_launches"]["dirty"] > 0
    assert held["clean"]["check_decode"] > 0
    assert held["dirty"]["rs_correct"] > 0
