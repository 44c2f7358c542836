"""The port's parallel/mesh.py on 4 gloo ranks on the CPU against the JAX
package's on the conftest's 8-device CPU mesh (``make_mesh(4)``,
``make_mesh_pp(4)``), bit for bit, ok flags included.

One ``launch.spawn`` of 4 ranks runs every leg once
(tests/torch_mesh_ranks.py, which imports no jax) while the JAX side
compiles; the ranks return their local shapes and the gathered outputs.
The shapes are tests/test_mesh.py's.  Inputs are seeded numpy, handed to
both packages.  Recorded divergences: the fused superframe-DP decode
validates and repairs header words (the JAX function returns ok True on
damaged headers), a superframe count that is no multiple of the mesh
raises, NCCL with two ranks on one card raises, and outputs stay sharded
until ``gather``.  Every spawn has its own time limit.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu.parallel import mesh as JM
import ternary_image_codec_tpu_torch as port
from ternary_image_codec_tpu_torch import config as tconfig
from ternary_image_codec_tpu_torch.ops import encode as tencode
from ternary_image_codec_tpu_torch.ops import pipeline as tpipe
from ternary_image_codec_tpu_torch.parallel import dryrun, launch
from ternary_image_codec_tpu_torch.parallel import mesh as TM

import torch_mesh_ranks

WORLD = 4
HW = tpipe.HEADER_WORDS
SPAWN_TIMEOUT_S = 300
make_raw_words = dryrun.make_raw_words


def _cfgs(profile, uep="luma", tile=None, beacon=None, sfw=None):
    """(JAX config, port config), each from its own package."""
    out = []
    for m in (jconfig, tconfig):
        kw = {"profile": m.ProfileID[profile],
              "uep": m.uep_luma_priority() if uep == "luma"
              else m.uep_uniform(uep)}
        if tile:
            kw["tile"] = m.Tile2D(*tile)
        if beacon:
            kw["beacon"] = m.SparseBeaconCfg(*beacon, True)
        if sfw:
            kw["superframe_words"] = sfw
        out.append(m.EncoderConfig(**kw))
    return tuple(out)


P2 = _cfgs("P2_RS26_22")
P1 = _cfgs("P1_RS26_24", 0)
P3 = _cfgs("P3_RS26_20", 2)
P5 = _cfgs("P5_RS26_22_2D", tile=(26, 26))
BEACON = _cfgs("P2_RS26_22", beacon=(13, 4))
P5_BEACON = _cfgs("P5_RS26_22_2D", tile=(26, 26), beacon=(13, 4))
P1_SF256 = _cfgs("P1_RS26_24", 0, sfw=256)
P1_SF64 = _cfgs("P1_RS26_24", 0, sfw=64)


def _frames(B, n_raw, seed0):
    return np.stack([make_raw_words(n_raw, seed=seed0 + i) for i in range(B)])


def _profiles(frames, cfg):
    """Profile words of each frame (the port's single-device encode on the
    CPU, held to the JAX package's by tests/test_torch_profile.py)."""
    return np.stack([tpipe.encode_profile_from_raw(f, cfg, device="cpu")
                     .numpy() for f in frames])


def _pp_frames(T, db, n_raw, seed0):
    return np.stack([[make_raw_words(n_raw, seed=seed0 + 10 * t + i)
                      for i in range(db)] for t in range(T)]).astype(np.int8)


def _legs():
    """name -> (function, input, configs, kwargs).  The input goes to both
    packages with each one's config."""
    L = {}
    L["encode_frames_dp P2"] = ("encode_frames_dp", _frames(8, 192, 0), P2, {})
    L["roundtrip_step_dp P1"] = ("roundtrip_step_dp", _frames(8, 128, 10),
                                 P1, {})
    L["encode_frames_dp 6 frames"] = ("encode_frames_dp", _frames(6, 64, 0),
                                      P2, {})
    # <= t errors in every column of every frame (t=3 for P3)
    prof = _profiles(_frames(8, 160, 20), P3[1])
    r = np.random.default_rng(5)
    for f in range(8):
        for col in range(9):
            rows = r.choice(prof.shape[1] - HW, size=2, replace=False)
            cell = prof[f, HW + rows, col]
            prof[f, HW + rows, col] = (cell + 1 + r.integers(0, 26)) % 27
    L["decode_frames_dp P3 corrected"] = ("decode_frames_dp", prof, P3, {})
    # one frame overwhelmed (k=24, t=1: 5 errors in one column)
    prof = _profiles(_frames(8, 128, 30), P1[1])
    for row in range(5):
        prof[5, HW + row, 2] = (prof[5, HW + row, 2] + 1 + row % 2) % 27
    L["decode_frames_dp P1 overwhelmed"] = ("decode_frames_dp", prof, P1, {})
    L["decode_frames_dp P1 check"] = ("decode_frames_dp", prof, P1,
                                      {"rs_mode": "check"})
    L["roundtrip_superframes_dp P2 8192"] = (
        "roundtrip_superframes_dp", make_raw_words(8192 * 15 + 4000, seed=40),
        P2, {})
    L["roundtrip_superframes_dp P1 256"] = (
        "roundtrip_superframes_dp", make_raw_words(256 * 8, seed=41),
        P1_SF256, {})
    # two damaged superframes on different ranks (sf 1 -> rank 0, 13 -> 3)
    raw = make_raw_words(64 * 16, seed=43)
    clean = _profiles(raw.reshape(16, 64, 9), P1_SF64[1])
    dirty = clean.copy()
    dirty[1, HW + 7, 4] = (dirty[1, HW + 7, 4] + 1) % 27
    dirty[13, HW + 30, 2] = (dirty[13, HW + 30, 2] + 2) % 27
    for cap in (3, 1):
        L[f"decode_superframes_fused_dp cap {cap}"] = (
            "decode_superframes_fused_dp", dirty, P1_SF64,
            {"repair_cap": cap})
    # header cells: 3 in one RS(26,18) block of sf 2 and of sf 13 (t=4)
    hdr = dirty.copy()
    dryrun.damage_header_cells(hdr, 2, (1, 9, 20))
    dryrun.damage_header_cells(hdr, 13, (27, 30, 40))
    L["decode_superframes_fused_dp header repaired"] = (
        "decode_superframes_fused_dp", hdr.copy(), P1_SF64,
        {"repair_cap": 4})
    dryrun.damage_header_cells(hdr, 13, (0, 2, 5, 11, 17))     # 5 in block A: beyond t
    L["decode_superframes_fused_dp header beyond capacity"] = (
        "decode_superframes_fused_dp", hdr, P1_SF64, {"repair_cap": 4})
    L["decode_superframes_fused_dp 6 superframes"] = (
        "decode_superframes_fused_dp", clean[:6], P1_SF64, {})
    L["roundtrip_step_dp P5 26x26"] = ("roundtrip_step_dp",
                                       _frames(8, 150, 80), P5, {})
    L["roundtrip_step_dp beacon"] = ("roundtrip_step_dp", _frames(8, 192, 60),
                                     BEACON, {})
    L["roundtrip_pipeline_pp P2"] = ("roundtrip_pipeline_pp",
                                     _pp_frames(3, 4, 192, 100), P2, {})
    frames = _pp_frames(2, 4, 192, 300)
    total = tpipe.build_encode_layout(P2[1], 192).total_words
    r = np.random.default_rng(42)
    dmg = np.zeros((2, 4, total, 9), np.int8)
    for mt, fr, band in [(0, 1, 2), (1, 3, 5), (1, 0, 0)]:
        for c in (3, 17):                   # 2 errors in body block 1
            dmg[mt, fr, HW + 26 + c, band] = r.integers(1, 27)
    L["roundtrip_pipeline_pp P2 link damage"] = (
        "roundtrip_pipeline_pp", frames, P2, {"wire_damage": dmg})
    dmg2 = np.zeros((2, 4, total, 9), np.int8)
    for c, d in zip((0, 1, 2), (5, 11, 17)):   # 3 errors, t=2: detected
        dmg2[0, 2, HW + 2 * 26 + c, 1] = d
    L["roundtrip_pipeline_pp P2 beyond capacity"] = (
        "roundtrip_pipeline_pp", frames, P2, {"wire_damage": dmg2})
    L["roundtrip_pipeline_pp P1"] = ("roundtrip_pipeline_pp",
                                     _pp_frames(2, 4, 128, 200), P1, {})
    L["encode_stream_sharded P2"] = ("encode_stream_sharded",
                                     make_raw_words(8 * 512, seed=50), P2, {})
    L["encode_stream_sharded P5 beacon"] = (
        "encode_stream_sharded", make_raw_words(2000, seed=51), P5_BEACON, {})
    return L


LEGS = _legs()
DIVERGENT = ("encode_frames_dp 6 frames",
             "decode_superframes_fused_dp 6 superframes",
             "decode_superframes_fused_dp header beyond capacity")
PARITY = [n for n in LEGS if n not in DIVERGENT]


# chip_smoke.py phase 10's legs at a small size: 24 superframes of 4,096
# words (bench_damage flags 20 of them), PP 4 x 6 frames, 3,000-word frames
REHEARSAL = {"n": 4096 * 24, "sfw": 4096, "frame": 3000, "pp": (4, 6)}


@pytest.fixture(scope="module")
def pool():
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        yield ex


@pytest.fixture(scope="module")
def port_run(pool):
    """Every leg on 4 gloo ranks of the CPU, started in the background:
    the result (one dict a rank) is read by the first test that needs it,
    while the tests before it compile the JAX side."""
    spec = [(name, fn, (x, cfgs[1]), kw)
            for name, (fn, x, cfgs, kw) in LEGS.items()]
    return pool.submit(launch.spawn, torch_mesh_ranks.run_legs, WORLD,
                       device="cpu", args=(spec,), timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def rehearsal(pool):
    """chip_smoke.py phase 10's rank function on 2 gloo ranks of the CPU,
    every leg, in the background."""
    import chip_smoke as cs
    return pool.submit(launch.spawn, cs.mesh_rank, 2, device="cpu",
                       args=(list(cs.MESH_LEGS), REHEARSAL),
                       timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def jmeshes():
    return JM.make_mesh(WORLD), JM.make_mesh_pp(WORLD)


def _jax(name, jmeshes):
    fn, x, cfgs, kw = LEGS[name]
    mesh = jmeshes[1] if fn == "roundtrip_pipeline_pp" else jmeshes[0]
    res = getattr(JM, fn)(x, cfgs[0], mesh, **kw)
    return [np.asarray(a) for a in (res if isinstance(res, tuple) else (res,))]


def _port(name, port_run):
    fn, x, _cfgs_, _kw = LEGS[name]
    out = port_run.result()[0][name]
    got = list(out["global"])
    if fn == "roundtrip_superframes_dp":
        got[0] = got[0][:x.shape[0]]        # the reference's [:n]
    return got


@pytest.mark.parametrize("name", PARITY)
def test_leg_matches_jax(name, port_run, rehearsal, jmeshes):
    want = _jax(name, jmeshes)
    got = _port(name, port_run)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w), name


def test_every_rank_gathers_the_same(port_run):
    runs = port_run.result()
    for name in LEGS:
        for other in runs[1:]:
            a, b = runs[0][name], other[name]
            assert a.keys() == b.keys()
            for x, y in zip(a.get("global", ()), b.get("global", ())):
                assert np.array_equal(x, y), name


def test_outputs_stay_sharded(port_run):
    """Each rank holds its own rows; only 0-d reductions are global."""
    runs = port_run.result()
    out = runs[0]
    assert out["encode_frames_dp P2"]["local"][0][0] == 8 // WORLD
    raw, ok, all_ok = out["decode_frames_dp P3 corrected"]["local"]
    assert raw[0] == ok[0] == 8 // WORLD and all_ok == ()
    raw, ok = out["decode_superframes_fused_dp cap 3"]["local"]
    assert raw[0] == 16 // WORLD and ok == ()
    # PP: T microbatches x this data index's db / (WORLD / 2) frames
    outs, oks = out["roundtrip_pipeline_pp P2"]["local"]
    assert outs[:2] == oks == (3, 4 // (WORLD // 2))
    sizes = [r["encode_stream_sharded P2"]["local"][0][0] for r in runs]
    assert sum(sizes) == out["encode_stream_sharded P2"]["global"][0].shape[0]


def test_fused_dp_validates_headers(port_run, jmeshes):
    """Header cells beyond the RS(26,18) chain's capacity: the port flags
    the stream, as the single-device fused decode of either package does;
    the JAX mesh function never validates headers and returns ok True.
    Within capacity both repair (test_leg_matches_jax)."""
    name = "decode_superframes_fused_dp header beyond capacity"
    _fn, words, (jcfg, tcfg), kw = LEGS[name]
    got_raw, got_ok = _port(name, port_run)
    j_raw, j_ok = _jax(name, jmeshes)
    assert bool(j_ok) and not bool(got_ok)
    assert np.array_equal(got_raw, j_raw)           # the bodies agree
    n = words.shape[0] * 64
    ref, ref_ok = jpipe.decode_stream_superframes(
        words, jcfg, n, strategy="fused", repair_cap=kw["repair_cap"])
    assert not bool(ref_ok)
    assert np.array_equal(got_raw[:, :64].reshape(-1, 9), np.asarray(ref))
    one, one_ok = tpipe.decode_stream_superframes(
        words, tcfg, n, strategy="fused", repair_cap=kw["repair_cap"],
        device="cpu")
    assert not bool(one_ok) and np.array_equal(one.numpy(), np.asarray(ref))


def test_shard_counts_must_divide(port_run):
    """The reference states that n_sf is a multiple of the mesh size and
    never checks it; the port raises, as GSPMD rejects a frame batch that
    does not split."""
    out = port_run.result()[0]
    assert "must be a multiple of the mesh size 4" in \
        out["decode_superframes_fused_dp 6 superframes"]["error"]
    assert "frame count: 6 is not a multiple of the 4 ranks" in \
        out["encode_frames_dp 6 frames"]["error"]


def test_nccl_needs_a_card_a_rank():
    two_on_one = [torch.device("cuda", 0)] * 2
    for backend in ("nccl", None):
        with pytest.raises(ValueError, match="backend='gloo'"):
            launch.resolve_backend(two_on_one, backend)
    assert launch.resolve_backend(two_on_one, "gloo") == "gloo"
    assert launch.resolve_backend([torch.device("cuda", 0),
                                   torch.device("cuda", 1)]) == "nccl"
    assert launch.resolve_backend([torch.device("cpu")] * 2) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        launch.resolve_backend([torch.device("cpu")] * 2, "nccl")
    assert launch.rank_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_make_mesh_rules(tmp_path, monkeypatch):
    """A mesh needs a process group; a PP mesh an even rank count."""
    import datetime
    import torch.distributed as dist
    monkeypatch.setattr(launch, "_rank_device", torch.device("cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        TM.make_mesh()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = TM.make_mesh()
        assert (mesh.rank, mesh.size, mesh.axes) == (0, 1, ("data",))
        x = torch.arange(6).view(3, 2)
        assert torch.equal(TM.gather(mesh, x), x)
        with pytest.raises(ValueError, match="even"):
            TM.make_mesh_pp()
        with pytest.raises(ValueError, match="world of 1"):
            TM.make_mesh(2)
    finally:
        dist.destroy_process_group()


def test_spawn_reraises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       r"(.|\n)*ValueError: rank 1 says no"):
        launch.spawn(torch_mesh_ranks.fail_on, 2, device="cpu", args=(1,),
                     timeout_s=60)


def test_spawn_times_out():
    with pytest.raises(TimeoutError, match="ran past 3 s"):
        launch.spawn(torch_mesh_ranks.sleep, 1, device="cpu", args=(60,),
                     timeout_s=3)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    """The dry run's legs on n gloo ranks of the CPU (any failure raises),
    and the reference's summary line."""
    dryrun.dryrun_multichip(n, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (
        f"dryrun_multichip OK on {n} devices (DP batch {2 * n}, "
        f"error-injected DP repair, fused-P5(5x5)+beacon DP batch {2 * n}, "
        f"stream {n * 64} words, superframe-DP {n * 64 + 11} words, "
        "fused two-phase repair + overflow fail-safe under superframe-DP, "
        "2-stage PP + error-injected PP repair)")


LAYOUTS = {"P2": P2[1], "P1": P1[1], "P5 26x26": P5[1], "beacon": BEACON[1],
           "P5 26x26 beacon": P5_BEACON[1],
           "P5 5x5 beacon": _cfgs("P5_RS26_22_2D", tile=(5, 5),
                                  beacon=(13, 4))[1],
           "UEP (0,1,2,2,1,0,1,1,2)": tconfig.EncoderConfig(
               profile=tconfig.ProfileID.P2_RS26_22,
               uep=tconfig.UEPLayout((0, 1, 2, 2, 1, 0, 1, 1, 2)))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stream_sharding_rows_every_layout(layout):
    """``encode_stream_sharded``'s row split on 1..7 ranks, without
    ranks: the rows of every split, with the header, equal the whole
    profile (a beacon codeword that crosses a split is computed on both
    sides)."""
    cfg = LAYOUTS[layout]
    for n in (36, 1001, 4096):
        raw = make_raw_words(n, seed=n)
        want = tpipe.encode_profile_from_raw(raw, cfg, device="cpu")
        lay = tpipe.build_encode_layout(cfg, n)
        for size in range(1, 8):
            rows = [tencode.encode_rows(raw, lay, *TM.body_rows(
                lay.geom.H, size, i), "cpu") for i in range(size)]
            got = torch.cat([torch.as_tensor(lay.header_words)] + rows)
            assert torch.equal(got, want), (layout, n, size)


def test_smoke_phase10_rehearsal(rehearsal):
    """Phase 10's legs on the CPU (their checks raise in the ranks): both
    ranks agree, and the digests are those of the inputs they decode."""
    import chip_smoke as cs
    runs = rehearsal.result()
    cpu = torch.device("cpu")
    raw = cs.digest(cs.mesh_raw(torch, cpu, REHEARSAL["n"], 0))
    frames = torch.stack([cs.mesh_raw(torch, cpu, REHEARSAL["frame"], 100 + i)
                          for i in range(2)])
    cfg = cs.mesh_cfg(port, REHEARSAL)
    prof = tpipe.encode_profile_from_raw(frames[0], cfg, device="cpu")
    want = {"superframe_dp": raw, "fused_dp": raw, "pp": raw,
            "frame_dp": 2 * cs.digest(frames) + cs.digest(prof)}
    for r in runs:
        assert sorted(r) == sorted(cs.MESH_LEGS)
        for leg, d in want.items():
            assert r[leg]["digest"] == d, leg
        assert r["fused_dp"]["header_superframes_repaired"] == 5
        assert r["fused_dp"]["flagged"] == 20
