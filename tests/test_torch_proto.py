"""The port's transform prototypes (ops/proto.py) and profile routing
(profiles.py) against the JAX package and the C++ goldens, on the CPU.

Inputs are the reference tests' images (tests/test_proto.py: the 72x48
golden image, a 70x45 one that takes the NN-resize pad).  Tolerances:
every integer output bit-exact (Haar LL, trits and reconstruction,
AnisoRC's artifacts and reconstruction, the packed bytes, the meta JSON);
the spectral sketch is float32 with other reduction orders on each side,
so it may differ in at most 2 of its 64 trits, from the JAX package and
from golden_proto_sketch_trits.bin, as the reference's own test allows.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ternary_image_codec_tpu import profiles as RPR
from ternary_image_codec_tpu.io import legacy_containers as RLC
from ternary_image_codec_tpu.ops import proto as RP
from ternary_image_codec_tpu_torch import profiles as PR
from ternary_image_codec_tpu_torch.io import legacy_containers as LC
from ternary_image_codec_tpu_torch.ops import proto as P

from test_proto import GOLD, RGB, make_rgb

SKETCH_TOL = 2          # of 64 trits
PAD_RGB = make_rgb(70, 45, 7)
IMAGES = {"golden72x48": RGB, "pad70x45": PAD_RGB}


def _gold(name, dtype=np.int8):
    return np.fromfile(os.path.join(GOLD, name), dtype=dtype)


def _np(x):
    return None if x is None else np.asarray(x)


def _t(x):
    return None if x is None else x.numpy()


# --- host constant builders ------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("_detail_order_indices", (8,)), ("_detail_order_indices", (4,)),
    ("_dct_basis", (32,)), ("_dct_basis", (8,)),
    ("_sketch_bin_onehot", (32, 8, 8)), ("_sketch_bin_onehot", (16, 4, 6)),
    ("_rc_bin_tables", (32, 8)), ("_rc_bin_tables", (32, 4)),
    ("_rc_bin_tables", (16, 8)), ("rc_proj_len_for_block", (32,)),
])
def test_constant_builders_equal(name, args):
    ref, got = getattr(RP, name)(*args), getattr(P, name)(*args)
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,),
                    got if isinstance(got, tuple) else (got,)):
        r, g = np.asarray(r), np.asarray(g)
        assert r.dtype == g.dtype and np.array_equal(r, g)


def test_rc_bins_follow_the_onehot_table():
    onehot, _ = RP._rc_bin_tables(32, 8)
    bins, hits = P._rc_bins(32, 8)
    inside = onehot.sum(-1) > 0
    pl = onehot.shape[-1]
    assert np.array_equal(bins == pl, ~inside)
    assert np.array_equal(bins[inside], onehot.argmax(-1)[inside])
    assert np.array_equal(hits, inside.sum(0))


# --- lifting and robust statistics -----------------------------------------


@pytest.mark.parametrize("fn", ["haar1d", "haar1d_inv", "haar2d",
                                "haar2d_inv"])
def test_haar_lifting(fn):
    v = np.random.default_rng(0).integers(-300, 300, size=(17, 8, 8),
                                          dtype=np.int32)
    want = np.asarray(getattr(RP, fn)(v))
    assert np.array_equal(getattr(P, fn)(torch.as_tensor(v)).numpy(), want)


def test_upper_median_and_robust_z():
    r = np.random.default_rng(1)
    for n in (24, 47, 64):                       # even sizes: the upper one
        v = r.integers(0, 9, size=(5, n)).astype(np.float32)
        med = P._upper_median(torch.as_tensor(v)).numpy()
        assert np.array_equal(med, np.asarray(RP._upper_median(v)))
        assert np.array_equal(med, np.sort(v, -1)[:, n // 2])
        z = P.robust_z(torch.as_tensor(v)).numpy()
        assert np.array_equal(z, np.asarray(RP.robust_z(v)))


# --- T1: Haar ternary tiles ------------------------------------------------


@pytest.mark.parametrize("image", IMAGES)
@pytest.mark.parametrize("keep_ll", [True, False])
def test_haar_tiles_and_reconstruction(image, keep_ll):
    rgb = IMAGES[image]
    rp, pp = RP.ProtoParams(keep_ll_u8=keep_ll), P.ProtoParams(keep_ll_u8=keep_ll)
    ll, tr, tx, ty = RP.proto_tile_haar_ternary(rgb, rp)
    ll2, tr2, tx2, ty2 = P.proto_tile_haar_ternary(rgb, pp, device="cpu")
    assert (tx2, ty2) == (tx, ty) == (9, 6)
    assert np.array_equal(tr2.numpy(), np.asarray(tr))
    assert np.array_equal(_t(ll2), _np(ll))
    want = np.asarray(RP.proto_reconstruct_y_from_tiles(ll, tr, tx, ty, rp))
    got = P.proto_reconstruct_y_from_tiles(ll2, tr2, tx, ty, pp, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_haar_goldens():
    ll, tr, tx, ty = P.proto_tile_haar_ternary(RGB, P.ProtoParams(),
                                               device="cpu")
    assert np.array_equal(ll.numpy(), _gold("golden_proto_tile_LL.bin",
                                            np.uint8))
    assert np.array_equal(tr.numpy(), _gold("golden_proto_tile_trits.bin"))
    rec = P.proto_reconstruct_y_from_tiles(ll, tr, tx, ty, P.ProtoParams(),
                                           device="cpu").numpy()
    assert np.array_equal(rec.reshape(-1),
                          _gold("golden_proto_haar_recon.bin", np.uint8))
    _, tr, _, _ = P.proto_tile_haar_ternary(PAD_RGB, P.ProtoParams(),
                                            device="cpu")
    assert np.array_equal(tr.numpy(), _gold("golden_proto_tile_trits_pad.bin"))


# --- T2: spectral sketch ---------------------------------------------------


@pytest.mark.parametrize("image", IMAGES)
def test_sketch_within_tolerance(image):
    rgb = IMAGES[image]
    got = P.proto_spectral_sketch(rgb, P.ProtoParams(), device="cpu").numpy()
    want = np.asarray(RP.proto_spectral_sketch(rgb, RP.ProtoParams()))
    assert got.shape == want.shape == (64,) and got.dtype == np.int8
    assert set(np.unique(got)) <= {-1, 0, 1}
    assert (got != want).sum() <= SKETCH_TOL
    if image == "golden72x48":
        assert (got != _gold("golden_proto_sketch_trits.bin")).sum() \
            <= SKETCH_TOL


@pytest.mark.cuda
def test_sketch_ignores_tf32(cuda_device):
    """The DCT is multiplies and sums, not a matmul: allowing TF32 for
    float32 matmuls leaves the trits as they are."""
    rgb = np.random.default_rng(5).integers(0, 256, size=(1080, 1920, 3),
                                            dtype=np.uint8)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        exact = P.proto_spectral_sketch(rgb, P.ProtoParams(), cuda_device)
        torch.set_float32_matmul_precision("high")
        tf32 = P.proto_spectral_sketch(rgb, P.ProtoParams(), cuda_device)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(exact, tf32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this there)")
    return torch.device("cuda")


# --- T3: AnisoRC -----------------------------------------------------------

RC_PARAMS = {"default": {}, "no_ll": {"keep_ll_u8": False},
             "angles4": {"angles": 4}, "raw_proj": {"normalize_proj": False},
             "block16_z08": {"block": 16, "tern_thresh_z": 0.8}}


@pytest.mark.parametrize("image", IMAGES)
@pytest.mark.parametrize("params", RC_PARAMS)
def test_aniso_rc_encode_and_reconstruct(image, params):
    rgb, kw = IMAGES[image], RC_PARAMS[params]
    rp, pp = RP.AnisoRCParams(**kw), P.AnisoRCParams(**kw)
    want = RP.proto_aniso_rc_encode(rgb, rp)
    got = P.proto_aniso_rc_encode(rgb, pp, device="cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(b, torch.Tensor):
            assert b.dtype in (torch.int8, torch.uint8)
            assert np.array_equal(b.numpy(), a), f.name
        else:
            assert a == b, f.name
    rec = P.proto_aniso_rc_reconstruct(got, pp, device="cpu").numpy()
    assert np.array_equal(rec, RP.proto_aniso_rc_reconstruct(want, rp))
    assert rec.shape == (got.H, got.W)


def test_aniso_rc_goldens():
    art = P.proto_aniso_rc_encode(RGB, P.AnisoRCParams(), device="cpu")
    assert np.array_equal(art.block_ll.numpy(),
                          _gold("golden_proto_rc_LL.bin", np.uint8))
    assert np.array_equal(art.trits.numpy(), _gold("golden_proto_rc_trits.bin"))
    assert (art.proj_len, art.angles_used, art.trits_per_block) == (47, 8, 192)


def test_psnr_y():
    r = np.random.default_rng(2)
    a, b = (r.integers(0, 256, size=(16, 16)).astype(np.uint8)
            for _ in range(2))
    assert P.psnr_y(torch.as_tensor(a), b) == RP.psnr_y(a, b)
    assert P.psnr_y(a, a) == RP.psnr_y(a, a) == float("inf")


# --- profiles --------------------------------------------------------------


def _configs(profile, **kw):
    return (RPR.ProtoConfig(profile=RLC.ProtoProfile(profile), **kw),
            PR.ProtoConfig(profile=LC.ProtoProfile(profile), **kw))


def test_profiles_host_api():
    assert [f.name for f in dataclasses.fields(PR.ProtoConfig)] == \
        [f.name for f in dataclasses.fields(RPR.ProtoConfig)]
    assert PR.ProtoConfig() == PR.ProtoConfig(**{
        f.name: getattr(RPR.ProtoConfig(), f.name)
        for f in dataclasses.fields(RPR.ProtoConfig)})
    for p in LC.ProtoProfile:
        assert PR.encode_prototype_available(p) == \
            RPR.encode_prototype_available(RLC.ProtoProfile(int(p)))
    with pytest.raises(ValueError):
        PR.encode_prototype_ternary(RGB, PR.ProtoConfig(), device="cpu")
    assert PR.describe_prototype_build() == RPR.describe_prototype_build()
    for x in (1.2, 0.8, 1.0, 1 / 3, 12345678.0):
        assert PR._fmt_float(x) == RPR._fmt_float(x)


@pytest.mark.parametrize("n", [0, 1, 4, 5, 6, 123])
def test_base243_balanced_pack(n):
    bal = np.random.default_rng(n).integers(-1, 2, size=n).astype(np.int8)
    packed = PR.pack_base243_from_balanced(bal)
    assert np.array_equal(packed, RPR.pack_base243_from_balanced(bal))
    back = PR.unpack_base243_to_balanced(packed, n)
    assert back.dtype == np.int8 and np.array_equal(back, bal)
    assert np.array_equal(back, RPR.unpack_base243_to_balanced(packed, n))


@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("kw", [{}, {"pack_base243": False},
                                {"haar_keep_ll_u8": False, "rc_angles": 4,
                                 "rc_tern_z": 0.9, "haar_thresh": 4}],
                         ids=["default", "no_pack", "options"])
def test_encode_prototype_ternary(profile, kw, tmp_path):
    """The meta JSON string-equal, the trits and packed bytes equal (Haar:
    its sketch part within the sketch's tolerance), and the .t3proto files
    of both packages byte-equal where the trits are."""
    rcfg, pcfg = _configs(profile, **kw)
    want_bal, want_pk, want_meta = RPR.encode_prototype_ternary(PAD_RGB, rcfg)
    bal, pk, meta = PR.encode_prototype_ternary(PAD_RGB, pcfg, device="cpu")
    assert meta == want_meta
    assert bal.dtype == np.int8 and bal.shape == want_bal.shape
    n_sk = json.loads(meta)["layout"].get("len_sketch", 0)
    head = bal.size - n_sk
    assert np.array_equal(bal[:head], want_bal[:head])
    assert (bal[head:] != want_bal[head:]).sum() <= SKETCH_TOL
    assert (pk is None) == (want_pk is None)
    if pk is not None:
        assert np.array_equal(PR.unpack_base243_to_balanced(pk, bal.size), bal)
    if np.array_equal(bal, want_bal):
        if pk is not None:
            assert np.array_equal(pk, want_pk)
        paths = [str(tmp_path / f"{s}.t3proto") for s in ("ref", "port")]
        RLC.t3proto_write(paths[0], rcfg.profile, 70, 45, want_bal, want_pk,
                          want_meta)
        LC.t3proto_write(paths[1], pcfg.profile, 70, 45, bal, pk, meta)
        data = [open(p, "rb").read() for p in paths]
        assert data[0] == data[1]
        prof, w, h, gb, gp, gm = LC.t3proto_read(paths[1])
        assert (prof, w, h, gm) == (pcfg.profile, 70, 45, meta)
        assert np.array_equal(gb, bal) and np.array_equal(_np(gp), _np(pk))
        assert LC.infer_ntrits_from_meta(70, 45, meta,
                                         0 if pk is None else pk.size) \
            == bal.size
