"""The port's serve path against the JAX package's: the base-243 wire pack
(ops/wirepack.py), the streaming T3V6 writer and reader (io/serve.py) and
the serve codecs (``serve_codec_fns``: encode + pack, unpack + check decode,
checksums), bit for bit on the CPU; then the serve loop of
``chip_smoke.py``'s phase 7 rehearsed at a small size."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu.io import serve as JS
from ternary_image_codec_tpu.ops import trits as JT
from ternary_image_codec_tpu.ops import wirepack as JW
import ternary_image_codec_tpu_torch as port
from ternary_image_codec_tpu_torch.config import SubwordMode
from ternary_image_codec_tpu_torch.io import containers as C
from ternary_image_codec_tpu_torch.io import serve as S
from ternary_image_codec_tpu_torch.ops import wirepack as W
from ternary_image_codec_tpu_torch.security import policy as P
from test_serve import make_raw

CPU = torch.device("cpu")
# (profile, uep, superframe_words, superframes): tests/test_serve.py's two
# configs, and one whose checksums wrap past 2^31
CFGS = [("P2_RS26_22", "luma", 64, 6), ("P1_RS26_24", "uniform", 32, 6),
        ("P2_RS26_22", "luma", 512, 15)]


def _cfgs(profile, uep, sf):
    def one(m):
        u = m.uep_luma_priority() if uep == "luma" else m.uep_uniform(0)
        return m.EncoderConfig(profile=getattr(m.ProfileID, profile), uep=u,
                               superframe_words=sf)
    return one(jconfig), one(port)


def chunks_of(raw, sf, n_sf):
    c = np.zeros((n_sf * sf, 9), np.int8)
    c[:len(raw)] = raw
    return c.reshape(n_sf, sf, 9)


class TestWirePack:
    @pytest.mark.parametrize("total", [101, 102, 103, 104, 105])
    def test_matches_jax_and_np_oracle(self, total):
        """9 * total mod 5 takes every value over the five totals."""
        r = np.random.default_rng(total)
        planes = r.integers(0, 27, size=(4, 9, total)).astype(np.int8)
        by = W.pack_wire(torch.as_tensor(planes)).numpy()
        assert by.shape == (4, W.sf_bytes(total)) and by.dtype == np.uint8
        np.testing.assert_array_equal(
            by, np.asarray(JW.pack_wire(jnp.asarray(planes))))
        np.testing.assert_array_equal(by, W.np_pack_wire(planes))
        np.testing.assert_array_equal(
            W.unpack_wire(torch.as_tensor(by), total).numpy(), planes)
        noise = r.integers(0, 256, size=by.shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            W.unpack_wire(torch.as_tensor(noise), total).numpy(),
            np.asarray(JW.unpack_wire(jnp.asarray(noise), total)))

    def test_every_byte_value(self):
        """Bytes 243..255 unpack as b mod 243, as the reference's trit
        expansion drops their quotient digit; each byte is reduced before
        three are combined, so nothing carries into the next."""
        total = 142                                  # sf_bytes 767 >= 256
        by = np.zeros((2, W.sf_bytes(total)), np.uint8)
        by[0, :256] = np.arange(256)
        by[1, :256] = np.arange(256)[::-1]
        got = W.unpack_wire(torch.as_tensor(by), total).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JW.unpack_wire(jnp.asarray(by), total)))
        np.testing.assert_array_equal(
            W.pack_wire(torch.as_tensor(got)).numpy(), by % 243)

    def test_symbols_outside_0_26(self):
        """int8 symbols pack as s mod 27 with floor semantics, negative
        ones included."""
        vals = np.arange(-128, 128, dtype=np.int8)
        planes = np.resize(vals, (3, 9, 103)).astype(np.int8)
        planes[1] = np.random.default_rng(1).permutation(planes[1].ravel()) \
            .reshape(9, 103)
        by = W.pack_wire(torch.as_tensor(planes)).numpy()
        np.testing.assert_array_equal(
            by, np.asarray(JW.pack_wire(jnp.asarray(planes))))
        np.testing.assert_array_equal(by, W.np_pack_wire(planes % 27))

    def test_base243_convention(self):
        """The byte stream is the base-243 packing of the C-order symbol
        stream, 3 trits LSD first a symbol."""
        planes = (np.arange(27, dtype=np.int8) % 27).reshape(1, 9, 3)
        by = W.pack_wire(torch.as_tensor(planes)).numpy()[0]
        tr = planes.astype(np.int64).reshape(-1, 1) // [1, 3, 9] % 3
        ref, _tail = JT.np_trits_to_base243(tr.reshape(-1))
        np.testing.assert_array_equal(by, ref)

    def test_short_rows_raise(self):
        with pytest.raises(ValueError, match="bytes a superframe"):
            W.unpack_wire(torch.zeros((1, W.sf_bytes(50) - 1), dtype=torch.uint8),
                          50)


def _payloads(n, nbytes, seed=3):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, nbytes, dtype=np.uint8) for _ in range(n)]


class TestStreamContainers:
    def test_writer_bytes_equal_the_jax_packages(self, tmp_path):
        """Same payloads, both writers: identical files (header CRC, index
        and padding included); each package reads the other's file.  The
        port's writer takes a CPU tensor's memory, a short payload is
        zero-padded."""
        pays = _payloads(3, 60)
        mine, ref = str(tmp_path / "m.t3v"), str(tmp_path / "r.t3v")
        kw = dict(meta_global='{"domain":"acme/x"}', meta_per_frame='{"f":1}')
        with S.T3V6StreamWriter(mine, SubwordMode.S27, 64, 32, 3, 64,
                                **kw) as wtr:
            for i in (2, 0, 1):                      # any order
                wtr.write_frame(i, torch.as_tensor(pays[i]).numpy())
        with JS.T3V6StreamWriter(ref, jconfig.SubwordMode.S27, 64, 32, 3, 64,
                                 **kw) as wtr:
            for i in (2, 0, 1):
                wtr.write_frame(i, pays[i].tobytes())
        with open(mine, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
        want = [np.concatenate([p, np.zeros(4, np.uint8)]) for p in pays]
        with S.T3V6StreamReader(ref) as rd, JS.T3V6StreamReader(mine) as jrd:
            assert (rd.sub, rd.w, rd.h, rd.frame_count, rd.meta_global) == \
                (SubwordMode.S27, 64, 32, 3, '{"domain":"acme/x"}')
            for i in range(3):
                assert rd.read_frame_bytes(i) == want[i].tobytes()
                assert jrd.read_frame_bytes(i) == want[i].tobytes()
                buf = np.zeros(80, np.uint8)
                mv = rd.read_frame_into(i, buf)
                assert bytes(mv) == want[i].tobytes()
        for i in range(3):
            np.testing.assert_array_equal(C.t3v_read_frame(mine, i),
                                          want[i].view("<u4"))

    def test_reader_gates_before_the_payload(self, tmp_path):
        p = str(tmp_path / "gate.t3v")
        with S.T3V6StreamWriter(p, SubwordMode.S27, 8, 8, 1, 32,
                                meta_per_frame='{"domain":"evil/x"}') as w:
            w.write_frame(0, np.arange(8, dtype="<u4").tobytes())
        calls = []
        buf = np.full(32, 0xAB, np.uint8)
        with S.T3V6StreamReader(
                p, approve_meta=lambda m: calls.append(m) or False) as rd:
            with pytest.raises(C.ContainerError, match="not approved"):
                rd.read_frame_into(0, buf)
            fi = rd.index[0]
            assert rd._f.tell() == fi.offset + fi.meta_len
            with pytest.raises(C.ContainerError, match="not approved"):
                rd.read_frame_bytes(0)
        assert calls == ['{"domain":"evil/x"}'] * 2 and (buf == 0xAB).all()
        pol = P.Policy(memberships=[P.Membership("acme/")])
        with S.T3V6StreamReader(
                p, approve_meta=P.t3v_approve_with_policy(pol)) as rd:
            with pytest.raises(C.ContainerError, match="not approved"):
                rd.read_frame_bytes(0)

    def test_reader_errors(self, tmp_path):
        p = str(tmp_path / "crc.t3v")
        with S.T3V6StreamWriter(p, SubwordMode.S27, 8, 8, 1, 32) as w:
            w.write_frame(0, bytes(range(32)))
        with S.T3V6StreamReader(p) as rd:
            off = rd.index[0].offset
            with pytest.raises(C.ContainerError, match="OOB"):
                rd.read_frame_bytes(1)
            with pytest.raises(C.ContainerError, match="buffer"):
                rd.read_frame_into(0, np.zeros(31, np.uint8))
        with open(p, "r+b") as f:
            f.seek(off + 5)
            f.write(b"\xff")
        with S.T3V6StreamReader(p) as rd:
            with pytest.raises(C.ContainerError, match="crc"):
                rd.read_frame_bytes(0)
            with pytest.raises(C.ContainerError, match="crc"):
                rd.read_frame_into(0, np.zeros(32, np.uint8))
            assert len(rd.read_frame_bytes(0, check_crc=False)) == 32
        with pytest.raises(C.ContainerError, match="4-aligned"):
            S.T3V6StreamWriter(str(tmp_path / "x.t3v"), SubwordMode.S27, 8,
                               8, 1, 30)
        with S.T3V6StreamWriter(str(tmp_path / "y.t3v"), SubwordMode.S27, 8,
                                8, 1, 32) as w:
            with pytest.raises(C.ContainerError, match="size"):
                w.write_frame(0, bytes(36))


class TestServeCodecs:
    def test_checksum_wraps_like_int32(self):
        """The reference sums in int32 and wraps; torch sums int32 into
        int64, so the port wraps the exact sum itself."""
        x = torch.full((3, 9, 5000), 26, dtype=torch.int8)
        x[1, 4, 17] = -128
        col = np.arange(9 * 5000, dtype=np.int64) % 8191 + 1
        exact = int((x.reshape(3, -1).numpy().astype(np.int64) * col).sum())
        assert exact > 2**32
        got = S.checksum(x)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == (exact + 2**31) % 2**32 - 2**31
        jx = jnp.asarray(x.numpy()).astype(jnp.int32).reshape(3, -1)
        assert int(got) == int(jnp.sum(jx * jnp.asarray(col, jnp.int32),
                                       dtype=jnp.int32))

    @pytest.mark.parametrize("profile,uep,sf,n_sf", CFGS)
    def test_matches_the_jax_package(self, profile, uep, sf, n_sf):
        """enc_serve's bytes and checksum, dec_serve's ok and both
        checksums, on clean and damaged bytes, and the geometry."""
        jcfg, tcfg = _cfgs(profile, uep, sf)
        n_raw = sf * (n_sf - 1) + 17
        jenc, jdec, jgeom = JS.serve_codec_fns(jcfg, n_raw, sf_batch=4)
        enc, dec, geom = S.serve_codec_fns(tcfg, n_raw, sf_batch=4,
                                           device="cpu")
        assert geom == jgeom and geom["frame_bytes"] % 4 == 0
        c = chunks_of(make_raw(n_raw, seed=10 + sf), sf, n_sf)
        by, ck = enc(torch.as_tensor(c))
        jby, jck = jenc(jnp.asarray(c))
        assert by.shape == (n_sf, geom["sf_bytes"]) and by.dtype == torch.uint8
        np.testing.assert_array_equal(by.numpy(), np.asarray(jby))
        assert ck.dtype == torch.int32 and int(ck) == int(jck)
        bad = by.clone()
        bad[1, 40] = (int(bad[1, 40]) + 81) % 243    # one body trit of sf 1
        for b in (by, bad):
            got, want = dec(b), jdec(jnp.asarray(b.numpy()))
            assert [g.dtype for g in got] == [torch.bool, torch.int32,
                                              torch.int32]
            assert [int(g) for g in got] == [int(w) for w in want]
        assert bool(dec(by)[0]) and not bool(dec(bad)[0])
        if n_sf == 15:                               # the wrapping case
            assert int(ck) < 0 and int(dec(by)[2]) != 0

    def test_codecs_run_on_the_card_by_default(self):
        cfg = _cfgs("P2_RS26_22", "luma", 64)[1]
        if torch.cuda.is_available():
            enc, _dec, _geom = S.serve_codec_fns(cfg, 100)
            by, ck = enc(torch.zeros((2, 64, 9), dtype=torch.int8))
            assert by.is_cuda and ck.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device"):
                S.serve_codec_fns(cfg, 100)

    def test_meta_global_matches(self):
        jcfg, tcfg = _cfgs("P2_RS26_22", "luma", 64)
        assert S.serve_meta_global(tcfg, 1000, 64, 32, {"x": 1}) == \
            JS.serve_meta_global(jcfg, 1000, 64, 32, {"x": 1})


@pytest.mark.parametrize("profile,uep,sf,n_sf", CFGS[:2])
def test_serve_loop_rehearsal(tmp_path, profile, uep, sf, n_sf):
    """chip_smoke.py's phase 7 on the CPU at a small size: the same
    helpers drive frames through StreamExecutor into a T3V6 file and back
    behind an admitting policy, then ``serve_checks`` (ok, checksums,
    frame 0 exact, file bytes against np_pack_wire, CRC error on a flipped
    byte, denial before the payload).  The reference's writer would have
    written the same file."""
    import chip_smoke as cs
    jcfg, cfg = _cfgs(profile, uep, sf)
    n_raw = sf * (n_sf - 1) + 17
    frames = cs.serve_frames(torch, cfg, n_raw, 3, CPU)
    assert all(f.shape == (n_sf, sf, 9) for f in frames)
    path = str(tmp_path / "serve.t3v")
    admit = P.t3v_approve_with_policy(
        P.Policy(memberships=[P.Membership("acme/")]))
    cks, wsplit, _ = cs.serve_write(torch, cfg, n_raw, frames, path, CPU,
                                    w=64, h=32)
    res, rsplit, _ = cs.serve_read(torch, cfg, n_raw, path, CPU, admit)
    assert wsplit["crc"] > 0 and rsplit["crc"] > 0
    ock0 = cs.serve_checks(torch, cfg, n_raw, frames, path, CPU, cks, res)
    assert res[0][2] == ock0
    jenc, _jdec, geom = JS.serve_codec_fns(jcfg, n_raw, sf_batch=4)
    ref = str(tmp_path / "ref.t3v")
    with JS.T3V6StreamWriter(
            ref, jcfg.subword, 64, 32, 3, geom["frame_bytes"],
            meta_global=JS.serve_meta_global(jcfg, n_raw, 64, 32),
            meta_per_frame=cs.SERVE_META) as wtr:
        for i, f in enumerate(frames):
            by, ck = jenc(jnp.asarray(f.numpy()))
            assert int(ck) == cks[i]
            wtr.write_frame(i, np.asarray(by))
    with open(path, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
