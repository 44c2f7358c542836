"""The port's copies of io/containers.py, io/legacy_containers.py and
runtime/native.py (with its own t3native.cpp) against the golden files the
compiled C++ reference wrote and against the JAX package's copies: bytes
written, bytes read, CRCs and the approval gate."""
import os
import zlib

import numpy as np
import pytest
import torch

from ternary_image_codec_tpu.config import SubwordMode as JSub
from ternary_image_codec_tpu.io import containers as JC
from ternary_image_codec_tpu.io import legacy_containers as JLC
from ternary_image_codec_tpu.cli import sigs
from ternary_image_codec_tpu.ops import trits as JT
from ternary_image_codec_tpu.runtime import native as jnative
from ternary_image_codec_tpu_torch.config import (ActiveWindow, CosetID,
                                                  ProfileID, SubwordMode,
                                                  centered_window)
from ternary_image_codec_tpu_torch.io import containers as C
from ternary_image_codec_tpu_torch.io import legacy_containers as LC
from ternary_image_codec_tpu_torch.ops.trits import np_trits_to_base243
from ternary_image_codec_tpu_torch.ops.wordcodec import (quant_to_words13,
                                                        words13_to_quant)
from ternary_image_codec_tpu_torch.runtime import native

from test_containers import META, ref_frames, ref_words
from test_legacy_containers import _ref_lcg_trits as _lcg_trits
from test_legacy_containers import _ref_lcg_words as _lcg_words

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def gold(name):
    with open(os.path.join(GOLD, name), "rb") as f:
        return f.read()


def read(path):
    with open(path, "rb") as f:
        return f.read()


def same_but_header_crc(mine, ref):
    """Bytes 22..25 are the header CRC: the reference CRCs uninitialized
    struct padding, so that field is garbage in reference files
    (docs/DIVERGENCES.md #9); everything else must match exactly."""
    assert len(mine) == len(ref)
    assert mine[:22] == ref[:22] and mine[26:] == ref[26:]


class TestT3P6T3V6:
    def test_t3p_bytes_match_reference(self, tmp_path):
        p = str(tmp_path / "mine.t3p")
        C.t3p_write(p, SubwordMode.S21, 1920, 1080, ref_words(), META)
        same_but_header_crc(read(p), gold("golden_ref.t3p"))

    def test_t3p_empty_bytes_match(self, tmp_path):
        p = str(tmp_path / "empty.t3p")
        C.t3p_write(p, SubwordMode.S27, 0, 0, np.zeros(0, np.uint32), "")
        same_but_header_crc(read(p), gold("golden_ref_empty.t3p"))

    def test_t3v_bytes_match_reference(self, tmp_path):
        p = str(tmp_path / "mine.t3v")
        C.t3v_write(p, SubwordMode.S18, 1280, 720, ref_frames(),
                    '{"fps":30}', ['{"f":0}', '{"f":1}', '{"f":2}'])
        same_but_header_crc(read(p), gold("golden_ref.t3v"))

    def test_read_reference_files(self):
        p = os.path.join(GOLD, "golden_ref.t3p")
        sub, w, h, meta, n = C.t3p_read_header(p, check_header_crc=False)
        assert (sub, w, h, meta, n) == (SubwordMode.S21, 1920, 1080, META, 100)
        np.testing.assert_array_equal(
            C.t3p_read_payload(p, check_header_crc=False), ref_words())
        v = os.path.join(GOLD, "golden_ref.t3v")
        sub, w, h, metag, fc, _idx = C.t3v_read_header(v, check_header_crc=False)
        assert (sub, w, h, metag, fc) == (SubwordMode.S18, 1280, 720,
                                          '{"fps":30}', 3)
        for i, frame in enumerate(ref_frames()):
            np.testing.assert_array_equal(
                C.t3v_read_frame(v, i, check_header_crc=False), frame)

    def test_files_identical_to_the_jax_packages(self, tmp_path):
        """Same inputs, both packages' writers: the same bytes, header CRC
        included; and each package reads the other's file."""
        r = np.random.default_rng(4)
        words = r.integers(0, 2**32, 333, dtype=np.uint32)
        frames = [r.integers(0, 2**32, n, dtype=np.uint32) for n in (0, 5, 64)]
        mine, ref = str(tmp_path / "m.t3p"), str(tmp_path / "r.t3p")
        C.t3p_write(mine, SubwordMode.S24, 7680, 4320, words, META)
        JC.t3p_write(ref, JSub.S24, 7680, 4320, words, META)
        assert read(mine) == read(ref)
        np.testing.assert_array_equal(JC.t3p_read_payload(mine), words)
        mine, ref = str(tmp_path / "m.t3v"), str(tmp_path / "r.t3v")
        C.t3v_write(mine, SubwordMode.S15, 64, 32, frames, "{}",
                    ["a", "", "c"])
        JC.t3v_write(ref, JSub.S15, 64, 32, frames, "{}", ["a", "", "c"])
        assert read(mine) == read(ref)
        for i, fr in enumerate(frames):
            np.testing.assert_array_equal(C.t3v_read_frame(ref, i), fr)
            np.testing.assert_array_equal(JC.t3v_read_frame(mine, i), fr)

    def test_roundtrip_and_gates(self, tmp_path):
        p = str(tmp_path / "x.t3p")
        C.t3p_write(p, SubwordMode.S15, 854, 480, ref_words(7), '{"a":1}')
        assert C.t3p_read_header(p) == (SubwordMode.S15, 854, 480, '{"a":1}', 7)
        np.testing.assert_array_equal(C.t3p_read_payload(p), ref_words(7))
        seen = []
        with pytest.raises(C.ContainerError, match="not approved"):
            C.t3p_read_payload(p, approve_meta=lambda m: seen.append(m))
        assert seen == ['{"a":1}']
        v = str(tmp_path / "x.t3v")
        C.t3v_write(v, SubwordMode.S27, 2, 2, ref_frames(), "", ["a", "b", "c"])
        np.testing.assert_array_equal(
            C.t3v_read_frame(v, 1, approve_meta=lambda m: m == "b"),
            ref_frames()[1])
        with pytest.raises(C.ContainerError, match="not approved"):
            C.t3v_read_frame(v, 2, approve_meta=lambda m: m == "b")
        with pytest.raises(C.ContainerError, match="OOB"):
            C.t3v_read_frame(v, 5)

    def test_corruption_and_bad_magic(self, tmp_path):
        p = str(tmp_path / "x.t3p")
        C.t3p_write(p, SubwordMode.S27, 4, 4, ref_words(8), "meta")
        raw = bytearray(read(p))
        raw[-6] ^= 0xFF                               # payload byte
        with open(p, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(C.ContainerError, match="payload crc"):
            C.t3p_read_payload(p)
        raw[8] ^= 0x01                                # header field
        with open(p, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(C.ContainerError, match="header crc"):
            C.t3p_read_header(p)
        with open(p, "wb") as f:
            f.write(b"NOPE" + b"\x00" * 30)
        with pytest.raises(C.ContainerError, match="magic"):
            C.t3p_read_header(p)


class TestNative:
    def test_builds_outside_the_jax_package(self):
        assert native.available()
        assert native.so_path().exists()
        jdir = os.path.dirname(os.path.abspath(jnative.__file__))
        assert not str(native.so_path().resolve()).startswith(jdir)

    def test_crc32_matches_zlib(self):
        """Bit-identical to zlib across sizes (block boundaries at 64/16
        bytes), inits and buffer types, through the container's CRC."""
        r = np.random.default_rng(11)
        for n in (0, 1, 3, 15, 16, 17, 63, 64, 65, 255, 256, 257, 300,
                  511, 512, 1000, 4097, 1 << 16):
            buf = r.integers(0, 256, n, dtype=np.uint8)
            for init in (0, 1, 0xFFFFFFFF, 0xDEADBEEF):
                want = zlib.crc32(buf.tobytes(), init) & 0xFFFFFFFF
                assert C._crc32(buf.tobytes(), init) == want, (n, init)
                assert C._crc32(buf, init) == want, (n, init)
                assert C._crc32(memoryview(buf), init) == want, (n, init)
                assert native.crc32(buf, init) == want, (n, init)

    def test_byte_codecs_match_the_references(self):
        """CRC-12, base-243 and word13 from the port's library equal the
        reference's numpy paths on the same random inputs (the JAX
        package's own library is not loaded: it builds next to its source,
        racing other test processes)."""
        r = np.random.default_rng(12)
        for n in (0, 1, 4, 5, 6, 999, 5000):
            tr = r.integers(0, 3, n).astype(np.uint8)
            by, tail = native.pack_base243(tr)
            jby, jtail = JT.np_trits_to_base243(tr)
            np.testing.assert_array_equal(by, jby)
            assert tail == jtail == n % 5
            np.testing.assert_array_equal(native.unpack_base243(by, n), tr)
            raw = r.integers(0, 256, n, dtype=np.uint8)
            assert native.crc12_0x80F(raw) == sigs._crc12_numpy(raw)
            np.testing.assert_array_equal(native.unpack_base243(raw, 5 * n),
                                          JT.np_base243_to_trits(raw, 5 * n))
        with pytest.raises(ValueError):
            native.unpack_base243(np.zeros(2, np.uint8), 11)
        q = np.stack([r.integers(-5, 250, 500), *r.integers(-45, 45, (2, 500))],
                     axis=1)
        np.testing.assert_array_equal(
            native.pack13(q[:, 0], q[:, 1], q[:, 2]),
            quant_to_words13(torch.as_tensor(q)).numpy().astype(np.uint32))
        code = r.integers(0, 243 * 81 * 81, 500).astype(np.uint32)
        np.testing.assert_array_equal(
            native.unpack13(code),
            words13_to_quant(torch.as_tensor(code.astype(np.int64))).numpy())
        assert native.warm_heap()


class TestLegacy:
    def test_t3p1_and_t3v1(self, tmp_path):
        p = str(tmp_path / "x.t3p")
        LC.t3p1_write(p, [1, 2, 0, 1, 1, 2])
        raw = read(p)
        assert raw[:4] == b"T3P1" and int.from_bytes(raw[4:8], "little") == 6
        assert raw[8] == 1 + 2 * 3 + 0 * 9 + 1 * 27 + 1 * 81 and raw[9] == 2
        np.testing.assert_array_equal(LC.t3p1_read(p), [1, 2, 0, 1, 1, 2])
        frames = [_lcg_words(5, 1), _lcg_words(8, 2)]
        v = str(tmp_path / "x.t3v")
        LC.t3v1_write(v, frames)
        for a, b in zip(frames, LC.t3v1_read_all(v)):
            np.testing.assert_array_equal(a, b)
        with open(p, "wb") as f:
            f.write(b"XXXX" + b"\0" * 8)
        with pytest.raises(C.ContainerError):
            LC.t3p1_read(p)

    def test_t3p_old_and_t3b_match_reference(self, tmp_path):
        p = str(tmp_path / "g.t3p")
        LC.t3p_old_write(p, SubwordMode.S21, True, 1920, 1080,
                         _lcg_trits(123, 7))
        assert read(p) == gold("golden_legacy_old.t3p")
        hdr, tr = LC.t3p_old_read(os.path.join(GOLD, "golden_legacy_old.t3p"))
        assert hdr.subword == SubwordMode.S21 and hdr.tail_trits == 123 % 5
        np.testing.assert_array_equal(tr, _lcg_trits(123, 7))
        pb = str(tmp_path / "g.t3b")
        LC.t3b_write(pb, SubwordMode.S18, False, 1280, 720, _lcg_trits(40, 99))
        assert read(pb) == gold("golden_legacy.t3b")
        raw = bytearray(read(pb))
        raw[31] ^= 0x5A                               # payload byte
        with open(pb, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(C.ContainerError):
            LC.t3b_read(pb)

    def _hdr(self):
        return LC.T3VOldHeader(
            file_type=1, profile=ProfileID.P2_RS26_22,
            subword=SubwordMode.S21, centered=True, coset=CosetID.C1,
            width=7680, height=4320, aw=centered_window(SubwordMode.S21),
            fps_num=30, fps_den=1)

    def test_t3v_old_matches_reference(self, tmp_path):
        frames = [_lcg_words(50 + i, 31 * (i + 1)) for i in range(3)]
        p = str(tmp_path / "g.t3v")
        LC.t3v_old_write(p, self._hdr(), frames)
        assert read(p) == gold("golden_legacy_old.t3v")
        hdr, got = LC.t3v_old_read_frames(
            os.path.join(GOLD, "golden_legacy_old.t3v"))
        assert hdr.frame_count == 3 and hdr.coset == CosetID.C1
        assert hdr.aw == ActiveWindow(2880, 1620, 1920, 1080)
        for a, b in zip(frames, got):
            np.testing.assert_array_equal(a, b)
        raw = bytearray(read(p))
        raw[54 + 4 + 3] ^= 1                          # symbol byte, frame 0
        with open(p, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(C.ContainerError):
            LC.t3v_old_read_frames(p)

    def test_t3v_old_resume_scan(self, tmp_path):
        frames = [_lcg_words(40 + i, 11 * (i + 1)) for i in range(3)]
        p = str(tmp_path / "x.t3v")
        LC.t3v_old_write(p, self._hdr(), frames)
        full = read(p)
        offs, end = LC.t3v_old_resume_scan(p)
        assert len(offs) == 3 and end == len(full)
        with open(p, "wb") as f:
            f.write(full[:offs[2] + 10])
        offs2, end2 = LC.t3v_old_resume_scan(p)
        assert offs2 == offs[:2] and end2 == offs[2]
        with open(p, "r+b") as f:
            f.truncate(end2)
            f.seek(0, os.SEEK_END)
            f.write(LC._t3v_old_frame_bytes(frames[2]))
        LC.t3v_old_finalize_header(p, 3)
        assert read(p) == full

    def test_t3vi_matches_reference(self, tmp_path):
        got = str(tmp_path / "scan.t3vi")
        assert LC.t3v_scan_and_index(
            os.path.join(GOLD, "golden_legacy_old.t3v"), got) == 3
        assert read(got) == gold("golden_legacy_old.t3vi")
        assert LC.t3vi_read(got) == JLC.t3vi_read(got)

    def test_t3proto_matches_reference(self, tmp_path):
        bal = (np.arange(77) % 3 - 1).astype(np.int8)
        by, _ = np_trits_to_base243(bal + 1)
        p = str(tmp_path / "g.t3proto")
        meta = '{"proto":"haar","block":8,"n_trits":77,"tail_trits":2}'
        LC.t3proto_write(p, LC.ProtoProfile.HAAR_TERNARY, 64, 48, bal, by, meta)
        assert read(p) == gold("golden_legacy.t3proto")
        p2 = str(tmp_path / "g2.t3proto")
        LC.t3proto_write(p2, LC.ProtoProfile.ANISO_RC, 32, 32, None, by,
                         '{"tail_trits":2}')
        assert read(p2) == gold("golden_legacy_packonly.t3proto")
        prof, w, h, gb, gp, gm = LC.t3proto_read(p)
        assert prof == LC.ProtoProfile.HAAR_TERNARY and (w, h) == (64, 48)
        np.testing.assert_array_equal(gb, bal)
        np.testing.assert_array_equal(gp, by)
        assert gm == meta

    def test_meta_helpers_match_the_jax_packages(self):
        for args in ((0, 0, '{"n_trits": 42}', 100),
                     (0, 0, '{"len_tiles":30,"len_sketch":12}', 100),
                     (65, 33, '{"trits_per_block":10,"block":32}', 0),
                     (0, 0, '{"tail_trits":2}', 16), (0, 0, "{}", 16)):
            assert LC.infer_ntrits_from_meta(*args) == \
                JLC.infer_ntrits_from_meta(*args)
        for meta, key in (('{"a": 12, "b":3}', "b"), ('{"a": 12}', "x"),
                          ('{"a": "str"}', "a")):
            assert LC.meta_find_int(meta, key) == JLC.meta_find_int(meta, key)
