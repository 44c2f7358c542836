"""K4 and K5 (the frame pixel bridges, csrc/bridge.cu) against their plain
twins, ``wordcodec.ingest9_ref`` and ``egress9_ref`` on the CPU.

* The wrapper (``ops/bridge_cuda.py``): a CPU tensor goes to the twin, a
  wrong dtype, shape or device raises, and nothing but a CUDA tensor
  reaches the loaded library (patched here by one that records calls).
* The fix-up table the wrapper uploads is ``quant``'s arrays, and each
  float32 literal of the source is ``quant.f32`` of its decimal.
* A numpy model of the kernels' per-pixel steps (the byte to float32 by
  its bits, one rounding per product and sum with the source's constants,
  the rounding by an add rounded down, the integer quantiser, the trit
  pack; the unpack by offset floor division, the inverse quantiser with
  the uploaded fix-ups), equals the twins on the boundary and FMA-tie
  pixels, a seeded sample of triples, an odd pixel count, every pixel code
  and seeded int8 words; a model of the staging covers every byte of a
  range exactly once at every alignment.
* ``chip_smoke.hold_bridges``, phase 6's check, runs on the CPU with the
  model in the kernels' place.

On the card (``cuda`` marker; ``chip_smoke.py`` phase 6 runs the same
checks there): K4/K5 equal the twins on every RGB triple, every pixel
code, random int8 words, 1x1 and 3x5 frames, unaligned and strided inputs
and one 8K frame each way, one launch a call; ``encode_rgb`` and
``decode_rgb`` launch each once.

Tolerance: zero.  This file does not import JAX.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import rgb_ties
from ternary_image_codec_tpu_torch import config as c
from ternary_image_codec_tpu_torch.codec import codec_for
from ternary_image_codec_tpu_torch.ops import bridge_cuda as B
from ternary_image_codec_tpu_torch.ops import quant as Q
from ternary_image_codec_tpu_torch.ops import wordcodec as W
from ternary_image_codec_tpu_torch.runtime import build

SRC = (Path(B.__file__).resolve().parents[1] / "csrc" / "bridge.cu") \
    .read_text()
# name -> (float32 value, the decimal in its comment)
LITERALS = {m[1]: (np.float32(float.fromhex(m[2])), m[3]) for m in re.finditer(
    r"constexpr float (\w+) = (-?0x[0-9a-f.p+-]+)f;\s+// (-?[0-9.]+)", SRC)}
K = {name: v for name, (v, _) in LITERALS.items()}
F32 = np.float32


# --- the numpy model of K4 and K5 ------------------------------------------


def u2f(b):
    """float32 of integers 0 <= b < 2^23: the bits of 2^23 + b less 2^23."""
    return (np.int32(0x4B000000) | b.astype(np.int32)).view(np.float32) \
        - F32(8388608.0)


def round_u8(v):
    """clamp(floor(v + 0.5), 0, 255): clamped, then x + 2^23 rounded down
    to float32 (exact in float64, spacing 1 there), less the bits of
    2^23."""
    x = np.minimum(np.maximum(v + K["HALF"], F32(0)), F32(255))
    down = np.floor(x.astype(np.float64) + 2.0 ** 23).astype(np.float32)
    return down.view(np.int32) - np.int32(0x4B000000)


def lround_ratio(n, p, q):
    mag = (2 * p * np.abs(n) + q) // (2 * q)
    return np.where(n < 0, -mag, mag)


def quant_pixel(rgb):
    """(Yq, Cbq + 40, Crq + 40) of (n, 3) uint8 pixels."""
    r, g, b = (u2f(rgb[:, i]) for i in range(3))
    y = (K["KY_R"] * r + K["KY_G"] * g) + K["KY_B"] * b
    cb = ((K["KCB_R"] * r - K["KCB_G"] * g) + K["KCB_B"] * b) + K["C128"]
    cr = ((K["KCR_R"] * r - K["KCR_G"] * g) - K["KCR_B"] * b) + K["C128"]
    yq = np.clip(lround_ratio(round_u8(y), 242, 255), 0, 242)
    cbq = np.clip(lround_ratio(round_u8(cb) - 128, 40, 128), -40, 40) + 40
    crq = np.clip(lround_ratio(round_u8(cr) - 128, 40, 128), -40, 40) + 40
    return yq, cbq, crq


def model_ingest(rgb, out, pixel=quant_pixel):
    """K4's steps on (..., 3) uint8 RGB, written into ``out``."""
    px = rgb.reshape(-1, 3).numpy()
    px = np.concatenate([px, np.zeros((len(px) % 2, 3), np.uint8)])
    ya, cba, cra = pixel(px[0::2])
    yb, cbb, crb = pixel(px[1::2])
    w = np.stack([ya % 27, ya // 27 + 9 * (cba % 3), cba // 3, cra % 27,
                  cra // 27 + 3 * (yb % 9), yb // 9, cbb % 27,
                  cbb // 27 + 3 * (crb % 9), crb // 9], -1)
    return out.copy_(torch.as_tensor(w.astype(np.int8)))


def dequant(n, p, q, fix_in, fix_out):
    v = lround_ratio(n, p, q)
    for a, b in zip(fix_in, fix_out):
        v = np.where(n == a, b, v)
    return v


def rgb_pixel(yq, cbq, crq):
    """(..., 3) uint8 RGB of quantised fields, fix-ups from the uploaded
    table."""
    t, f = B.host_consts(), B.MAX_FIX
    yfix = (t[2:2 + t[0]], t[2 + f:2 + f + t[0]])
    cfix = (t[2 + 2 * f:2 + 2 * f + t[1]], t[2 + 3 * f:2 + 3 * f + t[1]])
    yi = np.clip(dequant(yq, 255, 242, *yfix), 0, 255)
    cbi = np.clip(128 + dequant(cbq - 40, 128, 40, *cfix), 0, 255)
    cri = np.clip(128 + dequant(crq - 40, 128, 40, *cfix), 0, 255)
    y, cb, cr = u2f(yi), u2f(cbi) - K["C128"], u2f(cri) - K["C128"]
    return np.stack([round_u8(y + K["KR_CR"] * cr),
                     round_u8((y - K["KG_CB"] * cb) - K["KG_CR"] * cr),
                     round_u8(y + K["KB_CB"] * cb)], -1).astype(np.uint8)


def model_egress(planes):
    """K5's steps on (..., 9, m) int8 word9 planes."""
    v = [planes[..., s, :].numpy().astype(np.int64) for s in range(9)]
    fdiv3 = lambda x: (x + 135) // 3 - 45
    fdiv9 = lambda x: (x + 135) // 9 - 15
    fmod3 = lambda x: (x + 135) % 3
    fmod9 = lambda x: (x + 135) % 9
    a = rgb_pixel(v[0] + 27 * fmod9(v[1]), fdiv9(v[1]) + 3 * v[2],
                  v[3] + 27 * fmod3(v[4]))
    b = rgb_pixel(fdiv3(v[4]) + 9 * v[5], v[6] + 27 * fmod3(v[7]),
                  fdiv3(v[7]) + 9 * fmod9(v[8]))
    return torch.as_tensor(np.stack([a, b], -2))


def staged(h, n):
    """(vector indices, edge byte indices) of a range of n bytes staged at
    h: load_ranges' and store_staged's split."""
    v0, v1 = (h + 15) >> 4, (h + n) >> 4
    e0 = min(16 * v0, h + n)
    e1 = max(16 * v1, e0)
    head = [h + l for l in range(16) if h + l < e0]
    tail = [e1 + l for l in range(16) if e1 + l < h + n]
    return list(range(v0, v1)), head + tail


# --- the wrapper ----------------------------------------------------------


class Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a: self.calls.append(name) or 0


def test_wrapper_routes_cpu_to_twin_and_checks_its_input(monkeypatch):
    lib = Recorder()
    monkeypatch.setattr(B, "_lib", lambda: lib)
    before = build.launches.copy()
    rgb = torch.randint(0, 256, (3, 5, 3), dtype=torch.uint8)
    out = torch.empty((8, 9), dtype=torch.int8)
    assert torch.equal(W.ingest9(rgb, out), W.ingest9_ref(
        rgb, torch.empty_like(out)))
    planes = out.T
    assert torch.equal(W.egress9(planes), W.egress9_ref(planes))
    with pytest.raises(TypeError):
        B.ingest(rgb.to(torch.int16), out)
    with pytest.raises(TypeError):
        B.ingest(rgb, out.to(torch.uint8))
    with pytest.raises(ValueError, match="\\(..., 3\\)"):
        B.ingest(rgb[..., :2], out)
    with pytest.raises(ValueError, match="contiguous \\(8, 9\\)"):
        B.ingest(rgb, out[:7])
    with pytest.raises(ValueError, match="contiguous"):
        B.ingest(rgb, torch.empty((9, 8), dtype=torch.int8).T)
    with pytest.raises(ValueError, match="CUDA"):
        B.ingest(rgb, out)
    with pytest.raises(TypeError):
        B.egress(planes.to(torch.int32))
    with pytest.raises(ValueError, match="\\(..., 9, m\\)"):
        B.egress(planes[:8])
    with pytest.raises(ValueError, match="CUDA"):
        B.egress(planes)
    assert lib.calls == [] and build.launches == before


def test_fixup_table_is_quants():
    t, f = B.host_consts(), B.MAX_FIX
    assert t.dtype == np.int32 and t.shape == (2 + 4 * f,)
    assert (t[0], t[1]) == (len(Q.Y_FIX_IN), len(Q.C_FIX_IN))
    for i, a in enumerate((Q.Y_FIX_IN, Q.Y_FIX_OUT, Q.C_FIX_IN, Q.C_FIX_OUT)):
        part = t[2 + i * f:2 + (i + 1) * f]
        assert np.array_equal(part[:len(a)], a) and not part[len(a):].any()
    assert list(Q.Y_FIX_IN) == [121]      # 121 * (255.0 / 242.0) rounds down


def test_source_literals_are_quants_float32():
    assert len(LITERALS) == 15
    for name, (value, dec) in LITERALS.items():
        assert value == Q.f32(float(dec)).item(), name


# --- the model against the twins --------------------------------------------


@pytest.fixture(scope="module")
def ties():
    return rgb_ties.boundary_pixels()


def test_model_ingest_is_the_twin(ties):
    g = torch.Generator().manual_seed(21)
    sample = torch.randint(0, 256, (1 << 16, 3), generator=g,
                           dtype=torch.uint8)
    for px in (ties, sample, sample[:4097]):          # 4,097: odd, padded
        n = -(-len(px) // 2)
        got = model_ingest(px, torch.full((n, 9), 99, dtype=torch.int8))
        assert torch.equal(got, W.ingest9_ref(
            px, torch.empty((n, 9), dtype=torch.int8)))


def test_model_egress_is_the_twin():
    y, cb, cr = torch.meshgrid(torch.arange(243), torch.arange(81) - 40,
                               torch.arange(81) - 40, indexing="ij")
    codes = W.quant_to_words9(torch.stack([y, cb, cr], -1).reshape(-1, 3)).T
    g = torch.Generator().manual_seed(22)
    words = torch.randint(-128, 128, (4, 9, 1 << 14), generator=g,
                          dtype=torch.int8)
    for planes in (codes, words, words[:, :, 3:1000]):
        assert torch.equal(model_egress(planes), W.egress9_ref(planes))


def test_model_catches_one_contracted_row(ties):
    """The ties tell a row with one rounding fewer: the model with the
    luma row's last product and sum rounded once (float64, one cast)."""
    n = -(-len(ties) // 2)
    want = W.ingest9_ref(ties, torch.empty((n, 9), dtype=torch.int8))

    def fused(rgb):
        r, g, b = (u2f(rgb[:, i]) for i in range(3))
        head = K["KY_R"] * r + K["KY_G"] * g
        y = (head.astype(np.float64) + K["KY_B"].astype(np.float64)
             * b.astype(np.float64)).astype(np.float32)
        yq = np.clip(lround_ratio(round_u8(y), 242, 255), 0, 242)
        return (yq,) + quant_pixel(rgb)[1:]
    got = model_ingest(ties, torch.empty((n, 9), dtype=torch.int8), fused)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 5, 15, 16, 17, 31, 1023, 1024, 6144])
def test_staging_covers_each_byte_once(n):
    for h in range(16):
        vec, edge = staged(h, n)
        got = sorted([16 * v + i for v in vec for i in range(16)] + edge)
        assert got == list(range(h, h + n))
        assert len(edge) <= 30 and all(0 <= e < h + n for e in edge)


def test_smoke_hold_on_the_cpu():
    """phase 6's ``hold_bridges`` with the model in the kernels' place."""
    names = cs.hold_bridges(torch, torch.device("cpu"), model_ingest,
                            model_egress, full=False)
    assert len(names) == 12


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this there)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_kernels_equal_twins_on_the_card(card):
    before = build.launches.copy()
    names = cs.hold_bridges(torch, card, W.ingest9, W.egress9, full=True)
    for kind in ("ingest", "egress"):
        n = sum(name.startswith(kind) for name in names)
        assert (build.launches - before)[f"bridge_{kind}"] == n


@pytest.mark.cuda
def test_rgb_entry_launches_each_once(card):
    cfg = c.EncoderConfig(profile=c.ProfileID.P2_RS26_22,
                          uep=c.uep_luma_priority(), superframe_words=256)
    rgb = torch.randint(0, 256, (23, 45, 3), dtype=torch.uint8)
    before = build.launches.copy()
    codec = codec_for(cfg, card)
    out, ok = codec.decode_rgb(codec.encode_rgb(rgb.to(card)),
                               size=(23, 45))
    ran = build.launches - before
    assert (ran["bridge_ingest"], ran["bridge_egress"]) == (1, 1)
    cpu = codec_for(cfg, "cpu")
    want, _ = cpu.decode_rgb(cpu.encode_rgb(rgb), size=(23, 45))
    assert bool(ok) and torch.equal(out.cpu(), want)
