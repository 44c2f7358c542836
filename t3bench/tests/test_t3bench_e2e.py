"""The RGB round trip's cell on the CPU at a tiny size: the timed path is
judged correct, and ``correct`` comes out false for each fault it can
have (the schema without its colour conversion among them) and for its
control, the references one precision lower; the bridges' byte count; the
pixel reference against the C++ oracle's records and alone in its
imports."""
import ast
import os
import time

import numpy as np
import pytest
import torch

from t3bench.lib import cell as cells
from t3bench.lib import rgb, runner
from t3bench.reference import pixels
from t3bench.tests import tiny

CPU = torch.device("cpu")
CELL = "p2_8k_rgb.rt_e2e"
GOLDEN = os.path.join(tiny.ROOT, "tests", "golden", "golden_quant.bin")


def run(bd, name=CELL, control=False):
    return runner.run_cell(bd, tiny.benchmark(), name, 2 ** 33 + 17, 0.3,
                           False, CPU, time.perf_counter(), control=control)


def test_new_cell_is_correct(tmp_path):
    out = run(tiny.copy(tmp_path))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    wrong = {n: c["value"] for n, c in out["checks"].items()
             if n.endswith("_wrong")}
    assert wrong and set(wrong.values()) == {0}


def fault_rgb_value(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import SuperframeCodec
    dec = SuperframeCodec.decode_rgb

    def decode_rgb(self, *a, **k):
        out, ok = dec(self, *a, **k)
        out = out.clone()
        out.view(-1)[5] ^= 1
        return out, ok
    monkeypatch.setattr(SuperframeCodec, "decode_rgb", decode_rgb)


def fault_wire_symbol(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import SuperframeCodec
    from ternary_image_codec_tpu_torch.ops.pipeline import HEADER_WORDS
    enc = SuperframeCodec.encode_rgb

    def encode_rgb(self, *a, **k):
        w = enc(self, *a, **k).clone()
        w[0, 2, HEADER_WORDS + 3] = (w[0, 2, HEADER_WORDS + 3] + 1) % 27
        return w
    monkeypatch.setattr(SuperframeCodec, "encode_rgb", encode_rgb)


def fault_ok_flipped(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import SuperframeCodec
    dec = SuperframeCodec.decode_rgb

    def decode_rgb(self, *a, **k):
        out, ok = dec(self, *a, **k)
        return out, ~ok
    monkeypatch.setattr(SuperframeCodec, "decode_rgb", decode_rgb)


def fault_no_colour(monkeypatch):
    """The schema without the colour conversion in the program's place:
    R, G, B quantised as if they were Y, Cb, Cr, and given back so."""
    from ternary_image_codec_tpu_torch.ops import quant
    monkeypatch.setattr(quant, "ycbcr_rows", lambda r, g, b: (r, g, b))
    monkeypatch.setattr(quant, "rgb_rows",
                        lambda y, cb, cr: (y, cb + 128, cr + 128))


FAULTS = [fault_rgb_value, fault_wire_symbol, fault_ok_flipped,
          fault_no_colour]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    bd = tiny.copy(tmp_path)
    fault(monkeypatch)
    out = run(bd)
    assert not out["correct"], out["checks"]
    values = {n: c["value"] for n, c in out["checks"].items()}
    if fault is fault_rgb_value:
        assert values["rgb_values_wrong"] > 0
    if fault is fault_wire_symbol:
        # the check decode flags the superframe and the paged repair mends
        # it: the wire alone shows the fault
        assert values["wire_symbols_wrong"] > 0
        assert values["rgb_values_wrong"] == values["requests_not_ok"] == 0
    if fault is fault_ok_flipped:
        assert values["requests_not_ok"] == out["attempted"]
    if fault is fault_no_colour:
        assert values["wire_symbols_wrong"] > 0
        assert values["rgb_values_wrong"] > 0
        assert values["requests_not_ok"] == 0


def test_control_is_not_correct(tmp_path):
    """The control: the references in float16 rows and a float32
    quantiser, one precision below the configuration's."""
    out = run(tiny.copy(tmp_path), control=True)
    assert not out["correct"], out["checks"]
    values = {n: c["value"] for n, c in out["checks"].items()}
    assert values["wire_symbols_wrong"] > 0 and values["rgb_values_wrong"] > 0


@pytest.mark.parametrize("prec", [{"rows": torch.float16},
                                  {"quant": torch.float32}],
                         ids=["float16_rows", "float32_quantiser"])
def test_each_lower_precision_moves_the_reference(prec):
    """Each half of the control alone: float16 rows move the wire (and so
    the RGB); a float32 quantiser leaves the wire and misses the
    inverse's double rounding, so it moves the RGB alone."""
    g = torch.Generator().manual_seed(11)
    f = torch.randint(0, 256, (64, 128, 3), generator=g, dtype=torch.uint8)
    w, w_low = pixels.ingest(f), pixels.ingest(f, **prec)
    back = pixels.egress(w, 64, 128)
    assert not torch.equal(pixels.egress(w_low, 64, 128, **prec), back)
    assert torch.equal(w_low, w) == ("quant" in prec)


def test_bridge_bytes_at_8k():
    assert rgb.bridge_bytes(4320, 7680) == 497_664_000
    assert rgb.bridge_bytes(4320, 7680) == 2 * (99_532_800 + 149_299_200)
    assert rgb.bridge_bytes(1, 3) == 2 * (9 + 18)       # odd: 2 words


def test_bridge_readers_find_nothing_without_a_trace():
    ctx = runner.Context(
        workload={}, config={"frame": {"width": 8, "height": 2}},
        setup_s=0.0, window_s=1.0, frames=1, latencies_s=[0.1],
        peak_bytes=None, spans={}, summary=None, kernel_bytes={},
        rooflines={}, peaks=cells.load_peaks(tiny.BENCH))
    for m in ("ingest_ms.e2e", "egress_ms.e2e", "bridge_roofline.e2e"):
        assert cells.load_reader(tiny.BENCH, m).read(ctx) is None


def test_frames_are_made_again_from_the_seed():
    cfg = {"frame": {"width": 6, "height": 4}}
    a = rgb.make_frame(cfg, 2 ** 40 + 3, 5, CPU)
    assert a.shape == (4, 6, 3) and a.dtype == torch.uint8
    assert torch.equal(a, rgb.make_frame(cfg, 2 ** 40 + 3, 5, CPU))
    assert not torch.equal(a, rgb.make_frame(cfg, 2 ** 40 + 3, 6, CPU))


def test_pixel_reference_is_the_cpp_oracle():
    """Every stage against the C++ oracle's 100,000 records
    (tests/golden/golden_quant.bin: r, g, b, Y, Cb, Cr, Yq, Cbq + 64,
    Crq + 64, dY, dCb, dCr, R2, G2, B2)."""
    rec = torch.as_tensor(np.fromfile(GOLDEN, dtype=np.uint8)
                          .reshape(-1, 15).astype(np.int64))
    q = rec[:, 6:9] - torch.tensor([0, 64, 64])
    assert torch.equal(pixels.rgb_to_ycbcr(rec[:, 0:3]), rec[:, 3:6])
    assert torch.equal(pixels.quantize(rec[:, 3:6]), q)
    assert torch.equal(pixels.dequantize(q), rec[:, 9:12])
    assert torch.equal(pixels.ycbcr_to_rgb(rec[:, 9:12]), rec[:, 12:15])


def test_pixel_reference_round_trip_and_pack():
    g = torch.Generator().manual_seed(4)
    f = torch.randint(0, 256, (5, 7, 3), generator=g, dtype=torch.uint8)
    w = pixels.ingest(f)
    assert w.shape == (18, 9) and w.dtype == torch.int8
    assert int(w.max()) <= 26 and int(w[:, 8].max()) < 9     # trit 26 zero
    # the odd last pixel is paired with the default pixel (0, 0, 0):
    # Yq 0, Cbq + 40 = Crq + 40 = 40 in trits 13..25
    t = (w[-1].long()[:, None] // torch.tensor([1, 3, 9]) % 3).reshape(27)
    tail = (t[13:26] * 3 ** torch.tensor([0, 1, 2, 3, 4, 0, 1, 2, 3,
                                          0, 1, 2, 3])).tolist()
    assert sum(tail[:5]) == 0 and sum(tail[5:9]) == sum(tail[9:]) == 40
    back = pixels.egress(w, 5, 7)
    want = pixels.ycbcr_to_rgb(pixels.dequantize(pixels.quantize(
        pixels.rgb_to_ycbcr(f.reshape(-1, 3))))).reshape(5, 7, 3)
    assert torch.equal(back, want.to(torch.uint8))
    sf = pixels.superframes(w, 8)
    assert sf.shape == (3, 8, 9) and int(sf[2, 2:].abs().sum()) == 0
    assert torch.equal(pixels.words(sf.transpose(1, 2), 8)[:18], w)


def test_pixel_reference_imports_neither_package():
    path = os.path.join(tiny.BENCH, "reference", "pixels.py")
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "torch"}, tops


def test_codec_rooflines_read_in_the_rgb_cell():
    """The cell reports K1's and K3's shares of their bounds, from the same
    roofline files as the RAW round trip."""
    from t3bench.tests.test_t3bench_enc_roofline import _with_k3
    from t3bench.tests.test_t3bench_metrics import ctx, events, read
    from t3bench.lib import trace
    plan = {m.name for m in cells.metric_plan(tiny.benchmark(), CELL)[1]}
    assert {"k1_roofline", "enc_roofline"} <= plan
    s = trace.summarize(_with_k3(events()))
    c = ctx(s, {"superframe_encode": 3.35e12 * 50e-6})
    assert read("enc_roofline", c) == pytest.approx(50.0)
    assert read("enc_roofline", ctx(trace.summarize(events()),
                                    {"superframe_encode": 1e6})) is None
