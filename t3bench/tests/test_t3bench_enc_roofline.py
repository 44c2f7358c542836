"""enc_roofline.rt reads K3's device time and the encode's bytes, and
finds nothing where no K3 ran (a program without the kernel)."""
import pytest

from t3bench.lib import cell as cells
from t3bench.lib import trace
from t3bench.tests.test_t3bench_metrics import ctx, events, read
from t3bench.tests.tiny import BENCH


def _with_k3(ev):
    return ev + [{"ph": "X", "cat": "kernel",
                  "name": "(anonymous namespace)::superframe_encode_kernel"
                          "((anonymous namespace)::Args)",
                  "ts": 800, "dur": 100}]


def test_pattern_names_k3_alone():
    rf = cells.load_rooflines(BENCH)
    pat = rf["superframe_encode"]["name_pattern"]
    assert pat not in rf["check_decode"]["name_pattern"]
    assert pat not in rf["rs_correct"]["name_pattern"]
    s = trace.summarize(_with_k3(events()))
    assert s.kernel_seconds(pat) == pytest.approx(100e-6)
    assert s.kernel_seconds(rf["check_decode"]["name_pattern"]) \
        == pytest.approx(200e-6)


def test_enc_roofline_reads_k3():
    s = trace.summarize(_with_k3(events()))
    c = ctx(s, {"superframe_encode": 3.35e12 * 50e-6})
    assert read("enc_roofline.rt", c) == pytest.approx(50.0)


def test_enc_roofline_finds_nothing_without_k3():
    s = trace.summarize(events())
    assert read("enc_roofline.rt", ctx(s, {"superframe_encode": 1e6})) is None
    assert read("enc_roofline.rt", ctx(None)) is None
