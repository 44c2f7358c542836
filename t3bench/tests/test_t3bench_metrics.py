"""The readers compute the right numbers from a small synthetic profiler
table."""
import pytest

from t3bench.lib import cell as cells
from t3bench.lib import trace
from t3bench.lib.runner import Context
from t3bench.tests.tiny import BENCH


def events():
    # window 0..1000 us; kernels 100-300 and 250-400 overlap, 600-700 apart
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "kernel", "name": "check_decode_kernel(Args)",
           "ts": 100, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "void rs_correct_kernel<4>",
           "ts": 250, "dur": 150},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 600, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "outside", "ts": 1500,
           "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "t3bench.decode",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 410,
           "dur": 180}]
    return ev


def ctx(summary, kernel_bytes=None, spans=None):
    return Context(workload={}, config={}, setup_s=12.5, window_s=2.0,
                   frames=50, latencies_s=[i / 1000 for i in range(1, 101)],
                   peak_bytes=3 * 2 ** 30, spans=spans or {},
                   summary=summary, kernel_bytes=kernel_bytes or {},
                   rooflines=cells.load_rooflines(BENCH),
                   peaks=cells.load_peaks(BENCH))


def read(name, c):
    return cells.load_reader(BENCH, name).read(c)


def test_summary_of_synthetic_trace():
    s = trace.summarize(events())
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(400e-6)        # 100-400 and 600-700
    assert s.kernel_seconds("check_decode") == pytest.approx(200e-6)
    assert s.kernel_seconds("rs_correct") == pytest.approx(150e-6)
    assert [g[1] for g in s.gaps] == pytest.approx([300e-6, 200e-6, 100e-6])
    assert s.gaps[1][0] == "t3bench.decode > aten::nonzero"


def test_no_window_no_summary():
    assert trace.summarize(events()[1:]) is None


def test_readers():
    s = trace.summarize(events())
    c = ctx(s, {"check_decode": 335e6 * 200e-6,
                "rs_correct": 3.35e12 * 15e-6},
            {"encode": [30.0, 32.0], "decode": [1.0, 3.0]})
    for rt in ("", ".rt"):
        assert read("device_idle_share" + rt, c) == pytest.approx(60.0)
        assert read("k1_roofline" + rt, c) == pytest.approx(0.01)
        assert read("fps" + rt, c) == pytest.approx(25.0)
        assert read("latency_ms_p95" + rt, c) == pytest.approx(95.05)
    assert read("k2_roofline", c) == pytest.approx(10.0)
    assert read("encode_ms.rt", c) == pytest.approx(31.0)
    assert read("decode_ms.rt", c) == pytest.approx(2.0)
    assert read("peak_gib", c) == pytest.approx(3.0)
    assert read("setup_s", c) == pytest.approx(12.5)


def test_readers_find_nothing():
    c = ctx(None)
    for name in ("device_idle_share", "k1_roofline", "k2_roofline",
                 "device_idle_share.rt", "k1_roofline.rt", "encode_ms.rt",
                 "decode_ms.rt"):
        assert read(name, c) is None
    s = trace.summarize(events())
    assert read("k1_roofline", ctx(s)) is None       # no bytes counted
