"""The readers of the program's own spans and counters
(``lib/program.py`` and six ``metrics/`` files) compute the right numbers
from a synthetic report of the port's ``tracing.report()`` and from a
synthetic trace, and find nothing to read in an empty report, in a
program without the report, or in a run whose profiled stretch kept no
device busy."""
import pytest

from t3bench.lib import program, trace
from t3bench.tests.test_t3bench_metrics import ctx, events, read
from ternary_image_codec_tpu_torch.runtime import tracing

READERS = ("grid_check_ms", "repair_ms", "k2_launches", "k2_useful_share",
           "encode_host_ms.rt", "sync_wait_ms.rt")


def span(calls, host_ms):
    return {"calls": calls, "host_ms": host_ms}


REPORT = {
    "spans": {
        # 11 calls of 8 frames
        "t3.decode_frames": span(11, 200.0),
        "t3.decode_frames/t3.check.grid": span(11, 150.0),
        "t3.decode_frames/t3.repair": span(11, 30.0),
        "t3.decode_frames/t3.repair/t3.repair.paged": span(11, 20.0),
        # a round trip: 10 calls of one frame each
        "t3.encode": span(10, 290.0),
        "t3.encode/t3.encode.batch": span(320, 280.0),
        "t3.decode": span(10, 12.0),
        "t3.decode/t3.check.k1": span(10, 1.0),
        "t3.decode/t3.sync.auto": span(10, 9.0),
        "t3.decode/t3.sync.other": span(10, 1.0),
    },
    "counts": {"t3.k2.launches": 33, "t3.k2.codewords": 4000,
               "t3.k2.dirty": 160},
}


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def traced():
    """Two calls of ``decode_frames`` in the window 0..1000 us, one before
    it; kernels launched under the check, the repair and its paged chain,
    one launched outside every span and one on another thread."""
    ev = [X("user_annotation", trace.WINDOW, 0, 1000),
          X("user_annotation", "t3bench.decode", 0, 1000),
          # before the window: not counted
          X("user_annotation", "t3.decode_frames", -500, 400),
          X("cuda_runtime", "cudaLaunchKernel", -450, 5, corr=90),
          X("kernel", "early", -440, 300, tid=7, corr=90)]
    for c0, t0 in ((0, 10), (20, 500)):
        ev += [X("user_annotation", "t3.decode_frames", t0, 480),
               X("user_annotation", "t3.check.grid", t0 + 10, 100),
               X("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5,
                 corr=c0 + 1),
               X("cuda_driver", "cuLaunchKernel", t0 + 40, 5, corr=c0 + 2),
               X("user_annotation", "t3.repair", t0 + 200, 200),
               X("user_annotation", "t3.repair.paged", t0 + 210, 100),
               X("cuda_runtime", "cudaLaunchKernel", t0 + 250, 5,
                 corr=c0 + 3),
               X("cuda_runtime", "cudaMemcpyAsync", t0 + 350, 5,
                 corr=c0 + 4),
               X("cuda_runtime", "cudaLaunchKernel", t0 + 420, 5,
                 corr=c0 + 5),
               X("cuda_runtime", "cudaLaunchKernel", t0 + 260, 5, tid=2,
                 corr=c0 + 6),
               # grid check: 100 us and 60 us overlapping by 20
               X("kernel", "grid_a", t0 + 30, 100, tid=7, corr=c0 + 1),
               X("kernel", "grid_b", t0 + 110, 60, tid=7, corr=c0 + 2),
               # repair: 40 us under the paged chain, a 10 us copy
               X("kernel", "paged", t0 + 260, 40, tid=7, corr=c0 + 3),
               X("gpu_memcpy", "Memcpy DtoD", t0 + 360, 10, tid=7,
                 corr=c0 + 4),
               X("kernel", "outside", t0 + 430, 30, tid=7, corr=c0 + 5),
               X("kernel", "thread2", t0 + 300, 50, tid=7, corr=c0 + 6)]
    return ev


@pytest.fixture
def reported(monkeypatch):
    """The port's tracing.report() replaced by a copy of ``rep``."""
    def use(rep):
        taken = []

        def report(reset=False):
            taken.append(reset)
            return rep
        monkeypatch.setattr(tracing, "report", report)
        return taken
    return use


def cell_ctx(frames_per_request=None, ev=None):
    c = ctx(trace.summarize(events() if ev is None else ev))
    if frames_per_request:
        c.workload = {"params": {"frames_per_request": frames_per_request}}
    return c


def test_device_time_of_a_synthetic_trace():
    table = program.span_device_us(traced())
    assert table == {
        "t3.decode_frames": [440.0, 2],
        "t3.decode_frames/t3.check.grid": [280.0, 2],
        "t3.decode_frames/t3.repair": [100.0, 2],
        "t3.decode_frames/t3.repair/t3.repair.paged": [80.0, 2]}
    assert program.span_device_us(traced()[1:]) == {}     # no window


def test_summary_as_before():
    """The wrapped ``trace.summarize`` returns what it returned alone."""
    for ev in (events(), traced()):
        assert trace.summarize(ev) == trace.summarize.__wrapped__(ev)


def test_readers_of_a_synthetic_report(reported):
    taken = reported(REPORT)
    rx = cell_ctx(2, traced())
    assert read("grid_check_ms", rx) == pytest.approx(140e-3 / 2)
    assert read("repair_ms", rx) == pytest.approx(50e-3 / 2)
    assert program.device_ms(rx, "t3.decode_frames", "t3.repair.paged") \
        == pytest.approx(40e-3 / 2)
    rx = cell_ctx(8)
    assert read("k2_launches", rx) == pytest.approx(3.0)
    assert read("k2_useful_share", rx) == pytest.approx(4.0)
    rt = cell_ctx()
    assert read("encode_host_ms.rt", rt) == pytest.approx(29.0)
    assert read("sync_wait_ms.rt", rt) == pytest.approx(1.0)
    # one report a run, taken and reset on the first read
    assert taken == [True, True]


def test_a_span_not_recorded_reads_nothing(reported):
    reported({"spans": {"t3.decode_frames": span(4, 10.0)},
              "counts": {"t3.k2.codewords": 0}})
    ev = [e for e in traced() if e["name"] not in ("t3.check.grid",
                                                   "t3.repair")]
    c = cell_ctx(1, ev)
    for name in READERS:
        assert read(name, c) is None, name


@pytest.mark.parametrize("rep", [
    {"spans": {}, "counts": {}},
    None,                                   # a program without the report
], ids=["empty", "absent"])
def test_readers_find_nothing(reported, monkeypatch, rep):
    if rep is None:
        monkeypatch.delattr(tracing, "report")
    else:
        reported(rep)
    for name in READERS:
        assert read(name, cell_ctx(8)) is None, name


def test_no_device_work_reads_nothing(reported):
    taken = reported(REPORT)
    for name in READERS:
        assert read(name, ctx(None)) is None, name
    assert taken == []
    # a stretch with no device interval: a run on the CPU
    for ev in (events(), traced()):
        idle = ctx(trace.summarize([e for e in ev
                                    if e["cat"] not in trace.DEVICE_CATS]))
        for name in READERS:
            assert read(name, idle) is None, name
    # a context of another run: its trace is not this one's
    trace.summarize(traced())
    assert read("repair_ms", cell_ctx(1, events())) is None


def test_report_of_the_port_read_once_a_run():
    """Against the port's own tracing: what a profiled call records is
    read by the first reader of a run and reset for the next run."""
    import torch
    tracing.report(reset=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("t3.encode"):
            pass
    first = cell_ctx()
    assert program.report(first)["spans"]["t3.encode"]["calls"] == 1
    assert read("encode_host_ms.rt", first) >= 0.0
    assert tracing.report() == {"spans": {}, "counts": {}}
    assert program.report(cell_ctx()) is None
