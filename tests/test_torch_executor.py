"""The port's StreamExecutor and tracing against the JAX package's
semantics (tests/test_executor.py, tests/test_tracing.py): frame order,
resume start, overlap of load and write, backpressure, the first error
re-raised after cancel; spans, JSON-line logging and the profiler
trace.  On the CPU there are no streams; the card's stream hand-over is
held by the ``cuda`` test and by ``chip_smoke.py``'s serve phase."""
import json
import os
import threading
import time

import pytest
import torch

from ternary_image_codec_tpu.runtime.executor import \
    StreamExecutor as JStreamExecutor
from ternary_image_codec_tpu_torch.runtime import tracing
from ternary_image_codec_tpu_torch.runtime.executor import StreamExecutor


def cpu_executor(load, device_fn, write, prefetch=2):
    return StreamExecutor(load, device_fn, write, prefetch, device="cpu")


def test_order_and_stats_match_the_jax_package():
    outs = []
    for make in (cpu_executor, JStreamExecutor):
        out = []
        stats = make(lambda i: i * 10, lambda x: x + 1,
                     lambda i, y: out.append((i, y))).run(range(7))
        assert stats.frames == 7 and not stats.errors
        outs.append(out)
    assert outs[0] == outs[1] == [(i, i * 10 + 1) for i in range(7)]


def test_tensors_in_order():
    out = []
    cpu_executor(lambda i: torch.full((3,), i),
                 lambda x: x * 2,
                 lambda i, y: out.append((i, y.tolist()))).run(range(5))
    assert out == [(i, [2 * i] * 3) for i in range(5)]


def test_resume_start_skips_loads():
    loaded, out = [], []
    cpu_executor(lambda i: loaded.append(i) or i, lambda x: x,
                 lambda i, y: out.append(i)).run(range(6), start=4)
    assert loaded == [4, 5] and out == [4, 5]


def test_stages_overlap():
    """A load and a write are in flight at once, asserted on wall-clock
    intervals."""
    d, n = 0.03, 8
    loads, writes = [], []

    def load(i):
        t0 = time.perf_counter()
        time.sleep(d)
        loads.append((t0, time.perf_counter()))
        return i

    def write(i, y):
        t0 = time.perf_counter()
        time.sleep(d)
        writes.append((t0, time.perf_counter()))

    cpu_executor(load, lambda x: x, write).run(range(n))
    assert any(ls < we and ws < le for ls, le in loads for ws, we in writes)


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_backpressure_bounds_inflight(prefetch):
    """No more than prefetch queued outputs, the caller's and the writer's
    own exist before the writer drains them."""
    inflight, live = [], [0]
    lock = threading.Lock()

    def device(x):
        with lock:
            live[0] += 1
            inflight.append(live[0])
        return x

    def write(i, y):
        time.sleep(0.005)
        with lock:
            live[0] -= 1

    cpu_executor(lambda i: i, device, write, prefetch).run(range(12))
    assert max(inflight) <= prefetch + 2, inflight


@pytest.mark.parametrize("stage", ["load", "device", "write"])
def test_error_propagates_and_cancels(stage):
    boom = RuntimeError("boom")

    def load(i):
        if stage == "load" and i == 3:
            raise boom
        return i

    def device(x):
        if stage == "device" and x == 3:
            raise boom
        return x

    def write(i, y):
        if stage == "write" and i == 3:
            raise boom

    ex = cpu_executor(load, device, write)
    with pytest.raises(RuntimeError, match="boom") as info:
        ex.run(range(50))
    assert info.value is boom
    if stage != "device":            # the caller's own error is raised as is
        assert ex.stats.errors == [boom]
    assert ex.stats.frames < 50
    assert not any(t.name in ("t3-loader", "t3-writer")
                   for t in threading.enumerate())


def test_prefetch_and_device_checked():
    with pytest.raises(ValueError, match="prefetch"):
        cpu_executor(lambda i: i, lambda x: x, lambda i, y: None, prefetch=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            StreamExecutor(lambda i: i, lambda x: x, lambda i, y: None)


@pytest.mark.cuda
def test_streams_hand_over_on_the_card(cuda_device):
    """Loader and writer on their own streams: each frame's device work
    sees its H2D copy and the writer sees the device work, in order."""
    n = 6
    host = [torch.full((1 << 20,), i, dtype=torch.int32).pin_memory()
            for i in range(n)]
    out = {}

    def load(i):
        assert torch.cuda.current_stream() != torch.cuda.default_stream()
        return host[i].to(cuda_device, non_blocking=True)

    def write(i, y):
        out[i] = y.cpu()

    def work(x):
        return (x * 3).cumsum(0)

    StreamExecutor(load, work, write, device=cuda_device).run(range(n))
    assert sorted(out) == list(range(n))
    for i in range(n):
        assert torch.equal(out[i], work(host[i])), i


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", torch.cuda.current_device())


class TestTracing:
    def test_stage_timer_accumulates(self):
        """``span`` (which replaced ``stage_timer``) adds up calls and host
        ms by path while a profiler records, and nothing otherwise."""
        tracing.report(reset=True)
        with tracing.span("t3.off"):
            pass
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):
                with tracing.span("t3.encode"):
                    pass
            with tracing.span("t3.decode"):
                with tracing.span("t3.check"):
                    pass
        rep = tracing.report(reset=True)["spans"]
        assert set(rep) == {"t3.encode", "t3.decode", "t3.decode/t3.check"}
        assert rep["t3.encode"]["calls"] == 3
        assert rep["t3.decode"]["calls"] == 1
        assert rep["t3.decode"]["host_ms"] >= rep["t3.decode/t3.check"][
            "host_ms"] >= 0.0
        assert set(rep["t3.decode"]) == {"calls", "host_ms"}
        assert tracing.report() == {"spans": {}, "counts": {}}

    def test_exception_still_recorded(self):
        tracing.report(reset=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with pytest.raises(ValueError):
                with tracing.span("t3.boom"):
                    raise ValueError
        assert tracing.report(reset=True)["spans"]["t3.boom"]["calls"] == 1

    def test_executor_dispatch_is_timed(self):
        """The dispatch is timed by ``ExecutorStats.dispatch_s`` alone; a
        span inside ``device_fn`` records on the caller's thread."""
        tracing.report(reset=True)

        def device_fn(x):
            with tracing.span("t3.device_fn"):
                return x
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            stats = cpu_executor(lambda i: i, device_fn,
                                 lambda i, y: None).run(range(4))
        assert stats.frames == 4 and stats.dispatch_s > 0.0
        rep = tracing.report(reset=True)["spans"]
        assert set(rep) == {"t3.device_fn"}
        assert rep["t3.device_fn"]["calls"] == 4

    def test_log_event_off_by_default(self, capsys, monkeypatch):
        monkeypatch.delenv("T3_LOG", raising=False)
        tracing.log_event("x", a=1)
        assert capsys.readouterr().err == ""

    def test_log_event_json_line(self, capsys, monkeypatch):
        monkeypatch.setenv("T3_LOG", "1")
        tracing.log_event("encode_done", frames=2)
        rec = json.loads(capsys.readouterr().err)
        assert rec["event"] == "encode_done" and rec["frames"] == 2
        assert "ts" in rec

    def test_device_trace_noop_without_dir(self, tmp_path):
        with tracing.device_trace(None):
            x = torch.ones(8).sum()
        assert float(x) == 8.0
        with tracing.device_trace(""):
            pass
        assert os.listdir(tmp_path) == []

    def test_device_trace_writes_a_chrome_trace(self, tmp_path):
        ran = 0
        out = tmp_path / "tr"
        with tracing.device_trace(str(out)):
            ran += 1
            torch.ones((8, 8)) @ torch.ones((8, 8))
        assert ran == 1
        with open(out / "trace.json") as f:
            assert "traceEvents" in json.load(f)
