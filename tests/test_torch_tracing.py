"""The port's spans and counters (``runtime/tracing.py``) on a tiny P2
stream on the CPU: off without a profiler, and under one the span paths,
call counts and K2 counters of an ``auto`` round trip and a frames-batched
decode, the spans on the profiler's timeline, each nested in the interval
of its call's top-level span, a span left by an exception, and the
executor's threads each on their own stack."""
import json
import sys

import pytest
import torch

from ternary_image_codec_tpu_torch import config as C
from ternary_image_codec_tpu_torch.codec import codec_for
from ternary_image_codec_tpu_torch.ops import rs
from ternary_image_codec_tpu_torch.ops.pipeline import HEADER_WORDS
from ternary_image_codec_tpu_torch.runtime import tracing
from ternary_image_codec_tpu_torch.runtime.executor import StreamExecutor

CFG = C.EncoderConfig(profile=C.ProfileID.P2_RS26_22,
                      uep=C.uep_luma_priority(), superframe_words=256)
N_SF, SFB = 4, 2

ENCODE = {"t3.encode", "t3.encode/t3.encode.batch",
          "t3.encode/t3.encode.join"}
TOP = ("t3.encode", "t3.decode", "t3.decode_frames")
AUTO = {"t3.decode", "t3.decode/t3.check.k1", "t3.decode/t3.sync.auto",
        "t3.decode/t3.repair.paged", "t3.decode/t3.repair.paged/t3.k2",
        "t3.decode/t3.repair.header", "t3.decode/t3.repair.header/t3.k2"}
FRAMES = {"t3.decode_frames", "t3.decode_frames/t3.check.k1",
          "t3.decode_frames/t3.repair",
          "t3.decode_frames/t3.repair/t3.repair.paged",
          "t3.decode_frames/t3.repair/t3.repair.paged/t3.k2",
          "t3.decode_frames/t3.repair/t3.repair.header",
          "t3.decode_frames/t3.repair/t3.repair.header/t3.k2"}


@pytest.fixture(scope="module")
def codec():
    return codec_for(CFG, "cpu")


@pytest.fixture(scope="module")
def raw():
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, 243, (N_SF, CFG.superframe_words, 9),
                         generator=g).to(torch.int8)


@pytest.fixture(autouse=True)
def empty_report():
    tracing.report(reset=True)
    yield
    tracing.report(reset=True)


def flipped(wire, sfs):
    """A copy of wire planes with one body symbol of each superframe in
    ``sfs`` changed (row 10 of band 1)."""
    w = wire.clone()
    for sf in sfs:
        w[sf, 1, HEADER_WORDS + 10] = (w[sf, 1, HEADER_WORDS + 10] + 1) % 27
    return w


def profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def annotations(prof, tmp_path):
    """The ``user_annotation`` events of the profile's chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


def calls_of(events):
    """{top-level span event: names of the spans in its interval on its
    thread}; asserts that every other span lies in exactly one."""
    def inside(e, top):
        return top["tid"] == e["tid"] and top["ts"] <= e["ts"] \
            and e["ts"] + e["dur"] <= top["ts"] + top["dur"]
    tops = [e for e in events if e["name"] in TOP]
    out = {i: [] for i in range(len(tops))}
    for e in events:
        if e["name"].startswith("t3.") and e["name"] not in TOP:
            owners = [i for i, top in enumerate(tops) if inside(e, top)]
            assert len(owners) == 1, e
            out[owners[0]].append(e["name"])
    return [(tops[i]["name"], sorted(v)) for i, v in out.items()]


def test_off_without_a_profiler(codec, raw, monkeypatch):
    def entered(*a, **k):
        raise AssertionError("entered with tracing off")
    monkeypatch.setattr(torch.cuda, "Event", entered)
    monkeypatch.setattr(torch.profiler, "record_function", entered)
    assert not tracing.active()
    wire = codec.encode(raw, SFB)
    out, ok = codec.decode(flipped(wire, [1]), "auto")
    _, ok_f = codec.decode_frames(flipped(wire, [0, 2])[None], 4)
    assert bool(ok) and bool(ok_f)
    assert tracing.span("t3.x") is tracing.span("t3.y")
    assert tracing.report() == {"spans": {}, "counts": {}}


def test_spans_and_counters_of_a_round_trip(codec, raw, monkeypatch,
                                            tmp_path):
    sent = []
    correct_pm = rs.correct_pm

    def seen(recv_pm, k, maps=None):
        sent.append(recv_pm.shape[2])
        return correct_pm(recv_pm, k, maps)
    monkeypatch.setattr(rs, "correct_pm", seen)
    wire = codec.encode(raw, SFB)
    with profiled() as prof:
        wire_p = codec.encode(raw, SFB)
        out, ok = codec.decode(flipped(wire, [1]), "auto")
        frames = torch.stack([flipped(wire, [0, 2]), wire])
        out_f, ok_f = codec.decode_frames(frames, 4)
    assert torch.equal(wire_p, wire) and bool(ok) and bool(ok_f)
    rep = tracing.report()
    spans = rep["spans"]
    assert set(spans) == ENCODE | AUTO | FRAMES
    calls = {p: s["calls"] for p, s in spans.items()}
    assert calls["t3.encode/t3.encode.batch"] == N_SF // SFB
    assert calls["t3.decode/t3.repair.paged/t3.k2"] == 2
    assert calls["t3.decode_frames/t3.repair/t3.repair.paged/t3.k2"] == 2
    assert {calls[p] for p in ENCODE | AUTO | FRAMES
            if not p.endswith(("/t3.k2", "encode.batch"))} == {1}
    for p, s in spans.items():
        assert set(s) == {"calls", "host_ms"} and s["host_ms"] >= 0, p
    # the K2 counters: every codeword correct_pm got; the dirty ones
    counts = rep["counts"]
    assert counts["t3.k2.codewords"] == sum(sent) > 0
    assert counts["t3.k2.dirty"] == 3               # 1 + 2 flipped symbols
    assert "t3.k2.launches" not in counts           # no card: no K2 launch
    # every span is a record_function on the profiler's timeline, inside
    # the interval of its call's top-level span, which ties a call's spans
    events = annotations(prof, tmp_path)
    assert {p.split("/")[-1] for p in spans} <= {e["name"] for e in events}
    by_call = calls_of(events)
    assert [top for top, _ in by_call] == list(TOP)
    for top, names in by_call:
        assert sorted({top + "/" + "/".join(p.split("/")[1:-1] + [n])
                       for p in spans if p.startswith(top + "/")
                       for n in [p.split("/")[-1]]}) \
            == sorted(p for p in spans if p.startswith(top + "/"))
        assert sorted(set(names)) == sorted(
            {p.split("/")[-1] for p in spans if p.startswith(top + "/")})


def test_a_span_closes_on_an_exception(tmp_path):
    with profiled() as prof:
        with pytest.raises(ValueError):
            with tracing.span("t3.outer"):
                with tracing.span("t3.inner"):
                    raise ValueError("inside")
        with tracing.span("t3.after"):
            pass
    spans = tracing.report()["spans"]
    assert set(spans) == {"t3.outer", "t3.outer/t3.inner", "t3.after"}
    assert all(s["calls"] == 1 for s in spans.values())
    events = annotations(prof, tmp_path)
    inner = [e for e in events if e.get("name") == "t3.inner"]
    outer = [e for e in events if e.get("name") == "t3.outer"]
    assert len(inner) == len(outer) == 1
    assert inner[0]["ts"] + inner[0]["dur"] <= outer[0]["ts"] + outer[0]["dur"]


def test_executor_threads_keep_their_own_stacks(codec, raw, tmp_path):
    """The loader encodes and the caller's thread decodes at the same
    time: each thread's spans nest only under its own."""
    out = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with profiled() as prof:
            ex = StreamExecutor(lambda i: codec.encode(raw[i:i + 2], 1),
                                lambda w: codec.decode(w, "check"),
                                lambda i, y: out.append(bool(y[1])),
                                prefetch=2, device="cpu")
            stats = ex.run(range(3))
    finally:
        sys.setswitchinterval(switch)
    assert stats.frames == 3 and out == [True] * 3
    spans = tracing.report()["spans"]
    decode = {"t3.decode", "t3.decode/t3.check.k1"}
    assert set(spans) == ENCODE | decode
    assert spans["t3.encode"]["calls"] == spans["t3.decode"]["calls"] == 3
    # on the timeline too, each span lies in a call of its own thread (the
    # profiler may leave out the annotations of threads it was not
    # started on: the loader's encode)
    by_call = calls_of(annotations(prof, tmp_path))
    assert [c for c in by_call if c[0] == "t3.decode"] \
        == [("t3.decode", ["t3.check.k1"])] * 3
    assert all(names == ["t3.encode.batch"] * 2 + ["t3.encode.join"]
               for top, names in by_call if top == "t3.encode")
