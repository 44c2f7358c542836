"""The program's own spans and counters, read by the per-layer metrics that
read them (``metrics/<name>.py``).

The port's spans (``runtime/tracing.py``, names ``t3.*``) record only
while a ``torch.profiler`` session records, so they cover the requests of
a ``--trace 1`` run's profiled stretch.  Two readings come from them:

* host ms and counters: the port's ``tracing.report()``, taken (and
  reset) once a run;
* device ms: the kernels, copies and sets launched under a span, from the
  exported trace: each device event is put, by its ``correlation``, under
  every ``t3.*`` span open on the launching thread when it was launched,
  and a span's device time is the union of its events' intervals.  The
  trace is seen as ``trace.summarize`` reduces it: this module wraps that
  function on import, keeps a table by span path beside the ``Summary``,
  and changes nothing of what it returns.

A span path starts with its top-level span (``t3.encode``, ``t3.decode``,
``t3.decode_frames``), one a call into the program; "a frame" is a
reading summed over the stretch, divided by the top-level span's calls
and by the frames a call holds (the cell's ``frames_per_request``, else
1).  Every reader returns None when the program records nothing: a
program without these spans, or a run whose profiled stretch kept the
device idle, such as a run on the CPU, where the host runs each op
itself and its host time is no dispatch time.
"""
from __future__ import annotations

import collections

from . import trace

PREFIX = "t3."
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}

_last: tuple = (None, None)         # (context, the port's report)
_traced: tuple = (None, None)       # (Summary, device table of its trace)


def span_device_us(events: list) -> dict:
    """{span path: [device us, instances]} of the ``t3.*`` spans that
    start inside the ``trace.WINDOW`` annotation; {} without it."""
    X = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in X if e.get("name") == trace.WINDOW
           and e.get("cat", "").lower() in trace.HOST_CATS]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = collections.defaultdict(list)       # correlation -> intervals
    for e in X:
        corr = e.get("args", {}).get("correlation")
        if corr is not None and e.get("cat", "").lower() in trace.DEVICE_CATS:
            t = float(e["ts"])
            dev[corr].append((t, t + float(e["dur"])))
    items = []              # (ts, 0 span / 1 launch, -dur, event)
    for e in X:
        cat, t = e.get("cat", "").lower(), float(e["ts"])
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            if w0 <= t <= w1:
                items.append((t, 0, -float(e["dur"]), e))
        elif cat in LAUNCH_CATS and \
                e.get("args", {}).get("correlation") in dev:
            items.append((t, 1, 0.0, e))
    items.sort(key=lambda it: it[:3])
    stacks = collections.defaultdict(list)    # thread -> [(path, end)]
    iv = collections.defaultdict(list)
    n = collections.Counter()
    for t, kind, _, e in items:
        stack = stacks[(e.get("pid"), e.get("tid"))]
        while stack and stack[-1][1] < t:
            stack.pop()
        if kind == 0:
            path = (stack[-1][0] + "/" if stack else "") + e["name"]
            stack.append((path, t + float(e["dur"])))
            n[path] += 1
        else:
            for path, _ in stack:
                iv[path].extend(dev[e["args"]["correlation"]])
    return {p: [sum(b - a for a, b in trace._union(iv[p])), k]
            for p, k in n.items()}


def _keeping(summarize):
    def summarize_and_keep(events):
        global _traced
        s = summarize(events)
        _traced = (s, span_device_us(events) if s is not None else {})
        return s
    summarize_and_keep.__wrapped__ = summarize
    return summarize_and_keep


if not hasattr(trace.summarize, "__wrapped__"):
    trace.summarize = _keeping(trace.summarize)


def _busy(ctx) -> bool:
    return ctx.summary is not None and ctx.summary.busy_s > 0


def report(ctx) -> dict | None:
    """The port's report for this run's context, taken (and reset) on the
    first read; None when there is nothing to read."""
    global _last
    if _last[0] is ctx:
        return _last[1]
    rep = None
    if _busy(ctx):
        from ternary_image_codec_tpu_torch.runtime import tracing
        read = getattr(tracing, "report", None)
        rep = read(reset=True) if read else None
        if rep is not None and not (rep.get("spans") or rep.get("counts")):
            rep = None
    _last = (ctx, rep)
    return rep


def frames_per_call(ctx) -> int:
    return int(ctx.workload.get("params", {}).get("frames_per_request", 1))


def calls(rep: dict, root: str) -> int:
    return rep["spans"].get(root, {}).get("calls", 0)


def _under(path: str, root: str, leaf: str) -> bool:
    """Whether ``path`` starts at ``root`` and ends in a span named
    ``leaf``, or beginning with it when ``leaf`` ends in a dot."""
    parts = path.split("/")
    name = parts[-1]
    hit = name.startswith(leaf) if leaf.endswith(".") else name == leaf
    return parts[0] == root and hit


def host_ms(ctx, root: str, leaf: str) -> float | None:
    """Host ms a frame of the spans named ``leaf`` under ``root``, from
    the port's report; None where there is no such span."""
    rep = report(ctx)
    if rep is None or not calls(rep, root):
        return None
    vals = [s["host_ms"] for p, s in rep["spans"].items()
            if _under(p, root, leaf)]
    if not vals:
        return None
    return sum(vals) / calls(rep, root) / frames_per_call(ctx)


def device_ms(ctx, root: str, leaf: str) -> float | None:
    """Device ms a frame of the work launched under the spans named
    ``leaf`` under ``root``, from this run's trace; None where there is
    no such span."""
    summary, table = _traced
    if not _busy(ctx) or summary is not ctx.summary:
        return None
    n = table.get(root, (0, 0))[1]
    vals = [us for p, (us, _) in table.items() if _under(p, root, leaf)]
    if not n or not vals:
        return None
    return sum(vals) / 1e3 / n / frames_per_call(ctx)


def counts(ctx) -> dict | None:
    """The port's counters over the profiled stretch; None without."""
    rep = report(ctx)
    return None if rep is None else rep.get("counts", {})
