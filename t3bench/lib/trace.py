"""Spans around calls into the port, and the profiler's reading of a
short steady stretch of the measured window.

``Spans`` records CUDA events (host clock on the CPU) around the calls a
request loop makes, and a ``record_function`` of the same name, so a trace
shows which call the host was in.  ``Tracer`` profiles a stretch of
requests with ``torch.profiler``, wraps the kernels' Python entry points
named by the roofline files to count the bytes of their tensors, and
reduces the exported trace to a ``Summary``: device busy time, kernel time
by name, and the idle gaps with what the host was doing in each.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import tempfile
import time

import torch

WINDOW = "t3bench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}
NAME_CHARS = 120        # of a kernel's name in the breakdown


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Named spans of a request loop's calls; off unless ``enabled``."""

    def __init__(self, dev: torch.device, enabled: bool):
        self.dev, self.enabled = dev, enabled
        self._marks = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, frames: int = 1):
        if not self.enabled:
            yield
            return
        cuda = self.dev.type == "cuda"
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            t0 = time.perf_counter()
        with torch.profiler.record_function("t3bench." + name):
            yield
        if cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self._marks[name].append((e0, e1, frames))
        else:
            self._marks[name].append(
                ((time.perf_counter() - t0) * 1e3, None, frames))

    def ms_per_frame(self) -> dict:
        """{span: [ms a frame of each call]}; waits for the device."""
        sync(self.dev)
        return {name: [(e0 if e1 is None else e0.elapsed_time(e1)) / n
                       for e0, e1, n in marks]
                for name, marks in self._marks.items()}


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict              # device seconds by kernel name
    gaps: list                  # [(label, seconds)], longest first

    def kernel_seconds(self, pattern: str) -> float:
        return sum(s for name, s in self.kernel_s.items() if pattern in name)


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> Summary | None:
    """Reduce chrome-trace events to a ``Summary`` of the ``WINDOW``
    annotation's interval; None without it."""
    X = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in X if e.get("name") == WINDOW
           and e.get("cat", "").lower() in HOST_CATS]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernel_us = [], collections.Counter()
    for e in X:
        if e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            dev.append((a, b))
            kernel_us[e["name"]] += b - a
    busy = _union(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    host = [e for e in X if e.get("cat", "").lower() in HOST_CATS
            and e.get("name") != WINDOW]
    gaps = sorted(holes, key=lambda h: h[0] - h[1])[:10]
    return Summary(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s={k: v / 1e6 for k, v in kernel_us.items()},
        gaps=[(_host_label(host, (a + b) / 2), (b - a) / 1e6)
              for a, b in gaps])


def _host_label(host: list, t: float) -> str:
    """The innermost benchmark span and host op running at time ``t``."""
    cover = [e for e in host
             if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    span = min((e for e in cover if e["name"].startswith("t3bench.")),
               key=lambda e: float(e["dur"]), default=None)
    op = min((e for e in cover if not e["name"].startswith("t3bench.")),
             key=lambda e: float(e["dur"]), default=None)
    parts = [e["name"] for e in (span, op) if e is not None]
    return " > ".join(parts) if parts else "host, outside any op"


class Tracer:
    """Profiles the requests between ``start`` and ``stop``."""

    def __init__(self, dev: torch.device, rooflines: dict):
        self.dev, self.rooflines = dev, rooflines
        self.bytes = collections.Counter()     # kernel -> tensor bytes
        self._undo = []
        self.summary = None
        self.running = False

    def _wrap(self, kernel: str, target: str):
        modname, attr = target.split(":")
        mod = importlib.import_module(modname)
        orig = getattr(mod, attr)

        def nbytes(x):
            if isinstance(x, torch.Tensor):
                return x.numel() * x.element_size()
            if isinstance(x, (tuple, list)):
                return sum(map(nbytes, x))
            return 0

        def counted(*args, **kw):
            out = orig(*args, **kw)
            self.bytes[kernel] += nbytes(args) + nbytes(list(kw.values())) \
                + nbytes(out)
            return out
        setattr(mod, attr, counted)
        self._undo.append((mod, attr, orig))

    def start(self) -> None:
        """Turn the profiler on (a request before the stretch, so that its
        own start-up falls outside the stretch)."""
        from torch.profiler import ProfilerActivity, profile
        sync(self.dev)
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.running = True

    def open(self) -> None:
        """Open the profiled stretch."""
        from torch.profiler import record_function
        sync(self.dev)
        self._rf = record_function(WINDOW)
        self._rf.__enter__()
        for kernel, rf in self.rooflines.items():
            self._wrap(kernel, rf["call"])

    def stop(self) -> None:
        sync(self.dev)
        if hasattr(self, "_rf"):
            self._rf.__exit__(None, None, None)
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()
        self._prof.__exit__(None, None, None)
        self.running = False

    def read(self) -> None:
        """Export the stopped profile and reduce it (after the window)."""
        d = tempfile.mkdtemp(prefix="t3bench-trace-")
        try:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            shutil.rmtree(d, ignore_errors=True)
        del self._prof
        self.summary = summarize(events)
        self.top_ops = sorted(self.summary.kernel_s.items(),
                              key=lambda kv: -kv[1])[:10] \
            if self.summary else []
        self.top_ops = [(name[:NAME_CHARS], s) for name, s in self.top_ops]
