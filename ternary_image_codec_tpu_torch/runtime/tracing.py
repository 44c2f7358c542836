"""Tracing / profiling / structured logging of the PyTorch port.

  * span(name)              -- one layer boundary of the codec's work;
  * count(name, n)          -- a count at such a boundary;
  * report(reset=False)     -- what the spans and counters recorded;
  * log_event(event, **)    -- one structured JSON line to stderr, enabled
                               by T3_LOG=1;
  * device_trace(outdir)    -- a ``torch.profiler`` trace (CPU, and CUDA
                               where there is a card) written to
                               ``outdir/trace.json`` in Chrome's trace
                               format.

Spans and counters are on exactly while a ``torch.profiler`` session is
recording, and there is no other switch.  Off, ``span`` returns one shared
no-op context manager and ``count`` returns at once: no allocation, no
clock read.  On, a span is a ``record_function`` of its name, so it lands
on the profiler's timeline beside the kernels it launches: the kernels'
device time under a span, and the spans of one call (nested in its
top-level span's interval on its thread), are read from that trace.  The
module itself adds up, by span path (``parent/child``), each span's calls
and host milliseconds (``perf_counter``).  Each thread has its own stack
of open spans.  A counter takes an int, or a 0-d tensor that is added
where it lives and read in ``report``, so that counting adds no host
sync.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _profiler


def active() -> bool:
    """Whether spans and counters record now: a ``torch.profiler`` session
    is recording (a flag of the whole process; the profiler's own check,
    ``torch._C._autograd._profiler_enabled``, reads False on the threads
    that did not start it)."""
    return _profiler._is_profiler_enabled


_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: dict = {}       # path -> {"calls", "host_ms"}
_counts: dict = {}      # name -> int or 0-d tensor


class _Span:
    __slots__ = ("name", "path", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.path = stack[-1] + "/" + self.name if stack else self.name
        stack.append(self.path)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter() - self.t0) * 1e3
        self.rf.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            s = _spans.setdefault(self.path, {"calls": 0, "host_ms": 0.0})
            s["calls"] += 1
            s["host_ms"] += host_ms
        return False


def span(name: str):
    """A context manager around one layer boundary named ``name``
    (``t3.<layer>``)."""
    return _Span(name) if active() else _OFF


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d tensor kept where it lives) to the
    counter ``name``."""
    if not active():
        return
    with _lock:
        prev = _counts.get(name, 0)
        if isinstance(n, torch.Tensor):
            _counts[name] = n.detach().to(torch.int64) + prev
        else:
            _counts[name] = prev + int(n)


def report(reset: bool = False) -> dict:
    """What was recorded: {"spans": {path: {"calls", "host_ms"}},
    "counts": {name: int}}; reads each tensor counter."""
    with _lock:
        out = {"spans": {p: dict(s) for p, s in _spans.items()},
               "counts": dict(_counts)}
        if reset:
            _spans.clear()
            _counts.clear()
    out["counts"] = {k: int(v) for k, v in out["counts"].items()}
    return out


def log_event(event: str, **fields) -> None:
    """One JSON line to stderr when T3_LOG is set (structured logging)."""
    if not os.environ.get("T3_LOG"):
        return
    rec = {"event": event, "ts": time.time()}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


@contextlib.contextmanager
def device_trace(outdir: str | None):
    """``torch.profiler`` trace of the block, exported on exit as
    ``outdir/trace.json`` (Chrome trace format); no-op when outdir is
    falsy.  A profiler that fails to start or stop is logged
    (``log_event``) and the block runs all the same."""
    if not outdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.start()
        started = True
    except RuntimeError as e:           # profiler busy or unsupported
        log_event("device_trace_failed", outdir=outdir, error=str(e))
        started = False
    try:
        yield
    finally:
        if started:
            try:
                prof.stop()
                os.makedirs(outdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
            except (RuntimeError, OSError) as e:
                log_event("device_trace_stop_failed", error=str(e))
