"""Tracing / profiling / structured logging of the PyTorch port.

The port of the JAX package's ``runtime/tracing.py``, same API:

  * stage_timer(name, sync=None) -- host-side wall-clock accumulation per
                            pipeline stage; with ``sync``, a CUDA tensor,
                            the clock stops after the work queued so far on
                            the current stream of its device (one stream,
                            never the whole device);
  * stage_report()       -- {stage: {"calls": n, "total_s": t}} snapshot;
  * log_event(event, **) -- one structured JSON line to stderr, enabled by
                            T3_LOG=1;
  * device_trace(outdir) -- a ``torch.profiler`` trace (CPU, and CUDA where
                            there is a card) written to
                            ``outdir/trace.json`` in Chrome's trace format.

Everything is no-overhead-when-off: timers are a perf_counter pair, and
log_event returns immediately unless T3_LOG is set.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Dict

import torch

_lock = threading.Lock()
_stages: Dict[str, Dict[str, float]] = {}


@contextlib.contextmanager
def stage_timer(name: str, sync=None):
    """Time a pipeline stage.  `sync`: optional tensor to wait for before
    stopping the clock (pass the stage's output); a CUDA tensor waits for
    its device's current stream, anything else is ready already."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.current_stream(sync.device).synchronize()
        dt = time.perf_counter() - t0
        with _lock:
            s = _stages.setdefault(name, {"calls": 0, "total_s": 0.0})
            s["calls"] += 1
            s["total_s"] += dt


def stage_report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    with _lock:
        out = {k: dict(v) for k, v in _stages.items()}
        if reset:
            _stages.clear()
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
