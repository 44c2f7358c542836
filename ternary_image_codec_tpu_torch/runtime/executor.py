"""Pipelined stream executor: overlap host IO with device codec work.

The port of the JAX package's ``runtime/executor.py``, same semantics:
three things in flight at once -- the host loading frame i+1, the device
working on frame i, the host writing frame i-1 -- with plain threads and
bounded queues:

    loader thread   : load(item), H2D staged on its own stream (queue depth
                      = prefetch)
    caller thread   : device_fn(x) dispatched on the caller's current
                      stream, never waiting for the device
    writer thread   : write(index, y) in frame order on its own stream,
                      D2H included (queue depth = prefetch)

Backpressure is the queue bound: at most ``prefetch`` frames of device
output are queued, so device memory stays O(prefetch) whatever the stream
length.  Errors on any stage cancel the pipeline and re-raise in run().

JAX dispatch is asynchronous by itself; in torch the ordering between the
threads is made with CUDA events, one per frame and stage:

* the loader runs ``load`` under its own stream (copies from pinned
  memory with ``non_blocking=True`` overlap the caller's work) and records
  an event there; the caller's stream waits on it before ``device_fn``;
* after ``device_fn`` the caller records an event on its stream; the
  writer's stream waits on it before ``write``, whose D2H copy then runs
  beside the next frame's device work;
* every tensor that crosses to another stream gets ``record_stream`` for
  it, so the caching allocator does not hand its memory out while that
  stream may still use it.

Nothing here synchronises the whole device; each worker thread calls
``torch.cuda.set_device``.  On the CPU (``device="cpu"``) there are no
streams or events and the same queues run.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

import torch

from ..codec import resolve_device

_SENTINEL = object()


@dataclass
class ExecutorStats:
    frames: int = 0
    load_s: float = 0.0
    dispatch_s: float = 0.0
    write_s: float = 0.0
    errors: list = field(default_factory=list)


def _cuda_tensors(obj) -> Iterator[torch.Tensor]:
    """The CUDA tensors in a (nested) tuple, list or dict."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _cuda_tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _cuda_tensors(o)


class StreamExecutor:
    """Run load -> device_fn -> write over a frame stream, pipelined.

    load(item) -> x           host work (file read, CRC, H2D staging); runs
                              on the loader thread under its own stream
    device_fn(x) -> y         device work, dispatched on the caller thread;
                              the executor never waits for y there
    write(index, y) -> None   host work (D2H, container write); called in
                              frame order from the writer thread, under
                              its own stream, after y's device work

    ``device``: the CUDA device the stages run on (default: the current
    one; raises without a card), or ``"cpu"``.
    """

    def __init__(self, load: Callable[[Any], Any],
                 device_fn: Callable[[Any], Any],
                 write: Callable[[int, Any], None],
                 prefetch: int = 2, device=None):
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self._load = load
        self._device = device_fn
        self._write = write
        self._prefetch = prefetch
        self._dev = resolve_device(device)
        self.stats = ExecutorStats()

    def _stream(self):
        return torch.cuda.Stream(self._dev) if self._dev.type == "cuda" \
            else None

    def _enter(self, stream):
        """Per-thread set-up and the stream context of a stage."""
        if stream is None:
            return contextlib.nullcontext()
        torch.cuda.set_device(self._dev)
        return torch.cuda.stream(stream)

    @staticmethod
    def _mark(stream):
        """An event after the work queued so far on ``stream``."""
        if stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    @staticmethod
    def _hand_over(obj, ready, stream) -> None:
        """``stream`` waits for ``ready``; obj's tensors are in use there."""
        if stream is None:
            return
        stream.wait_event(ready)
        for t in _cuda_tensors(obj):
            t.record_stream(stream)

    def run(self, items: Iterable[Any], start: int = 0) -> ExecutorStats:
        """Process items[start:] as frames start, start+1, ...; returns
        stats.  Re-raises the first stage error after cancelling."""
        inq: queue.Queue = queue.Queue(maxsize=self._prefetch)
        outq: queue.Queue = queue.Queue(maxsize=self._prefetch)
        cancel = threading.Event()
        errs: list = []
        load_stream, write_stream = self._stream(), self._stream()

        def _loader():
            try:
                with self._enter(load_stream):
                    for i, item in enumerate(items):
                        if i < start:
                            continue
                        if cancel.is_set():
                            return
                        t0 = time.perf_counter()
                        x = self._load(item)
                        ready = self._mark(load_stream)
                        self.stats.load_s += time.perf_counter() - t0
                        inq.put((i, x, ready))
            except Exception as e:          # noqa: BLE001 - stage boundary
                errs.append(e)
                cancel.set()
            finally:
                inq.put(_SENTINEL)

        def _writer():
            try:
                with self._enter(write_stream):
                    while True:
                        got = outq.get()
                        if got is _SENTINEL:
                            return
                        i, y, done = got
                        t0 = time.perf_counter()
                        self._hand_over(y, done, write_stream)
                        self._write(i, y)
                        self.stats.write_s += time.perf_counter() - t0
                        self.stats.frames += 1
            except Exception as e:          # noqa: BLE001 - stage boundary
                errs.append(e)
                cancel.set()
                # drain so the dispatcher never blocks on a dead writer
                while outq.get() is not _SENTINEL:
                    pass

        lt = threading.Thread(target=_loader, name="t3-loader", daemon=True)
        wt = threading.Thread(target=_writer, name="t3-writer", daemon=True)
        lt.start()
        wt.start()
        cur = (torch.cuda.current_stream(self._dev)
               if self._dev.type == "cuda" else None)
        try:
            while True:
                got = inq.get()
                if got is _SENTINEL:
                    break
                if cancel.is_set():
                    continue                 # drain
                i, x, ready = got
                t0 = time.perf_counter()
                self._hand_over(x, ready, cur)
                y = self._device(x)          # dispatch only: do NOT sync
                done = self._mark(cur)
                self.stats.dispatch_s += time.perf_counter() - t0
                outq.put((i, y, done))
        finally:
            cancel.set()
            outq.put(_SENTINEL)
            wt.join()
            # unblock a loader stuck on a full input queue, then join it
            while lt.is_alive():
                try:
                    inq.get(timeout=0.1)
                except queue.Empty:
                    pass
                lt.join(timeout=0.1)
        self.stats.errors = errs
        if errs:
            raise errs[0]
        return self.stats
