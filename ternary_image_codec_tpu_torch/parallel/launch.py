"""Running ranks: ``spawn`` starts one process a rank and joins them.

Each rank process initialises ``torch.distributed`` through a ``FileStore``
in a fresh temporary directory (never a fixed TCP port, so concurrent runs
on one host cannot clash), runs ``fn(rank, world, *args)`` and sends its
result back pickled.  The parent re-raises the first failure with the
failing rank's traceback, and raises ``TimeoutError`` when the ranks run
past ``timeout_s`` (the process group's collectives carry the same
timeout), so a rank stuck in a collective never hangs the caller.

``fn`` is sent to the ranks by its import path: it must live in a module
that imports no jax (the port's own modules, or a script such as
``chip_smoke.py``), since every rank imports it afresh.

Backend and device rules (no silent switch):

* ``device=None``: rank r runs on ``cuda:(r % device_count)``; without a
  card it raises, as ``codec.resolve_device`` does.  ``device="cpu"`` is
  the only way to the CPU; any other device puts every rank on it.
* ``backend=None``: ``"nccl"`` on CUDA devices, ``"gloo"`` on the CPU.
* NCCL takes one rank a card: two ranks mapped to one card raise, naming
  ``backend="gloo"``, which shares a card between ranks.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch

from ..codec import resolve_device

# the device ``spawn`` gave this rank process (None outside a rank)
_rank_device: torch.device | None = None


def rank_device() -> torch.device:
    """This rank's device: the one ``spawn`` gave it, else the current CUDA
    device (raising without one)."""
    return _rank_device if _rank_device is not None else resolve_device(None)


def rank_devices(world: int, device=None) -> list:
    """The device of each of ``world`` ranks under ``spawn``'s rule."""
    if device is None:
        resolve_device(None)                         # raises without a card
        n = torch.cuda.device_count()
        return [torch.device("cuda", r % n) for r in range(world)]
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(dev)
    return [dev] * world


def resolve_backend(devices: list, backend=None) -> str:
    """``backend`` checked against the ranks' devices (None: NCCL on CUDA,
    gloo on the CPU)."""
    cuda = devices[0].type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL needs CUDA devices; pass backend='gloo' "
                             "to run ranks on the CPU")
        if len(set(devices)) < len(devices):
            raise ValueError(
                f"NCCL runs one rank a card, but {len(devices)} ranks map "
                f"to {len(set(devices))} card(s) ({devices[0]} holds more "
                "than one); pass backend='gloo' to share a card between "
                "ranks")
    return backend


def _rank_main(rank, world, fn, args, backend, device, store_path,
               timeout_s, results):
    global _rank_device
    import torch.distributed as dist
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        _rank_device = dev
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn(fn, world: int, *, backend=None, device=None, args=(),
          timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` rank processes (start
    method spawn) and return their results by rank.  ``fn`` returns host
    data (numpy, CPU tensors, plain Python); it is pickled.  Raises the
    first rank's failure with its traceback, and ``TimeoutError`` after
    ``timeout_s`` seconds; every rank process is stopped on the way out."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    devices = rank_devices(world, device)
    backend = resolve_backend(devices, backend)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="t3_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn, tuple(args), backend,
                               str(devices[r]), store, timeout_s, results))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:                 # a failure report still in flight
                        rank, ok, payload = results.get(timeout=2)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} died with exit code "
                            f"{procs[dead[0]].exitcode} and no report")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} of "
                        f"{world} ran past {timeout_s} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        return [out[r] for r in range(world)]
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
