"""Which ``torch.distributed`` calls take CUDA int8 (and bool) tensors.

    python -m ternary_image_codec_tpu_torch.parallel.probe [--device cuda:0]

Runs two gloo ranks sharing the device, then one NCCL rank on it (or, with
``--device cpu``, two gloo ranks on the CPU), tries each call once on
small tensors and checks what arrives.  Prints one JSON line
``{backend: {call: "ok" | "wrong values" | "<exception>"}}``.  A call that
one rank refuses while its peer waits ends at the process group's
timeout, so the peer-to-peer calls go last.
"""
from __future__ import annotations

import argparse
import datetime
import json

import torch

from . import launch

TIMEOUT_S = 30


def _calls(dist, rank, world, dev):
    def t(v, dtype=torch.int8):
        return torch.full((4,), v, dtype=dtype, device=dev)

    def broadcast(dtype):
        x = t(7 if rank == 0 else 0, dtype)
        dist.broadcast(x, 0)
        return bool((x == t(7, dtype)).all())

    def all_reduce_min():
        x = t(rank + 1, torch.int32)
        dist.all_reduce(x, dist.ReduceOp.MIN)
        return bool((x == 1).all())

    def all_reduce_sum(dtype):
        x = t(1, dtype)
        dist.all_reduce(x)
        return bool((x == t(world, dtype)).all())

    def all_gather(dtype):
        parts = [t(0, dtype) for _ in range(world)]
        dist.all_gather(parts, t(rank + 1, dtype))
        return all(bool((p == t(r + 1, dtype)).all())
                   for r, p in enumerate(parts))

    def all_gather_into_tensor():
        out = torch.zeros(4 * world, dtype=torch.int8, device=dev)
        dist.all_gather_into_tensor(out, t(rank + 1))
        return bool((out.view(world, 4)[:, 0].cpu()
                     == torch.arange(1, world + 1)).all())

    def send_recv():
        if world < 2:
            return "needs two ranks"
        x = t(5 if rank == 0 else 0)
        if rank < 2:
            work = dist.isend(x, 1) if rank == 0 else dist.irecv(x, 0)
            work.wait(datetime.timedelta(seconds=TIMEOUT_S))
        return bool((x == 5).all())

    return {"broadcast int8": lambda: broadcast(torch.int8),
            "broadcast bool": lambda: broadcast(torch.bool),
            "all_reduce MIN int32": all_reduce_min,
            "all_reduce SUM int8": lambda: all_reduce_sum(torch.int8),
            "all_reduce SUM bool": lambda: all_reduce_sum(torch.bool),
            "all_gather int8": lambda: all_gather(torch.int8),
            "all_gather bool": lambda: all_gather(torch.bool),
            "all_gather_into_tensor int8": all_gather_into_tensor,
            "barrier": lambda: dist.barrier() is None,
            "send/recv int8": send_recv}


def probe_rank(rank, world, names, progress):
    """Try the calls ``names`` in order; each call's name is written to
    ``progress`` before it runs and its finding after, so the record
    survives a call that aborts the process."""
    import torch.distributed as dist
    dev = launch.rank_device()
    calls = _calls(dist, rank, world, dev)
    with open(f"{progress}.{rank}", "a") as log:
        for name in names:
            log.write(name)
            log.flush()
            try:
                got = calls[name]()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                found = ("ok" if got is True else
                         "wrong values" if got is False else got)
            except Exception as e:         # the finding is the exception
                found = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            log.write(f"\t{found}\n")
            log.flush()


def probe(backend, world, device) -> dict:
    """{call: finding} for one backend, read from rank 0's record; a call
    that kills a rank reads "aborted the process", and the calls after it
    run in new ranks."""
    import os
    import tempfile
    names = list(_calls(None, 0, world, None))
    found = {}
    with tempfile.TemporaryDirectory() as d:
        progress = os.path.join(d, "progress")
        while names:
            try:
                launch.spawn(probe_rank, world, backend=backend,
                             device=device, args=(names, progress),
                             timeout_s=TIMEOUT_S * 4)
                aborted = None
            except RuntimeError as e:
                aborted = str(e).splitlines()[0]
            with open(f"{progress}.0") as f:
                for line in f.read().splitlines():
                    name, _, finding = line.partition("\t")
                    found[name] = finding or f"aborted the process: {aborted}"
            left = [n for n in names if n not in found]
            if aborted is not None and left == names:
                raise RuntimeError(f"the ranks died before any call: {aborted}")
            if aborted is None:
                break
            names = left
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    runs = [("gloo", 2)] + ([("nccl", 1)] if args.device != "cpu" else [])
    report = {}
    for backend, world in runs:
        report[f"{backend} x{world} on {args.device}"] = probe(
            backend, world, args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
