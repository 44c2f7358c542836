"""One run of one cell: set-up, the measured window, the judgement of the
answers against the plain reference, and the result line.

The window is a closed loop with one client: each request starts when the
last has ended, and runs from the call into the port to the device sync
that ends it.  A cell of n > 1 chips runs as n ranks (``ranks.py``): this
process is rank 0, on ``cuda:0``, and starts the others, which run each
request in lockstep with it; the broadcast that lets them go counts in the
request.  The answers judged are rank 0's, ``memory_peak_bytes`` is the
fullest card's, and a ``--trace 1`` run profiles rank 0 alone.  The runner
stops starting requests once ``seconds`` have passed and, with
``--trace 1``, the profiled stretch has closed.  A sample of requests
drawn from the seed, and the last one, keep their answers; every
request's ok flag is counted.  Once the window has closed and the peak
memory is read, every rank frees the program's state, counts what its
loop's ``tally`` checks on that rank (where the loop has one; the counts
are summed over the ranks), and the loop's ``judge`` holds rank 0's
answers and those counts to the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

from . import cell as cells
from . import checks as chk
from . import ranks
from .trace import Spans, Tracer, sync


@dataclasses.dataclass
class Context:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(ctx)``
    returns a number, or None when it finds nothing to read)."""

    workload: dict
    config: dict
    setup_s: float
    window_s: float
    frames: int
    latencies_s: list
    peak_bytes: int | None      # the fullest card's
    spans: dict                 # span -> [ms a frame, a call]
    summary: object | None      # trace.Summary of the profiled stretch
    kernel_bytes: dict          # kernel -> tensor bytes in that stretch
    rooflines: dict
    peaks: dict


def parse(argv):
    ap = argparse.ArgumentParser(prog="t3bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the cell's control in the program's place "
                    "(tests and limit-setting only)")
    return ap.parse_args(argv)


def sample(seed: int, params: dict) -> set:
    """Requests whose answers are judged: ``check.sample`` of the first
    ``check.among`` requests, drawn from the seed."""
    c = params["check"]
    rng = np.random.default_rng([seed & ((1 << 63) - 1), 0x5A])
    return set(rng.choice(c["among"], c["sample"], replace=False).tolist())


def run_cell(bench_dir: str, benchmark: dict, name: str, seed: int,
             seconds: float, trace: bool, dev, t0: float,
             control: bool = False, cores=None,
             timeout_s: float = ranks.TIMEOUT_S) -> dict:
    """The result object of one run (``correct`` and ``checks`` included)
    on ``dev``; ``t0`` is the process's start on ``time.perf_counter``.
    A cell of more than one chip runs its other ranks on the cores that
    ``ranks.plan_cores`` gives from ``cores``, the affinity mask the
    process had before ``run.py`` pinned it (default: the mask it has);
    raises ``ranks.Forbidden`` where one of them loaded a forbidden
    module."""
    cell = cells.load_cell(bench_dir, name)
    world = None
    if cell["chips"] > 1:
        world = ranks.World(
            bench_dir, name, seed, control, cell["chips"], dev,
            sorted(os.sched_getaffinity(0)) if cores is None else cores,
            timeout_s)
    try:
        return _run(bench_dir, benchmark, name, cell, seed, seconds, trace,
                    dev, t0, control, world)
    except BaseException:
        if world is not None and world.backend == "nccl" and not world.clean:
            traceback.print_exc()       # the process ends in world.close()
        raise
    finally:
        if world is not None:
            world.close()


def _run(bench_dir, benchmark, name, cell, seed, seconds, trace, dev, t0,
         control, world):
    import torch
    cfg = cells.load_config(bench_dir, cell["config"])
    e2e, per = cells.metric_plan(benchmark, name)
    plan = per if trace else e2e
    readers = {m.name: cells.load_reader(bench_dir, m.name) for m in plan}
    rooflines = cells.load_rooflines(bench_dir) if trace else {}
    params = cell["params"]
    spans = Spans(dev, enabled=trace)
    loop = cells.load_loop(bench_dir, cell["loop"]).Loop(
        cfg, params, seed, dev, spans, control=control)
    loop.warm()
    sync(dev)
    keep = sample(seed, params)
    tracer = Tracer(dev, rooflines) if trace else None
    p0, pn = params["trace"]["skip"], params["trace"]["requests"]
    cuda = dev.type == "cuda"
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    lat, kept = [], {}
    i = frames = not_ok = 0
    t_start = time.perf_counter()
    while True:
        if tracer and i in (p0 - 1, p0):
            t = time.perf_counter()
            if i == p0:
                tracer.open()
            else:
                tracer.start()
            t_start += time.perf_counter() - t
        ts = time.perf_counter()
        if world:
            world.go()
        with spans("request", loop.frames_per_request):
            ans = loop.request(i)
        sync(dev)
        te = time.perf_counter()
        if tracer and tracer.running and i == p0 + pn - 1:
            tracer.stop()
            # the profiler's own stop is not the program's time
            t_start += time.perf_counter() - te
        lat.append(te - ts)
        frames += loop.frames_per_request
        not_ok += not bool(ans["ok"])
        if i in keep:
            kept[i] = ans
        last = (i, ans)
        i += 1
        # a traced run holds its whole profiled stretch, however slow
        if te - t_start >= seconds and (tracer is None or i >= p0 + pn):
            break
    window_s = te - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if world:
        world.stop()
    if tracer:
        if tracer.running:
            tracer.stop()
        tracer.read()
    kept[last[0]] = last[1]
    del ans, last
    span_ms = spans.ms_per_frame()
    loop.release()
    tally = loop.tally() if hasattr(loop, "tally") else None
    if world:
        reports = world.reports({"peak": peak, "requests": i, "tally": tally,
                                 "modules": ranks.loaded_forbidden()})
        world.close()
        if any(r["requests"] != i for r in reports.values()):
            raise RuntimeError(f"ranks out of lockstep: rank 0 ran {i} "
                               f"requests, the others {reports}")
        found = {r: rep["modules"] for r, rep in reports.items()
                 if rep["modules"]}
        if found:
            raise ranks.Forbidden(found)
        peaks = {r: rep["peak"] for r, rep in reports.items()}
        print(f"t3bench: peak bytes by rank {peaks}", file=sys.stderr)
        peak = ranks.fullest(peaks.values())
        if tally is not None:
            tally = {k: sum(rep["tally"][k] for rep in reports.values())
                     for k in tally}
    judged = loop.judge(kept, not_ok, i) if tally is None \
        else loop.judge(kept, not_ok, i, tally)
    del kept
    ctx = Context(
        workload=cell, config=cfg, setup_s=setup_s, window_s=window_s,
        frames=frames, latencies_s=lat, peak_bytes=peak, spans=span_ms,
        summary=tracer.summary if tracer else None,
        kernel_bytes=dict(tracer.bytes) if tracer else {},
        rooflines=rooflines, peaks=cells.load_peaks(bench_dir))
    metrics = {}
    for m in plan:
        v = readers[m.name].read(ctx)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": all(map(chk.passed, judged)), "attempted": i,
           "failed": not_ok, "metrics": metrics, "device": device}
    if tracer and tracer.summary:
        s = tracer.summary
        device["busy_s"], device["window_s"] = s.busy_s, s.window_s
        out["breakdown"] = {"device_ops": [[k, v] for k, v in tracer.top_ops],
                            "idle_gaps": [[k, v] for k, v in s.gaps]}
    out["checks"] = {c["name"]: {"value": c["value"],
                                 "limit": f"{c['op']} {c['limit']}"}
                     for c in judged}
    return out


def power_limit(dev) -> str | None:
    """The card's ``nvidia-smi`` name and power limit, as read now."""
    import subprocess
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() or None


def main(argv, t0: float, root: str, cores=None) -> int:
    """``run.py``'s run of one cell on the card; ``cores`` is the affinity
    mask the process had before ``run.py`` pinned it.  The exit code."""
    args = parse(argv)
    bench_dir = os.path.join(root, "t3bench")
    try:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            benchmark = json.load(f)
        cell = cells.load_cell(bench_dir, args.workload)
    except (OSError, ValueError) as e:
        print(f"t3bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"t3bench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return report(bench_dir, benchmark, args, dev, t0, cores)


def report(bench_dir: str, benchmark: dict, args, dev, t0: float,
           cores=None, timeout_s: float = ranks.TIMEOUT_S) -> int:
    """Run the cell of ``args`` on ``dev`` and print its result line and
    checks; the exit code (3 where a rank loaded a forbidden module)."""
    try:
        out = run_cell(bench_dir, benchmark, args.workload, args.seed,
                       args.seconds, bool(args.trace), dev, t0,
                       control=args.control, cores=cores, timeout_s=timeout_s)
    except ranks.Forbidden as e:
        print(f"t3bench: {e}", file=sys.stderr)
        return 3
    bad = ranks.loaded_forbidden()
    if bad:
        print(f"t3bench: modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    if dev.type == "cuda":
        out["device"]["power"] = power_limit(dev)
    checks = out.pop("checks")
    out["checks"] = checks                  # last key of the line
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
