"""The ranks of a cell on more than one card.

Rank 0 is the harness's own process, on ``cuda:0`` and on the two cores
``run.py`` pinned it to.  Ranks 1 to n-1 are processes that a ``World``
starts (start method spawn), rank r on ``cuda:r`` (on the CPU, with gloo,
in the benchmark's own tests) and on cores of its own
(``plan_cores``).  A one-card cell has no ``World``: no process group and
no other process.

The ``World`` creates the process group (NCCL on the cards, gloo on the
CPU) through a ``FileStore`` in a fresh temporary directory, never a fixed
port, before the request loop is built.  Every rank builds the cell's
loop, warms it up and resets its card's peak memory counter.  Once a
request, rank 0 broadcasts one int, go on (1) or stop (0), and the other
ranks then run the same request, so that the loop's collectives meet.
After the stop each rank reads its card's peak, frees the program's state
(``Loop.release``), counts what the loop checks on every rank
(``Loop.tally``, where the loop has one) and sends rank 0 its report in one
``gather_object``; then every rank leaves the process group.

A rank that raises prints its traceback and ends; the others then wait in
a collective that cannot finish.  So every process of the cell keeps a
``Deadline`` that each step of the lockstep (the start, each go, the
stop) moves on: with no step within ``timeout_s`` it prints the stack of
each of its threads and ends with exit code 1.  The process group's timeout,
a little longer, backs that up.  Each rank dies with rank 0
(``PR_SET_PDEATHSIG``), so none outlives the run.
"""
from __future__ import annotations

import ctypes
import datetime
import faulthandler
import multiprocessing as mp
import os
import shutil
import signal
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "ternary_image_codec_tpu")
TIMEOUT_S = 240.0       # no next step of the lockstep for this long: a hang
PG_MARGIN_S = 30.0      # the process group's timeout is this much longer
JOIN_S = 60.0           # for the ranks to end once they have reported
REARM_S = 5.0           # a step moves the deadline on at most this often
PR_SET_PDEATHSIG = 1


def loaded_forbidden() -> list:
    """The forbidden top-level modules in this process's ``sys.modules``,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Forbidden(RuntimeError):
    """Ranks other than rank 0 loaded forbidden modules: {rank: names}."""

    def __init__(self, found: dict):
        super().__init__(f"modules loaded in rank(s): {found}")
        self.found = found


def plan_cores(cores, n: int) -> list:
    """The cores of each of ``n`` ranks, from the affinity mask the process
    had before ``run.py`` pinned itself (``cores``, sorted).  The first
    core takes the host's interrupts.  Rank 0 keeps ``run.py``'s pin,
    ``cores[1:3]``; rank r gets ``cores[1 + 2r:3 + 2r]``.  With fewer than
    2n + 1 cores the other ranks split the cores after rank 0's among them,
    one rank to a core or more, and share them where there are fewer cores
    than ranks (rank 0's, where there are none)."""
    cores = list(cores)
    first = cores[1:3] if len(cores) > 2 else cores
    if n == 1:
        return [first]
    if len(cores) >= 2 * n + 1:
        return [cores[1 + 2 * r:3 + 2 * r] for r in range(n)]
    rest, m = cores[3:] or first, n - 1
    if len(rest) >= m:
        return [first] + [rest[r * len(rest) // m:(r + 1) * len(rest) // m]
                          for r in range(m)]
    return [first] + [[rest[r % len(rest)]] for r in range(m)]


def fullest(peaks) -> int | None:
    """The largest of the cards' peaks; None where no card was read."""
    read = [p for p in peaks if p is not None]
    return max(read) if read else None


def describe(dev) -> str:
    import torch
    if dev.type != "cuda":
        return str(dev)
    return f"{dev} ({torch.cuda.get_device_name(dev)})"


class Deadline:
    """Ends this process, with every thread's stack on stderr, when no step
    of the lockstep comes for ``timeout_s`` (``faulthandler``'s timer).
    ``step`` re-arms the timer at most once in ``REARM_S``, so that a step
    costs a clock read and no thread is started in the window."""

    def __init__(self, timeout_s: float):
        self.timeout_s, self.at = timeout_s, None
        self.step()

    def step(self) -> None:
        now = time.monotonic()
        if self.at is None or now - self.at >= REARM_S:
            faulthandler.dump_traceback_later(self.timeout_s, exit=True)
            self.at = now

    @staticmethod
    def cancel() -> None:
        faulthandler.cancel_dump_traceback_later()


def _init_group(backend: str, store: str, rank: int, n: int, timeout_s):
    import torch.distributed as dist
    dist.init_process_group(
        backend, store=dist.FileStore(store, n), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s + PG_MARGIN_S))


def _rank_main(rank: int, job: dict) -> None:
    """Rank ``rank``'s process: the cell's loop in lockstep with rank 0,
    then its report.  An exception ends the process with its traceback."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL)    # die with rank 0
    if os.getppid() != job["parent"]:               # rank 0 died before it
        os._exit(1)
    deadline = Deadline(job["timeout_s"])
    os.sched_setaffinity(0, job["cores"][rank])
    os.dup2(2, 1)               # standard output holds rank 0's result alone

    import torch
    import torch.distributed as dist

    from . import cell as cells
    from .trace import Spans, sync
    dev = torch.device(job["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _init_group(job["backend"], job["store"], rank, job["n"],
                job["timeout_s"])
    print(f"t3bench: rank {rank} on {describe(dev)}, cores "
          f"{sorted(os.sched_getaffinity(0))}", file=sys.stderr, flush=True)
    bd = job["bench_dir"]
    cell = cells.load_cell(bd, job["name"])
    loop = cells.load_loop(bd, cell["loop"]).Loop(
        cells.load_config(bd, cell["config"]), cell["params"], job["seed"],
        dev, Spans(dev, enabled=False), control=job["control"])
    loop.warm()
    sync(dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    i = 0
    while True:
        dist.broadcast(flag, 0)
        if not int(flag.item()):
            break
        deadline.step()
        loop.request(i)
        sync(dev)
        i += 1
    deadline.step()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    loop.release()
    report = {"peak": peak, "modules": loaded_forbidden(), "requests": i,
              "tally": loop.tally() if hasattr(loop, "tally") else None}
    del loop
    dist.gather_object(report, None, dst=0)
    dist.destroy_process_group()
    deadline.cancel()


class World:
    """Ranks 1 to n-1 of a cell, and rank 0's side of their process group.

    ``cores`` is the affinity mask the process had before ``run.py``
    pinned itself.  The constructor starts the ranks and creates the
    process group; ``go`` lets every rank run one request, ``stop`` ends
    the window, ``reports`` gathers every rank's report, and ``close``
    leaves the group and waits until every rank has ended."""

    def __init__(self, bench_dir: str, name: str, seed: int, control: bool,
                 n: int, dev, cores, timeout_s: float = TIMEOUT_S):
        import torch
        cores = sorted(cores)
        plan = plan_cores(cores, n)
        if len(cores) < 2 * n + 1:
            print(f"t3bench: {len(cores)} cores for {n} ranks, fewer than "
                  f"{2 * n + 1}: ranks spread over them as {plan}",
                  file=sys.stderr, flush=True)
        self.n = n
        self.backend = "nccl" if dev.type == "cuda" else "gloo"
        self.tmp = tempfile.mkdtemp(prefix="t3bench-ranks-")
        store = os.path.join(self.tmp, "store")
        job = {"bench_dir": bench_dir, "name": name, "seed": seed,
               "control": control, "n": n, "backend": self.backend,
               "devices": [str(dev) if dev.type != "cuda" else f"cuda:{r}"
                           for r in range(n)],
               "store": store, "timeout_s": timeout_s, "cores": plan,
               "parent": os.getpid()}
        self.procs = []
        self.clean = False      # every rank has reported
        self._closed = False
        self.deadline = Deadline(timeout_s)
        ctx = mp.get_context("spawn")
        try:
            for r in range(1, n):
                p = ctx.Process(target=_rank_main, args=(r, job),
                                name=f"t3bench-rank-{r}", daemon=True)
                p.start()
                try:                # before it imports much: its threads
                    os.sched_setaffinity(p.pid, plan[r])    # inherit it
                except OSError:
                    pass
                self.procs.append(p)
            print(f"t3bench: rank 0 on {describe(dev)}, cores "
                  f"{sorted(os.sched_getaffinity(0))}", file=sys.stderr,
                  flush=True)
            _init_group(self.backend, store, 0, n, timeout_s)
            self._go = torch.ones(1, dtype=torch.int32, device=dev)
            self._stop = torch.zeros(1, dtype=torch.int32, device=dev)
        except BaseException:
            self.close()
            raise

    def go(self) -> None:
        """Let every rank run the next request (one int broadcast)."""
        import torch.distributed as dist
        self.deadline.step()
        dist.broadcast(self._go, 0)

    def stop(self) -> None:
        """End the ranks' loop."""
        import torch.distributed as dist
        self.deadline.step()
        dist.broadcast(self._stop, 0)

    def reports(self, mine: dict) -> dict:
        """Every rank's report, rank 0's (``mine``) included: {rank:
        {"peak", "modules", "requests", "tally"}}."""
        import torch.distributed as dist
        out = [None] * self.n
        dist.gather_object(mine, out, dst=0)
        self.clean = True
        return dict(enumerate(out))

    def close(self) -> None:
        """Leave the process group and wait until every rank has ended;
        where a rank has not reported, stop them all first.  After a
        failure on the cards the process ends here, since an NCCL group
        with a collective left open cannot be destroyed."""
        if self._closed:
            return
        self._closed = True
        import torch.distributed as dist
        if not self.clean:
            self._kill()
            if dist.is_initialized() and self.backend == "nccl":
                shutil.rmtree(self.tmp, ignore_errors=True)
                print("t3bench: a rank failed; the run ends here",
                      file=sys.stderr, flush=True)
                os._exit(1)
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            p.join(JOIN_S)
        self._kill()
        self.deadline.cancel()
        shutil.rmtree(self.tmp, ignore_errors=True)
        _stop_resource_tracker()

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)


def _stop_resource_tracker() -> None:
    """Stop the helper process that the spawn start method starts, so that
    no process of the run outlives it."""
    from multiprocessing import resource_tracker
    tracker = getattr(resource_tracker, "_resource_tracker", None)
    if tracker is not None and hasattr(tracker, "_stop"):
        tracker._stop()
