"""A request loop for the tests of the harness's ranks (copied into a test's
copy of the benchmark as ``loops/probe.py``): each request meets every
rank in one all-reduce, and each rank writes its process id and the
requests it ran under ``params["log"]``.  ``params["fault"]`` plants a
fault in one rank at one request: it raises, hangs, or loads a module
named ``jax``."""
from __future__ import annotations

import os
import sys
import time
import types

import torch
import torch.distributed as dist

from t3bench.lib import checks


class Loop:
    frames_per_request = 1

    def __init__(self, cfg, params, seed, dev, spans, control=False):
        self.dev, self.log = dev, params["log"]
        self.fault = params.get("fault") or {}
        self.rank = dist.get_rank()
        self.ran = []
        with open(os.path.join(self.log, f"pid{self.rank}"), "w") as f:
            f.write(str(os.getpid()))

    def request(self, i):
        f = self.fault
        if f.get("rank") == self.rank and f.get("at") == i:
            if f["how"] == "raise":
                raise ValueError(f"planted fault in rank {self.rank}")
            if f["how"] == "hang":
                time.sleep(3600)
            if f["how"] == "import":
                sys.modules["jax"] = types.ModuleType("jax")
        x = torch.ones(1, device=self.dev)
        dist.all_reduce(x)
        self.ran.append(i)
        return {"ok": x[0] == dist.get_world_size()}

    def warm(self):
        pass

    def release(self):
        with open(os.path.join(self.log, f"ran{self.rank}"), "w") as f:
            f.write(" ".join(map(str, self.ran)))

    def judge(self, kept, not_ok, attempted):
        return [checks.at_most("requests_not_ok", not_ok, 0),
                checks.at_least("answers_judged", len(kept), 1)]
