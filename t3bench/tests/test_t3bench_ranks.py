"""The ranks of a cell on several chips (``lib/ranks.py``): the cores each
rank is pinned to, the lockstep of their requests, the fullest card's
peak, and the end of a run whose rank raises, hangs or loads a forbidden
module, with no process left behind.  The ranks run on the CPU with gloo;
the last test runs the four-card cell on four cards."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from t3bench.lib import ranks, runner
from t3bench.tests import tiny

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
PROBE = "p2_8k_luma.probe"


def pin_of_run_py(cores):
    return cores[1:3] if len(cores) > 2 else cores


@pytest.mark.parametrize("n_cores", [1, 2, 3, 8, 32])
def test_one_chip_keeps_run_py_pin(n_cores):
    cores = list(range(n_cores))
    assert ranks.plan_cores(cores, 1) == [pin_of_run_py(cores)]


@pytest.mark.parametrize("n", [2, 4])
def test_chips_get_disjoint_pairs(n):
    cores = list(range(100, 100 + 2 * n + 1))
    plan = ranks.plan_cores(cores, n)
    assert plan[0] == pin_of_run_py(cores)
    assert all(len(p) == 2 for p in plan)
    flat = [c for p in plan for c in p]
    assert len(set(flat)) == len(flat) and cores[0] not in flat


@pytest.mark.parametrize("n_cores,shared", [(8, False), (6, False),
                                            (4, True), (2, True), (1, True)])
def test_short_mask_spreads_the_ranks(n_cores, shared):
    cores = list(range(n_cores))
    plan = ranks.plan_cores(cores, 4)
    assert len(plan) == 4 and all(plan)
    assert plan[0] == pin_of_run_py(cores)
    assert all(set(p) <= set(cores) for p in plan)
    flat = [c for p in plan for c in p]
    assert (len(set(flat)) < len(flat)) == shared


def test_fullest_card():
    assert ranks.fullest([3, None, 7, 5]) == 7
    assert ranks.fullest([None, None]) is None


def probe_copy(tmp_path, fault=None):
    """A tiny copy of the benchmark with a two-rank cell of the probe loop;
    (bench dir, log dir)."""
    bd = tiny.copy(tmp_path)
    log = os.path.join(str(tmp_path), "log")
    os.mkdir(log)
    shutil.copy(os.path.join(HERE, "probe_loop.py"),
                os.path.join(bd, "loops", "probe.py"))
    cell = {"config": "p2_8k_luma", "traffic": "probe", "loop": "probe",
            "chips": 2, "why": "the harness's ranks",
            "params": {"log": log, "fault": fault,
                       "check": {"sample": 1, "among": 2},
                       "trace": {"skip": 1, "requests": 1}}}
    with open(os.path.join(bd, "workloads", PROBE + ".json"), "w") as f:
        json.dump(cell, f)
    return bd, log


def pids(log):
    out = []
    for name in os.listdir(log):
        if name.startswith("pid"):
            with open(os.path.join(log, name)) as f:
                out.append(int(f.read()))
    return out


def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_two_ranks_run_in_lockstep(tmp_path):
    bd, log = probe_copy(tmp_path)
    out = runner.run_cell(bd, tiny.benchmark(), PROBE, 11, 0.5, False, CPU,
                          time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2
    ran = []
    for r in range(2):
        with open(os.path.join(log, f"ran{r}")) as f:
            ran.append(f.read().split())
    assert ran[0] == ran[1] == [str(i) for i in range(out["attempted"])]
    with open(os.path.join(log, "pid1")) as f:
        assert not alive(int(f.read()))
    assert not torch.distributed.is_initialized()


def test_one_chip_cell_starts_no_rank(tmp_path, monkeypatch):
    def no_world(*a, **k):
        raise AssertionError("a one-chip cell started ranks")
    monkeypatch.setattr(ranks, "World", no_world)
    out = runner.run_cell(tiny.copy(tmp_path), tiny.benchmark(),
                          tiny.CELLS[0], 12, 0.2, False, CPU,
                          time.perf_counter())
    assert out["correct"] and out["device"]["count"] == 1


def test_split_judges_every_rank_wire_padding_included(tmp_path):
    """9 superframes over 2 ranks: rank 1's share ends in a superframe of
    zeros that the split pads in, and its wire is judged too."""
    bd = tiny.copy(tmp_path)
    p = os.path.join(bd, "configs", "p2_8k_luma.json")
    with open(p) as f:
        cfg = json.load(f)
    cfg["frame"]["height"] = 72                 # 4,608 words: 9 superframes
    with open(p, "w") as f:
        json.dump(cfg, f)
    name = "p2_8k_luma.sfdp4_rt"
    out = runner.run_cell(bd, tiny.benchmark(), name, 14, 0.5, False, CPU,
                          time.perf_counter())
    assert out["correct"], out["checks"]
    judged = out["checks"]["wire_superframes_judged"]
    assert judged["value"] >= 10 and judged["value"] % 10 == 0


def run_apart(bd, timeout_s):
    """The probe cell in a process of its own: (exit code, stderr, s)."""
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "t3bench.tests.cpu_run", bd, PROBE, "13",
         "0.5", str(timeout_s)], cwd=tiny.ROOT, capture_output=True,
        text=True, timeout=240)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t


def test_raising_rank_ends_the_run(tmp_path):
    bd, log = probe_copy(tmp_path, {"rank": 1, "at": 2, "how": "raise"})
    rc, out, err, _ = run_apart(bd, 120)
    assert rc != 0 and out == ""
    assert "t3bench-rank-1" in err and "planted fault in rank 1" in err
    assert len(pids(log)) == 2 and not any(map(alive, pids(log)))


def test_hanging_rank_ends_the_run_by_the_timeout(tmp_path):
    bd, log = probe_copy(tmp_path, {"rank": 1, "at": 2, "how": "hang"})
    timeout_s = 20
    rc, out, err, s = run_apart(bd, timeout_s)
    assert rc != 0 and out == ""
    # the stacks that faulthandler prints name where the rank waited
    assert "Timeout" in err and "in request" in err, err[-2000:]
    assert s < timeout_s + 60
    assert len(pids(log)) == 2 and not any(map(alive, pids(log)))


def test_forbidden_module_in_a_rank_exits_3(tmp_path):
    bd, log = probe_copy(tmp_path, {"rank": 1, "at": 0, "how": "import"})
    rc, out, err, _ = run_apart(bd, 120)
    assert rc == 3 and out == ""
    assert "{1: ['jax']}" in err
    assert not any(map(alive, pids(log)))


@pytest.mark.cuda
def test_four_card_cell_on_cards(cuda_device):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    name = "p2_8k_luma.sfdp4_rt"
    out = runner.run_cell(tiny.BENCH, tiny.benchmark(), name, 3_000_000_201,
                          2, False, cuda_device, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    assert out["device"]["memory_peak_bytes"] > 0
