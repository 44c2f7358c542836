"""A copy of the benchmark folder with its cells cut to a size the CPU
runs in a second, for the benchmark's own tests."""
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
CELLS = ("p2_8k_luma.rt_clean", "p2_8k_luma.rx_dirty5",
         "p5_8k_beacon.rx_dirty1", "p2_8k_luma.sfdp4_rt")
CPU_RANKS = 2           # ranks of a cell of several chips, with gloo


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def shrink_config(cfg: dict) -> dict:
    """The configuration at 8 superframes of 512 words."""
    return dict(cfg, frame={"width": 128, "height": 64, "px_per_word": 2},
                superframe_words=512)


def copy(tmp_path) -> str:
    """A copy of the benchmark folder whose cells run on tiny frames, those
    of several chips on ``CPU_RANKS`` ranks."""
    bd = os.path.join(str(tmp_path), "t3bench")
    shutil.copytree(BENCH, bd, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name in os.listdir(os.path.join(bd, "configs")):
        p = os.path.join(bd, "configs", name)
        with open(p) as f:
            cfg = shrink_config(json.load(f))
        with open(p, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bd, "workloads")):
        p = os.path.join(bd, "workloads", name)
        with open(p) as f:
            cell = json.load(f)
        prm = cell["params"]
        if "damage" in prm:
            prm["damage"]["D"] = 2
            prm["repair_cap"] = 2 * prm["frames_per_request"]
        prm["check"]["among"] = 4
        prm["trace"] = {"skip": 1, "requests": 2}
        cell["chips"] = min(cell["chips"], CPU_RANKS)
        with open(p, "w") as f:
            json.dump(cell, f)
    return bd
