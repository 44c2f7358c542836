"""The port's benchmark: one run of one cell.

    python3 t3bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``) as one JSON object, the last line of standard
output.  Everything a cell is made of is found by name under this folder:
``workloads/<cell>.json``, ``configs/<config>.json``,
``loops/<loop>.py``, ``metrics/<metric>.py`` and
``rooflines/<kernel>.json``; ``BENCHMARK.json`` beside this folder says
which metrics the cell reports.
"""
import time

T0 = time.perf_counter()        # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed place inside the checkout
CACHE = os.path.join(ROOT, "build", "t3bench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
# The program's host path is one Python thread that feeds the card: keep
# the run on two fixed cores of those it may use, past the first (which
# takes the host's interrupts), so that it neither moves between cores
# nor shares one with them.  The other ranks of a cell on several cards
# take pairs of the cores after these (lib/ranks.py), from the mask the
# process had before this pin.
_cores = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, _cores[1:3] if len(_cores) > 2 else _cores)
if sys.path[0] == HERE:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

from t3bench.lib import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T0, ROOT, _cores))
