"""One run of one cell on the CPU in a process of its own, as ``run.py``
runs it on the card (result line, checks, exit code), for the tests of
runs whose ranks fail:

    python -m t3bench.tests.cpu_run <bench_dir> <cell> <seed> <seconds> \\
        <timeout_s>
"""
import sys
import time

if __name__ == "__main__":
    T0 = time.perf_counter()
    import torch

    from t3bench.lib import runner
    from t3bench.tests import tiny
    bench_dir, name, seed, seconds, timeout_s = sys.argv[1:]
    args = runner.parse(["--workload", name, "--seed", seed,
                         "--seconds", seconds])
    sys.exit(runner.report(bench_dir, tiny.benchmark(), args,
                           torch.device("cpu"), T0,
                           timeout_s=float(timeout_s)))
