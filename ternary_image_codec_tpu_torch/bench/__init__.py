"""Measurement entry points of the PyTorch port (the JAX package's
``bench.py``, ``tools/rs_bench.py``, ``tools/full_mode_bench.py`` and
``tools/serve_bench.py``).  Each module runs as ``python -m
ternary_image_codec_tpu_torch.bench.<name>``, takes ``--device`` (default:
the current CUDA device; without a card a tool raises unless given
``--device cpu``), holds its own exactness checks and prints one JSON line
last.  A failed check makes ``main`` return 1 (the process exits 1) and
print no JSON."""


import contextlib


class BenchFailure(Exception):
    """An exactness check of a benchmark leg failed."""


def require(cond, msg: str) -> None:
    if not cond:
        raise BenchFailure(msg)


def run_main(run, argv, **kw) -> int:
    """``run(argv, **kw)`` -> the tool's result dict, printed as the last
    line; 0, or 1 (with the failure on stderr and no JSON) when a check
    failed."""
    import json
    import sys
    try:
        out = run(argv, **kw)
    except BenchFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


@contextlib.contextmanager
def peak_bytes(into: dict, key: str, dev):
    """``into[key]``: on a card, the most device memory allocated during
    the block (its peak counter reset on entry, so what was allocated
    before and stays counts too); None on the CPU."""
    import torch
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    yield
    into[key] = torch.cuda.max_memory_allocated(dev) if cuda else None
