"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/t3_kernels/lib<name>-<hash>.so <name>.cu

into ``build/t3_kernels/`` at the repository root; the file name carries a
hash of the sources, so an edited kernel is rebuilt.  Every C entry point
takes its pointers and, last, the stream as ``void*`` and returns
``cudaGetLastError()`` after the launch.  ``launch`` is the one place a
kernel runs: it passes the device's current stream, raises on a nonzero
code and counts the launch in ``launches``.  A failed build raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "t3_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches in this process by C entry point, its ``t3_`` prefix
# dropped; read as the difference of two snapshots
launches = collections.Counter()

def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str):
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.t3_error_string.restype = ctypes.c_char_p
    lib.t3_error_string.argtypes = [ctypes.c_int]
    return lib


def call(lib: ctypes.CDLL, entry: str, device, *args) -> None:
    """The C entry point ``entry`` of ``lib`` with ``device`` current;
    raises when it returns a nonzero CUDA error code."""
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.t3_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")


def launch(lib: ctypes.CDLL, entry: str, device, *args,
           counter: str | None = None) -> None:
    """One kernel launch: ``call`` with the device's current stream after
    ``args``, counted in ``launches`` and, when given, in the tracing
    counter ``counter``."""
    call(lib, entry, device, *args,
         torch.cuda.current_stream(device).cuda_stream)
    launches[entry.removeprefix("t3_")] += 1
    if counter is not None:
        tracing.count(counter, 1)
