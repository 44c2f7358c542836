"""ctypes loader/builder for the native host runtime (src/t3native.cpp).

The port's copy of the JAX package's ``runtime/native.py``, with its own
copy of the C++ source.  The shared object is built on first use with the
host's C++ compiler (``$CXX``, default ``g++``) into ``build/t3native/`` at
the repository root, like ``runtime/build.py`` builds the CUDA kernels; the
file name carries a hash of the source and the flags, so an edited source
is rebuilt.  Every entry point that has a pure-Python fallback (``crc32``
falls back to zlib) says so; ``available()`` tells callers whether the
native path is live.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "t3native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "t3native"
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared"]
_ABI = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


@functools.cache
def so_path() -> Path:
    """Where the library is built: ``build/t3native/`` at the repository
    root, named by a hash of the source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"_t3native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    cxx = os.environ.get("CXX", "g++")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp.so"
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = so_path()
        if not so.exists() and not _build(so):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _failed = True
            return None
        lib.t3n_abi_version.restype = ctypes.c_int
        lib.t3n_abi_version.argtypes = []
        if lib.t3n_abi_version() != _ABI:
            _failed = True
            return None
        lib.t3n_crc12_0x80f.restype = ctypes.c_uint16
        lib.t3n_crc12_0x80f.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.t3n_pack_base243.restype = ctypes.c_size_t
        lib.t3n_pack_base243.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                         ctypes.c_void_p, ctypes.c_void_p]
        lib.t3n_unpack_base243.restype = ctypes.c_int
        lib.t3n_unpack_base243.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                           ctypes.c_size_t, ctypes.c_void_p]
        lib.t3n_pack13.restype = None
        lib.t3n_pack13.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_size_t,
                                                           ctypes.c_void_p]
        lib.t3n_unpack13.restype = None
        lib.t3n_unpack13.argtypes = [ctypes.c_void_p, ctypes.c_size_t] + \
            [ctypes.c_void_p] * 3
        lib.t3n_crc32.restype = ctypes.c_uint32
        lib.t3n_crc32.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                  ctypes.c_uint32]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


_heap_warmed = False


def warm_heap() -> bool:
    """Keep big-allocation pages warm across frames (glibc mallopt).

    glibc mmap()s allocations above 128 KB and returns them to the OS on
    free, so a loop that allocates a fresh frame-sized buffer per frame
    (D2H copies, tobytes()) pays a page fault on every page of every
    frame.  mallopt(M_MMAP_MAX=0) + mallopt(M_TRIM_THRESHOLD=max) route
    large mallocs through the sbrk heap and never trim it, so after the
    first frame the pages stay resident.
    """
    global _heap_warmed
    if _heap_warmed:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-4, 0)            # M_MMAP_MAX
        libc.mallopt(-1, 2**31 - 1)    # M_TRIM_THRESHOLD
        _heap_warmed = True
    except OSError:
        return False
    return True


def crc32(data, init: int = 0) -> int:
    """zlib-polynomial CRC-32 via the native PCLMUL-folded kernel (scalar
    slice-by-8 where the CPU has no PCLMUL).  Accepts any contiguous
    buffer.  Falls back to zlib.crc32 when the native library is
    unavailable."""
    lib = _load()
    mv = memoryview(data).cast("B")
    if lib is None:
        import zlib
        return zlib.crc32(mv, init) & 0xFFFFFFFF
    b = np.frombuffer(mv, dtype=np.uint8)
    return int(lib.t3n_crc32(b.ctypes.data, b.size, init & 0xFFFFFFFF))


def crc12_0x80F(data: np.ndarray) -> int:
    lib = _load()
    b = np.ascontiguousarray(np.asarray(data, dtype=np.uint8).reshape(-1))
    return int(lib.t3n_crc12_0x80f(b.ctypes.data, b.size))


def pack_base243(trits: np.ndarray):
    """-> (bytes_u8, tail_trits)."""
    lib = _load()
    t = np.ascontiguousarray(np.asarray(trits, dtype=np.uint8).reshape(-1))
    out = np.empty((t.size + 4) // 5, dtype=np.uint8)
    tail = ctypes.c_uint8(0)
    n = lib.t3n_pack_base243(t.ctypes.data, t.size, out.ctypes.data,
                             ctypes.byref(tail))
    return out[:n], int(tail.value)


def unpack_base243(data: np.ndarray, total_trits: int) -> np.ndarray:
    lib = _load()
    d = np.ascontiguousarray(np.asarray(data, dtype=np.uint8).reshape(-1))
    out = np.empty(total_trits, dtype=np.uint8)
    rc = lib.t3n_unpack_base243(d.ctypes.data, d.size, total_trits,
                                out.ctypes.data)
    if rc != 0:
        raise ValueError("base243 stream too short for total_trits")
    return out.astype(np.int8)


def pack13(yq, cbq, crq) -> np.ndarray:
    lib = _load()
    y = np.ascontiguousarray(np.asarray(yq, dtype=np.int32).reshape(-1))
    cb = np.ascontiguousarray(np.asarray(cbq, dtype=np.int32).reshape(-1))
    cr = np.ascontiguousarray(np.asarray(crq, dtype=np.int32).reshape(-1))
    out = np.empty(y.size, dtype=np.uint32)
    lib.t3n_pack13(y.ctypes.data, cb.ctypes.data, cr.ctypes.data, y.size,
                   out.ctypes.data)
    return out


def unpack13(code) -> np.ndarray:
    lib = _load()
    c = np.ascontiguousarray(np.asarray(code, dtype=np.uint32).reshape(-1))
    y = np.empty(c.size, dtype=np.int32)
    cb = np.empty(c.size, dtype=np.int32)
    cr = np.empty(c.size, dtype=np.int32)
    lib.t3n_unpack13(c.ctypes.data, c.size, y.ctypes.data, cb.ctypes.data,
                     cr.ctypes.data)
    return np.stack([y, cb, cr], axis=-1)
