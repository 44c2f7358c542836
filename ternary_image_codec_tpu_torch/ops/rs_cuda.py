"""K2 wrapper: the RS(26,k) correction chain as a hand-written CUDA kernel.

Replaces the JAX package's Pallas kernel ops/rs_pallas.py (``_kernel``,
called by ``decode_dig_fused``); the kernel is csrc/rs_correct.cu and its
plain torch twin is ``rs.correct_pm_ref``.  ``rs.correct_pm`` routes CUDA
tensors here.

The kernel runs one codeword a thread, 64 threads a block.  It is bound
by each codeword's chain of dependent integer work, not by its 145 bytes,
so its design cuts that chain: no per-block table build (blocks copy the
field tables' image), the syndromes and the recheck as dp4a rows of the
packed GF(3) map S2 in place of table reads, and a warp of clean
codewords returns right after its syndromes.  Both constants are compiled
in from csrc/rs_tables.cuh, which ops/rs_tables.py generates.  The launch
costs the host two ``torch.empty`` and a ctypes call: at the main path's
sizes that is most of a call's time (PERF.md).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime import build

_KS = (18, 20, 22, 24)


@functools.cache
def _lib():
    lib = build.load("rs_correct")
    fn = lib.t3_rs_correct
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def rs_correct(recv_pm: torch.Tensor, k: int):
    """K2: (3, 26, B) int8 digits on a CUDA device -> (data (3, k, B)
    int8, ok (B,) bool).  Raises on anything else."""
    if recv_pm.device.type != "cuda":
        raise ValueError(f"rs_correct needs a CUDA tensor, got {recv_pm.device}")
    if recv_pm.dtype != torch.int8:
        raise TypeError(f"rs_correct needs int8 digits, got {recv_pm.dtype}")
    if recv_pm.dim() != 3 or tuple(recv_pm.shape[:2]) != (3, 26):
        raise ValueError(f"rs_correct needs (3, 26, B), got {tuple(recv_pm.shape)}")
    if not recv_pm.is_contiguous():
        raise ValueError("rs_correct needs a contiguous tensor")
    if k not in _KS:
        raise ValueError(f"rs_correct: k must be one of {_KS}, got {k}")
    B = recv_pm.shape[2]
    out = torch.empty((3, k, B), dtype=torch.int8, device=recv_pm.device)
    ok = torch.empty((B,), dtype=torch.bool, device=recv_pm.device)
    if B == 0:
        return out, ok
    build.launch(_lib(), "t3_rs_correct", recv_pm.device, recv_pm.data_ptr(),
                 out.data_ptr(), ok.data_ptr(), B, k,
                 counter="t3.k2.launches")
    return out, ok
