"""The port's counterparts of ``__graft_entry__.py``: the single-device
step and the multi-device dry run.

    fn, (raw,) = entry()            # the current CUDA device
    words = fn(raw)                 # (576868, 9) int8 profile words

``entry(device="cpu")`` runs the step on the CPU.  The step is the
profile encode of one 720p word9 frame (1280x720, 2 px per word:
460,800 RAW words) with the flagship config: P2, luma-priority UEP and a
period-13 beacon in band 4.  ``entry`` builds the codec and its host
tables, so ``fn`` is the step alone.
"""
from __future__ import annotations

import torch

from .codec import codec_for, resolve_device
from .config import (EncoderConfig, ProfileID, SparseBeaconCfg,
                     uep_luma_priority)
from .ops import pipeline
from .parallel.dryrun import dryrun_multichip, make_raw_words

__all__ = ["CFG", "N_RAW", "dryrun_multichip", "entry", "make_raw_words"]

N_RAW = 1280 * 720 // 2  # 2 px per word9
CFG = EncoderConfig(profile=ProfileID.P2_RS26_22, uep=uep_luma_priority(),
                    beacon=SparseBeaconCfg(13, 4, True))


def entry(device=None):
    """(fn, (raw,)): ``raw`` is ``make_raw_words(N_RAW)`` as an int8 tensor
    on ``device`` (default: the current CUDA device; raises without one),
    and ``fn(raw)`` its profile words (6 + H, 9) int8 under ``CFG`` on the
    same device, header included.  Each call of ``fn`` writes a fresh
    output."""
    dev = resolve_device(device)
    codec_for(CFG, dev, N_RAW)          # the host tables, paid once here

    def fn(raw):
        return pipeline.encode_profile_from_raw(raw, CFG, device=dev)

    return fn, (torch.as_tensor(make_raw_words(N_RAW), device=dev),)
