"""``SuperframeCodec``: one config's superframe codec as an ``nn.Module``.

The codec has no learned parameters; what it carries is the config's
tables (RS maps per k, header words, scramble offsets, gather indices),
registered as buffers on one explicit device.  ``tables_from_reference``
builds the same codec from the tables the JAX package computes, so a codec
can be held against the reference table by table.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from .config import EncoderConfig
from .ops import encode as encode_mod
from .ops import pipeline
from .ops.pipeline import HEADER_WORDS


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` is the current CUDA
    device, and the CPU is used only when the caller passes it.  A CUDA
    device without an index is the current one, so ``"cuda"`` and
    ``"cuda:0"`` name the same device (and share ``codec_for``'s codec).
    Raises when CUDA is asked for (or left as the default) and there is
    none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the port "
            "runs on the card by default; pass device='cpu' to run it on "
            "the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class SuperframeCodec(nn.Module):
    """Encoder and decoder of one ``EncoderConfig``'s superframe stream.

    ``device`` defaults to the current CUDA device (see ``resolve_device``).
    ``ref`` holds the reference tables (``pipeline.reference_inputs``
    layout); by default they are derived here."""

    def __init__(self, cfg: EncoderConfig, device=None, ref: dict | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layout, self.dlayout = pipeline.stream_layouts(cfg)
        tables = pipeline.derive_tables(
            cfg, ref if ref is not None else pipeline.reference_inputs(cfg))
        for name, arr in tables.items():
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(arr), device=dev))

    @property
    def device(self) -> torch.device:
        return self.header_words.device

    def tables(self) -> dict:
        return dict(self.named_buffers())

    def encode(self, chunks: torch.Tensor, sf_batch: int = 64) -> torch.Tensor:
        """RAW chunks (n_sf, superframe_words, 9) -> wire planes
        (n_sf, 9, 6 + H), ``sf_batch`` superframes at a time."""
        T = self.tables()
        chunks = chunks.to(self.device, torch.int8)
        return torch.cat([encode_mod.encode_superframes(c, self.layout, T)
                          for c in chunks.split(sf_batch)])

    def check(self, words_T: torch.Tensor, sf_batch: int = 64):
        """Check decode of wire planes (n, 9, 6 + H) -> (RAW planes
        (n, 9, n_out), ok (n,)), headers byte-compared.  On the card one K1
        launch covers every superframe."""
        T = self.tables()
        body = words_T[:, :, HEADER_WORDS:]
        if body.device.type == "cuda":
            raw, ok = pipeline.check_body(body, self.dlayout, T)
        else:
            parts = [pipeline.check_body(b, self.dlayout, T)
                     for b in body.split(sf_batch)]
            raw = torch.cat([p[0] for p in parts])
            ok = torch.cat([p[1] for p in parts])
        hdr_ok = pipeline.header_validator(T, "check")(
            words_T[:, :, :HEADER_WORDS])
        return raw, ok & hdr_ok

    def paged(self, words_T: torch.Tensor, sf_batch: int = 64):
        """Paged-repair decode of wire planes -> (RAW planes, ok (n,)),
        headers through the RS(26,18) paged chain."""
        T = self.tables()
        parts = [pipeline.paged_body(b[:, :, HEADER_WORDS:], self.dlayout, T)
                 for b in words_T.split(sf_batch)]
        raw = torch.cat([p[0] for p in parts])
        ok = torch.cat([p[1] for p in parts])
        hdr_ok = pipeline.header_validator(T, "paged", True)(
            words_T[:, :, :HEADER_WORDS])
        return raw, ok & hdr_ok

    def decode(self, words_T: torch.Tensor, strategy: str = "auto",
               repair_cap: int | None = None, sf_batch: int = 64):
        """Wire planes (n_sf, 9, 6 + H) -> (RAW planes (n_sf, 9, n_out),
        ok 0-d bool tensor); strategies as in ``ops/pipeline.py``.  Any
        strides are taken: the planes are made contiguous once here."""
        if repair_cap is not None and repair_cap <= 0:
            raise ValueError(f"repair_cap must be positive, got {repair_cap}")
        words_T = words_T.to(self.device, torch.int8).contiguous()
        if words_T.shape[0] == 0:
            raise ValueError("decode needs at least one superframe")
        if strategy == "check":
            raw, ok_sf = self.check(words_T, sf_batch)
            return raw, ok_sf.all()
        if strategy == "paged":
            raw, ok_sf = self.paged(words_T, sf_batch)
            return raw, ok_sf.all()
        if strategy == "auto":
            raw, ok_sf = self.check(words_T, sf_batch)
            bad = torch.nonzero(~ok_sf).flatten()
            if bad.numel() == 0:
                return raw, ok_sf.all()
            fix, ok_fix = self.paged(words_T[bad], sf_batch)
            raw[bad] = fix
            return raw, ok_fix.all()
        if strategy == "fused":
            cap = sf_batch if repair_cap is None else repair_cap
            raw, ok_sf = self.check(words_T, sf_batch)
            nbad = (~ok_sf).sum()
            # stable ascending sort of the flags: flagged superframes first,
            # in stream order; the window clamps to n_sf when cap > n_sf
            order = torch.argsort(ok_sf.to(torch.uint8), stable=True)
            idx = order[:cap]
            fix, ok_fix = self.paged(words_T[idx], cap)
            raw[idx] = fix
            # padding slots are clean superframes (their repair is ok);
            # more flagged superframes than the window fails safe
            return raw, ok_fix.all() & (nbad <= idx.numel())
        if strategy in ("full", "none"):
            raise NotImplementedError(f"strategy {strategy!r} is not ported yet")
        raise ValueError(f"unknown decode strategy {strategy!r}")

    def roundtrip(self, chunks: torch.Tensor, rs_mode: str = "check",
                  fold=None, sf_batch: int = 64):
        """Encode then decode ``sf_batch`` superframes at a time:
        chunks (n_sf, superframe_words, 9) -> (RAW planes (n_sf, 9, n_out)
        or the ``fold`` of each micro-batch, ok (n_sf,))."""
        if rs_mode not in ("check", "paged"):
            raise NotImplementedError(f"rs_mode {rs_mode!r} is not ported yet")
        T = self.tables()
        body_fn = pipeline.check_body if rs_mode == "check" else \
            pipeline.paged_body
        outs, oks, hdrs = [], [], []
        for c in chunks.to(self.device, torch.int8).split(sf_batch):
            w = encode_mod.encode_superframes(c, self.layout, T)
            out, ok = body_fn(w[:, :, HEADER_WORDS:], self.dlayout, T)
            outs.append(out if fold is None else fold(out))
            oks.append(ok)
            hdrs.append(w[:, :, :HEADER_WORDS])
        ok = torch.cat(oks) & pipeline.header_validator(T, rs_mode)(
            torch.cat(hdrs))
        return torch.cat(outs), ok


def codec_for(cfg: EncoderConfig, device=None) -> SuperframeCodec:
    """The (cached) codec of ``cfg`` on ``device`` (default: the current
    CUDA device; raises without one)."""
    return _codec_for(cfg, resolve_device(device))


@functools.cache
def _codec_for(cfg: EncoderConfig, device: torch.device) -> SuperframeCodec:
    return SuperframeCodec(cfg, device)


def tables_from_reference(np_tables: dict, cfg: EncoderConfig,
                          device=None) -> SuperframeCodec:
    """A codec built from the tables the JAX package computes, as numpy:
    ``rs_pm`` {k: rs._matrices_pm(k)} for the config's k values and 18,
    ``header_words`` (layout.header_words), ``off_enc``/``off_dec``
    (np.asarray(pipeline._pm_offsets(H, seed, +1 / -1))) and
    ``unpack702_bw`` (pipeline._unpack702_bw()).  ``device`` as for
    ``SuperframeCodec``."""
    return SuperframeCodec(cfg, device, ref=np_tables)
