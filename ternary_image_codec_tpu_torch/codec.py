"""``SuperframeCodec``: one config's superframe codec as an ``nn.Module``.

``encode_rgb`` and ``decode_rgb`` carry one 8-bit RGB frame through the
word9 bridges (2 pixels a word, ``ops/wordcodec.py``) around ``encode``
and ``decode``.

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
from .ops import pipeline, wordcodec
from .ops.pipeline import HEADER_WORDS
from .runtime import tracing


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
    layout); by default they are derived here.  The superframe holds
    ``n_raw_words`` RAW words (``pipeline.stream_layouts``): the profile
    API builds a codec per frame length and writes each frame's number
    into the header words itself."""

    def __init__(self, cfg: EncoderConfig, device=None, ref: dict | None = None,
                 n_raw_words: int | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.layout, self.dlayout = pipeline.stream_layouts(cfg, n_raw_words)
        tables = pipeline.derive_tables(
            cfg, ref if ref is not None
            else pipeline.reference_inputs(cfg, n_raw_words), n_raw_words)
        for name, arr in tables.items():
            self.register_buffer(
                name, torch.as_tensor(np.ascontiguousarray(arr), device=dev))

    @property
    def device(self) -> torch.device:
        return self.header_words.device

    def tables(self) -> dict:
        return dict(self.named_buffers())

    def encode(self, chunks: torch.Tensor, sf_batch: int = 64) -> torch.Tensor:
        """RAW chunks (n_sf, n_raw_words, 9) -> wire planes
        (n_sf, 9, 6 + H).  On the card one K3 launch takes every
        superframe; on the CPU the twin goes ``sf_batch`` superframes at a
        time, which bounds its memory."""
        T = self.tables()
        with tracing.span("t3.encode"):
            chunks = chunks.to(self.device, torch.int8)
            if chunks.device.type == "cuda":
                return encode_mod.encode_superframes(chunks, self.layout, T)
            parts = []
            for c in chunks.split(sf_batch):
                with tracing.span("t3.encode.batch"):
                    parts.append(
                        encode_mod.encode_superframes(c, self.layout, T))
            with tracing.span("t3.encode.join"):
                return torch.cat(parts)

    def decode_planes(self, words_T: torch.Tensor, rs_mode: str = "check",
                      sf_batch: int = 64):
        """One body decode of wire planes (n, 9, 6 + H) -> (RAW planes
        (n, 9, n_out), ok (n,)) per superframe; ``rs_mode`` as the
        strategies check, paged, full, none.  Headers are byte-compared
        under check and go through the RS(26,18) paged chain, every page
        covered, otherwise.  On the card check, none (one K1 launch, or
        the plain grid check of a layout no K1 specialisation covers) and full (one
        K2 launch per group of bands) take every superframe at once;
        everything else goes ``sf_batch`` superframes at a time."""
        T = self.tables()
        body_fn = pipeline.body_decoder(rs_mode)
        body = words_T[:, :, HEADER_WORDS:]
        if body.device.type == "cuda" and rs_mode != "paged":
            raw, ok = body_fn(body, self.dlayout, T)
        else:
            parts = [body_fn(b, self.dlayout, T) for b in body.split(sf_batch)]
            raw = torch.cat([p[0] for p in parts])
            ok = torch.cat([p[1] for p in parts])
        hdr_ok = pipeline.header_validator(T, rs_mode, rs_mode != "check")(
            words_T[:, :, :HEADER_WORDS])
        return raw, ok & hdr_ok

    def check(self, words_T: torch.Tensor, sf_batch: int = 64):
        """``decode_planes`` under check."""
        return self.decode_planes(words_T, "check", sf_batch)

    def paged(self, words_T: torch.Tensor, sf_batch: int = 64):
        """``decode_planes`` under paged repair."""
        return self.decode_planes(words_T, "paged", sf_batch)

    def decode(self, words_T: torch.Tensor, strategy: str = "auto",
               repair_cap: int | None = None, sf_batch: int = 64):
        """Wire planes (n_sf, 9, 6 + H) -> (RAW planes (n_sf, 9, n_out),
        ok 0-d bool tensor); strategies as in ``ops/pipeline.py``.  Any
        strides are taken: the planes are made contiguous once here."""
        if repair_cap is not None and repair_cap <= 0:
            raise ValueError(f"repair_cap must be positive, got {repair_cap}")
        with tracing.span("t3.decode"):
            if strategy == "fused":
                raw, ok = self.decode_frames(words_T[None], repair_cap,
                                             sf_batch)
                return raw[0], ok
            words_T = words_T.to(self.device, torch.int8).contiguous()
            if words_T.shape[0] == 0:
                raise ValueError("decode needs at least one superframe")
            if strategy in pipeline.BODY_DECODERS:
                raw, ok_sf = self.decode_planes(words_T, strategy, sf_batch)
                return raw, ok_sf.all()
            if strategy == "auto":
                raw, ok_sf = self.check(words_T, sf_batch)
                # the host waits here for the check's flags
                with tracing.span("t3.sync.auto"):
                    bad = torch.nonzero(~ok_sf).flatten()
                if bad.numel() == 0:
                    return raw, ok_sf.all()
                fix, ok_fix = self.paged(words_T[bad], sf_batch)
                raw[bad] = fix
                return raw, ok_fix.all()
        raise ValueError(f"unknown decode strategy {strategy!r}")

    def _rgb_words(self, h: int, w: int):
        """(pixels, word9 words, superframes) of an h x w frame."""
        n_px = h * w
        n_words = -(-n_px // 2)
        if n_words == 0:
            raise ValueError("an RGB frame needs at least one pixel")
        return n_px, n_words, -(-n_words // self.layout.n_raw_words)

    def encode_rgb(self, rgb: torch.Tensor) -> torch.Tensor:
        """One 8-bit RGB frame (H, W, 3) uint8, interleaved -> wire planes
        (n_sf, 9, 6 + H_body) of its word9 words.

        ``wordcodec.ingest9`` writes the words of the whole frame, word j
        holding pixels 2j and 2j + 1 in raster order (an odd last pixel
        paired as ``quant_to_words9`` pairs it), straight into the
        superframes that ``encode`` takes (one K3 launch on the card); the
        last superframe is zero-padded.  The frame moves to the codec's
        device first."""
        if rgb.dim() != 3 or rgb.shape[-1] != 3 or rgb.dtype != torch.uint8:
            raise ValueError("encode_rgb needs an (H, W, 3) uint8 frame, got "
                             f"{tuple(rgb.shape)} {rgb.dtype}")
        with tracing.span("t3.encode_rgb"):
            rgb = rgb.to(self.device)
            n_px, n_words, n_sf = self._rgb_words(*rgb.shape[:2])
            sfw = self.layout.n_raw_words
            chunks = torch.empty((n_sf * sfw, 9), dtype=torch.int8,
                                 device=self.device)
            chunks[n_words:] = 0
            with tracing.span("t3.ingest"):
                wordcodec.ingest9(rgb, out=chunks[:n_words])
            tracing.count("t3.pixels", n_px)
            return self.encode(chunks.view(n_sf, sfw, 9))

    def decode_rgb(self, words_T: torch.Tensor, strategy: str = "auto", *,
                   size: tuple):
        """Wire planes of one RGB frame (n_sf, 9, 6 + H_body) -> (RGB
        (H, W, 3) uint8, ok 0-d bool tensor): ``decode(words_T,
        strategy)``, then ``wordcodec.egress9`` of the whole frame's words,
        the padding dropped.  ``size`` is the frame's (H, W), which the
        wire does not carry."""
        h, w = size
        n_px, _, n_sf = self._rgb_words(h, w)
        if words_T.shape[0] != n_sf:
            raise ValueError(f"a {h}x{w} frame is {n_sf} superframes, got "
                             f"{words_T.shape[0]}")
        with tracing.span("t3.decode_rgb"):
            raw, ok = self.decode(words_T, strategy)
            with tracing.span("t3.egress"):
                rgb = wordcodec.egress9(raw[:, :, :self.layout.n_raw_words])
            tracing.count("t3.pixels", n_px)
            return rgb.view(-1, 3)[:n_px].view(h, w, 3), ok

    def decode_frames(self, words_T: torch.Tensor,
                      repair_cap: int | None = None, sf_batch: int = 64):
        """The fused decode of F frames: wire planes (F, n_sf, 9, 6 + H)
        -> (RAW planes (F, n_sf, 9, n_out), ok 0-d bool tensor).

        A check over all F * n_sf superframes, then a stable argsort of the
        flattened flags puts the flagged superframes first, in stream
        order; the paged corrector runs on a window of the first
        ``repair_cap`` (default ``sf_batch``; the window clamps to
        F * n_sf), gathered and scattered back with (frame, superframe)
        indices.  Padding slots are clean superframes, whose repair is ok;
        more flagged superframes than the window fails safe.  No host
        round trip."""
        if repair_cap is not None and repair_cap <= 0:
            raise ValueError(f"repair_cap must be positive, got {repair_cap}")
        with tracing.span("t3.decode_frames"):
            words_T = words_T.to(self.device, torch.int8).contiguous()
            if words_T.dim() != 4 or words_T.shape[2] != 9:
                raise ValueError("decode_frames needs wire planes (F, n_sf, "
                                 f"9, total), got {tuple(words_T.shape)}")
            F, n_sf = words_T.shape[:2]
            if F * n_sf == 0:
                raise ValueError("decode needs at least one superframe")
            cap = sf_batch if repair_cap is None else repair_cap
            raw, ok_sf = self.check(words_T.flatten(0, 1), sf_batch)
            raw = raw.view(F, n_sf, *raw.shape[1:])
            with tracing.span("t3.repair"):
                nbad = (~ok_sf).sum()
                order = torch.argsort(ok_sf.to(torch.uint8), stable=True)
                idx = order[:cap]
                fi, fj = idx // n_sf, idx % n_sf
                fix, ok_fix = self.paged(words_T[fi, fj], cap)
                raw[fi, fj] = fix
            return raw, ok_fix.all() & (nbad <= idx.numel())

    def roundtrip(self, chunks, rs_mode: str = "check", fold=None,
                  sf_batch: int = 64, raw_wire: str = "words", feed=None):
        """Encode then decode ``sf_batch`` superframes at a time:
        chunks (n_sf, n_raw_words, 9), or (n_sf, 9, n_raw_words) planes
        when ``raw_wire="planes"`` -> (RAW planes (n_sf, 9, n_out) or the
        ``fold`` of each micro-batch, ok (n_sf,)).  With ``feed=(src,
        make)``, ``chunks`` is a tuple of per-superframe row tensors and a
        micro-batch's chunks are ``make(src, *its rows)``
        (``pipeline.roundtrip_stream``)."""
        if raw_wire not in ("words", "planes"):
            raise ValueError(f"raw_wire must be 'words' or 'planes', got "
                             f"{raw_wire!r}")
        body_fn = pipeline.body_decoder(rs_mode)
        T = self.tables()
        if feed is None:
            batches = chunks.split(sf_batch)
        else:
            src, make = feed
            batches = (make(src, *rows) for rows in
                       zip(*(a.split(sf_batch) for a in chunks)))
        outs, oks, hdrs = [], [], []
        for c in batches:
            c = c.to(self.device, torch.int8)
            if raw_wire == "planes":
                c = c.transpose(1, 2)
            w = encode_mod.encode_superframes(c, self.layout, T)
            out, ok = body_fn(w[:, :, HEADER_WORDS:], self.dlayout, T)
            outs.append(out if fold is None else fold(out))
            oks.append(ok)
            hdrs.append(w[:, :, :HEADER_WORDS])
        ok = torch.cat(oks) & pipeline.header_validator(T, rs_mode)(
            torch.cat(hdrs))
        return torch.cat(outs), ok


def codec_for(cfg: EncoderConfig, device=None,
              n_raw_words: int | None = None) -> SuperframeCodec:
    """The (cached) codec of ``cfg`` on ``device`` (default: the current
    CUDA device; raises without one), for superframes of ``n_raw_words``
    RAW words (``pipeline.stream_layouts``; None is
    ``cfg.superframe_words``, one codec for both)."""
    return _codec_for(cfg, resolve_device(device),
                      cfg.superframe_words if n_raw_words is None
                      else n_raw_words)


@functools.lru_cache(maxsize=16)
def _codec_for(cfg: EncoderConfig, device: torch.device,
               n_raw_words: int | None) -> SuperframeCodec:
    return SuperframeCodec(cfg, device, n_raw_words=n_raw_words)


def tables_from_reference(np_tables: dict, cfg: EncoderConfig, device=None,
                          n_raw_words: int | None = None) -> SuperframeCodec:
    """A codec built from the tables the JAX package computes, as numpy:
    ``rs_pm`` {k: rs._matrices_pm(k)} for the config's k values and 18,
    ``header_words`` (layout.header_words), ``off_enc``/``off_dec``
    (np.asarray(pipeline._pm_offsets(H, seed, +1 / -1))) and
    ``unpack702_bw`` (pipeline._unpack702_bw()), of the layout
    ``build_encode_layout(cfg, n_raw_words)`` (``n_raw_words`` defaults to
    ``cfg.superframe_words``).  ``device`` as for ``SuperframeCodec``."""
    return SuperframeCodec(cfg, device, ref=np_tables, n_raw_words=n_raw_words)
