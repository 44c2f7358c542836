"""RGB round trip: one 8-bit RGB frame a request,
``SuperframeCodec.encode_rgb`` then ``decode_rgb(..., "auto")`` on
``codec_for(cfg)``, the program's own defaults: the pixel bridges around
the same encode and decode as the ``rt`` loop.

Parameters: ``distinct_frames`` resident RGB frames (``lib/rgb.py``) that
the requests cycle through.  The judge makes each judged request's frame
again and holds the timed call's answers to the plain references: the
wire planes symbol by symbol against ``reference/codec.py``'s encode of
``reference/pixels.py``'s ingest of the frame, and the RGB value by value
against ``pixels.egress`` of what ``codec.expected_decode`` says a decode
of that wire returns; every request's ok must be True.  The control puts
the references in the program's place computed one precision below the
configuration's: the BT.601 rows in float16 and the quantiser in float32.
"""
from __future__ import annotations

import torch

from t3bench.lib import checks, port, rgb
from t3bench.reference import codec as ref
from t3bench.reference import pixels


LOWER = {"rows": torch.float16, "quant": torch.float32}


class Loop:
    frames_per_request = 1

    def __init__(self, cfg, params, seed, dev, spans, control=False):
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.spans, self.control = spans, control
        self.n = params["distinct_frames"]
        self.size = rgb.frame_size(cfg)
        self.sfw = cfg["superframe_words"]
        self.frames = [rgb.make_frame(cfg, seed, j, dev)
                       for j in range(self.n)]
        from ternary_image_codec_tpu_torch.codec import codec_for
        self.codec = codec_for(port.encoder_config(cfg), dev)

    def _wire(self, f, **prec):
        """The reference's (RAW superframes, wire planes) of frame ``f``."""
        raw = pixels.superframes(pixels.ingest(f, **prec), self.sfw)
        return raw, ref.encode(raw, self.cfg)

    def _rgb(self, raw, **prec):
        """The reference's RGB of a decode of ``raw``'s wire."""
        back = pixels.words(ref.expected_decode(raw, self.cfg), self.sfw)
        return pixels.egress(back, *self.size, **prec)

    def request(self, i):
        f = self.frames[i % self.n]
        if self.control:
            with self.spans("encode"):
                raw, wire = self._wire(f, **LOWER)
            with self.spans("decode"):
                out = self._rgb(raw, **LOWER)
            return {"frame": i % self.n, "wire": wire, "rgb": out,
                    "ok": torch.ones((), dtype=torch.bool, device=f.device)}
        with self.spans("encode"):
            wire = self.codec.encode_rgb(f)
        with self.spans("decode"):
            out, ok = self.codec.decode_rgb(wire, "auto", size=self.size)
        return {"frame": i % self.n, "wire": wire, "rgb": out, "ok": ok}

    def warm(self):
        for i in range(2):
            self.request(i)

    def release(self):
        self.frames = self.codec = None

    def judge(self, kept, not_ok, attempted):
        wire = values = 0
        for a in kept.values():
            f = rgb.make_frame(self.cfg, self.seed, a["frame"], self.dev)
            raw, want = self._wire(f)
            wire += checks.wrong(a["wire"], want)
            values += checks.wrong(a["rgb"], self._rgb(raw))
        return [checks.at_most("wire_symbols_wrong", wire, 0),
                checks.at_most("rgb_values_wrong", values, 0),
                checks.at_most("requests_not_ok", not_ok, 0),
                checks.at_least("answers_judged", len(kept), 1)]
