"""Round trip: one frame a request, ``SuperframeCodec.encode`` then
``SuperframeCodec.decode(..., "auto")`` on ``codec_for(cfg)``, the
program's own defaults.

Parameters: ``distinct_frames`` resident frames that the requests cycle
through.  The judge re-encodes each judged request's frame with the
reference and compares the wire planes (header, scramble, parity and
data) and the decoded RAW planes symbol by symbol; every request's ok
must be True.  The control puts the reference's encoder in the program's
place with the parity left out, and the frame itself as the decode.
"""
from __future__ import annotations

import torch

from t3bench.lib import checks, port, traffic
from t3bench.reference import codec as ref


class Loop:
    frames_per_request = 1

    def __init__(self, cfg, params, seed, dev, spans, control=False):
        self.cfg, self.spans, self.control = cfg, spans, control
        self.n = params["distinct_frames"]
        self.frames = traffic.make_frames(cfg, seed, range(self.n), dev)
        from ternary_image_codec_tpu_torch.codec import codec_for
        self.codec = codec_for(port.encoder_config(cfg), dev)

    def request(self, i):
        f = self.frames[i % self.n]
        if self.control:
            with self.spans("encode"):
                wire = ref.encode(f, self.cfg, parity=False)
            with self.spans("decode"):
                raw = ref.expected_decode(f, self.cfg)
            return {"frame": i % self.n, "wire": wire, "raw": raw,
                    "ok": torch.ones((), dtype=torch.bool, device=f.device)}
        with self.spans("encode"):
            wire = self.codec.encode(f)
        with self.spans("decode"):
            raw, ok = self.codec.decode(wire, "auto")
        return {"frame": i % self.n, "wire": wire, "raw": raw, "ok": ok}

    def warm(self):
        for i in range(2):
            self.request(i)

    def release(self):
        self.codec = None

    def judge(self, kept, not_ok, attempted):
        wire = raw = 0
        for a in kept.values():
            f = self.frames[a["frame"]]
            wire += checks.wrong(a["wire"], ref.encode(f, self.cfg))
            raw += checks.wrong(a["raw"], ref.expected_decode(f, self.cfg))
        return [checks.at_most("wire_symbols_wrong", wire, 0),
                checks.at_most("raw_symbols_wrong", raw, 0),
                checks.at_most("requests_not_ok", not_ok, 0),
                checks.at_least("answers_judged", len(kept), 1)]
