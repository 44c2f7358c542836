"""Receive: decode only, ``pipeline.decode_frames_fused(words, cfg,
repair_cap=..., wire="planes")`` on a group of frames a request, with the
program's own ``sf_batch``.

Parameters: ``frames_per_request`` (F), ``groups`` resident groups that
the requests cycle through, the receiver's ``repair_cap`` and the
``damage`` model's parameters.  Set-up encodes each group's frames with
the reference encoder and damages them with the frozen damage model, so
the program's decoder receives a wire it did not make.  The judge makes
each judged group's frames again from the seed and compares the decoded
RAW planes symbol by symbol with what the reference says a decode
returns; ok must be True on every request while the damage is within
capacity (no overcap), and False on every request otherwise.  The control
is the program's own decode without RS (``strategy="none"``), frame by
frame.
"""
from __future__ import annotations

import torch

from t3bench.lib import checks, damage, port, traffic
from t3bench.reference import codec as ref


class Loop:
    def __init__(self, cfg, params, seed, dev, spans, control=False):
        self.cfg, self.seed, self.dev = cfg, seed, dev
        self.spans, self.control = spans, control
        self.F = self.frames_per_request = params["frames_per_request"]
        self.G = params["groups"]
        self.cap = params["repair_cap"]
        self.expect_ok = params["damage"]["overcap"] == 0
        _, n_sf, _ = traffic.frame_shape(cfg)
        total = ref.geometry(cfg)["total"]
        self.wires = []
        for g in range(self.G):
            raw = self._frames(g)
            w = torch.stack([ref.encode(r, cfg) for r in raw])
            ev, _ = traffic.damage_events(params, n_sf, total, self.F,
                                          seed, g)
            self.wires.append(damage.apply(w, ev))
            del raw, w
        from ternary_image_codec_tpu_torch.codec import codec_for
        from ternary_image_codec_tpu_torch.ops import pipeline
        self.pcfg = port.encoder_config(cfg)
        self.codec = codec_for(self.pcfg, dev)
        self.decode_frames_fused = pipeline.decode_frames_fused

    def _frames(self, g):
        return traffic.make_frames(self.cfg, self.seed,
                                   range(g * self.F, (g + 1) * self.F),
                                   self.dev)

    def request(self, i):
        w = self.wires[i % self.G]
        with self.spans("decode", self.F):
            if self.control:
                outs = [self.codec.decode(x, "none") for x in w]
                raw = torch.stack([o[0] for o in outs])
                ok = torch.stack([o[1] for o in outs]).all()
            else:
                raw, ok = self.decode_frames_fused(
                    w, self.pcfg, repair_cap=self.cap, wire="planes",
                    device=self.dev)
        return {"group": i % self.G, "raw": raw, "ok": ok}

    def warm(self):
        for i in range(2):
            self.request(i)

    def release(self):
        self.wires = self.codec = None

    def judge(self, kept, not_ok, attempted):
        raw = 0
        for a in kept.values():
            want = torch.stack([ref.expected_decode(r, self.cfg)
                                for r in self._frames(a["group"])])
            raw += checks.wrong(a["raw"], want) if self.expect_ok else 0
        n = len(kept)
        flag = not_ok if self.expect_ok else attempted - not_ok
        return [checks.at_most("raw_symbols_wrong", raw, 0),
                checks.at_most("requests_misflagged", flag, 0),
                checks.at_least("answers_judged", n, 1)]
