"""Superframe split over the cards: one frame a request, its superframes
split over every rank of the cell by the program's
``parallel/mesh.roundtrip_superframes_dp`` (each rank encodes its
contiguous share, padded to a whole number of superframes a rank, and
decodes it through the paged body decode, ``sf_batch`` superframes at a
time, the program's default) and all-gathered back by ``mesh.gather``.

Every rank builds this loop (``lib/ranks.py``) on a mesh of all ranks
(``mesh.make_mesh()``) and makes the run's frames on its own device,
since the call takes the global frame on every rank; the ranks run each
request together.  Rank 0's answer is the gathered frame, cut to the
frame's RAW words, and the global ok (``mesh.all_ok``).

Parameters: ``distinct_frames`` resident frames that the requests cycle
through.  The call returns no wire, so on the requests drawn for judging
(the same on every rank) each rank keeps what the program's encode
(``ops.encode.encode_superframes``, the entry the call reaches for each
micro-batch) returns.  After the window each rank compares that wire, its
padded superframes included, symbol by symbol with the reference's encode
of the same superframes (``tally``), and the counts are summed over the
ranks.  The judge, on rank 0, also compares every RAW symbol of each
judged request's gathered frame with what the reference says a decode of
the frame returns; every request's ok must be True.  The control leaves
out the exchange between the cards: rank 0's own rows, every other rank's
rows left zero.
"""
from __future__ import annotations

import contextlib

import torch

from t3bench.lib import checks, port, runner, traffic
from t3bench.reference import codec as ref


class Loop:
    frames_per_request = 1

    def __init__(self, cfg, params, seed, dev, spans, control=False):
        from ternary_image_codec_tpu_torch.ops import encode
        from ternary_image_codec_tpu_torch.parallel import launch, mesh
        self.cfg, self.spans, self.control = cfg, spans, control
        self.n = params["distinct_frames"]
        self.n_raw, self.n_sf, self.sf = traffic.frame_shape(cfg)
        self.frames = traffic.make_frames(cfg, seed, range(self.n), dev)
        self.pcfg = port.encoder_config(cfg)
        self.enc, self.pm = encode, mesh
        self.judged = runner.sample(seed, params)
        self.wires = {}             # judged request -> the encode's outputs
        self._launch = None
        if dev.type != "cuda":
            # the CPU's gloo ranks of the benchmark's tests have no current
            # CUDA device for the mesh to take
            self._launch, self._was = launch, launch._rank_device
            launch._rank_device = dev
        self.mesh = mesh.make_mesh()
        self.size = self.mesh.size
        self.per = -(-self.n_sf // self.size)       # superframes a rank

    @contextlib.contextmanager
    def _capture(self, i):
        real = self.enc.encode_superframes
        got = self.wires[i] = []

        def encode_superframes(*a, **k):
            w = real(*a, **k)
            got.append(w)
            return w
        self.enc.encode_superframes = encode_superframes
        try:
            yield
        finally:
            self.enc.encode_superframes = real

    def request(self, i):
        frame = self.frames[i % self.n].view(-1, 9)[:self.n_raw]
        with self.spans("split"):
            with self._capture(i) if i in self.judged \
                    else contextlib.nullcontext():
                local, ok = self.pm.roundtrip_superframes_dp(
                    frame, self.pcfg, self.mesh)
        with self.spans("gather"):
            if self.control:
                raw = torch.zeros_like(frame)
                lo = self.mesh.rank * local.shape[0]
                mine = raw[lo:lo + local.shape[0]]
                mine.copy_(local[:mine.shape[0]])
            else:
                raw = self.pm.gather(self.mesh, local)[:self.n_raw]
        return {"frame": i % self.n, "raw": raw, "ok": ok}

    def warm(self):
        for i in range(2):
            self.request(i)
        self.wires.clear()

    def release(self):
        self.rank, self.mesh = self.mesh.rank, None
        if self._launch is not None:
            self._launch._rank_device = self._was

    def tally(self):
        """This rank's wire of each judged request that ran, its padded
        superframes included, against the reference's encode."""
        lo = self.rank * self.per
        wrong = judged = 0
        for i, parts in self.wires.items():
            f = self.frames[i % self.n][lo:lo + self.per]
            f = torch.nn.functional.pad(
                f, (0, 0, 0, 0, 0, self.per - f.shape[0]))
            want = ref.encode(f, self.cfg)
            got = torch.cat(parts) if parts else torch.zeros(0)
            wrong += checks.wrong(got, want)
            judged += self.per if got.shape == want.shape else 0
        self.wires.clear()
        return {"wire_symbols_wrong": wrong, "wire_superframes_judged": judged}

    def judge(self, kept, not_ok, attempted, tally):
        raw = 0
        for a in kept.values():
            f = self.frames[a["frame"]]
            want = ref.expected_decode(f, self.cfg)[:, :, :self.sf]
            want = want.transpose(1, 2).reshape(-1, 9)[:self.n_raw]
            raw += checks.wrong(a["raw"], want)
        due = sum(i < attempted for i in self.judged)
        return [checks.at_most("raw_symbols_wrong", raw, 0),
                checks.at_most("wire_symbols_wrong",
                               tally["wire_symbols_wrong"], 0),
                checks.at_least("wire_superframes_judged",
                                tally["wire_superframes_judged"],
                                max(due, 1) * self.size * self.per),
                checks.at_most("requests_not_ok", not_ok, 0),
                checks.at_least("answers_judged", len(kept), 1)]
