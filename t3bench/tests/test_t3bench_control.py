"""``correct`` comes out false where it should: for each cell's control
(the reference or the program with one guarantee broken, in the program's
place), and for a run whose timed path is broken underneath by each fault
the cell can have.  These runs skip the harness's look for a chip and
drive the rest of a run on the CPU at a tiny size; the card test runs the
controls at the cells' own sizes."""
import time

import pytest
import torch

from t3bench.lib import runner
from t3bench.tests import tiny

CPU = torch.device("cpu")


def run(bd, name, dev=CPU, seed=2 ** 32 + 99, control=False, seconds=0.3):
    return runner.run_cell(bd, tiny.benchmark(), name, seed, seconds, False,
                           dev, time.perf_counter(), control=control)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(tmp_path, name):
    out = run(tiny.copy(tmp_path), name, control=True)
    assert not out["correct"], out["checks"]


def flip_first(t):
    t = t.clone()
    t.view(-1)[0] = (t.view(-1)[0] + 1) % 9
    return t


def fault_altered_wire(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import SuperframeCodec
    enc = SuperframeCodec.encode
    monkeypatch.setattr(SuperframeCodec, "encode",
                        lambda self, *a, **k: flip_first(enc(self, *a, **k)))


def fault_altered_answer(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import SuperframeCodec
    from ternary_image_codec_tpu_torch.ops import pipeline
    dec, fused = SuperframeCodec.decode, pipeline.decode_frames_fused

    def decode(self, *a, **k):
        raw, ok = dec(self, *a, **k)
        return flip_first(raw), ok

    def decode_frames_fused(*a, **k):
        raw, ok = fused(*a, **k)
        return flip_first(raw), ok
    monkeypatch.setattr(SuperframeCodec, "decode", decode)
    monkeypatch.setattr(pipeline, "decode_frames_fused", decode_frames_fused)


def fault_flag_flipped(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import SuperframeCodec
    from ternary_image_codec_tpu_torch.ops import pipeline
    dec, fused = SuperframeCodec.decode, pipeline.decode_frames_fused

    def decode(self, *a, **k):
        raw, ok = dec(self, *a, **k)
        return raw, ~ok

    def decode_frames_fused(*a, **k):
        raw, ok = fused(*a, **k)
        return raw, ~ok
    monkeypatch.setattr(SuperframeCodec, "decode", decode)
    monkeypatch.setattr(pipeline, "decode_frames_fused", decode_frames_fused)


def fault_half_batch(monkeypatch):
    from ternary_image_codec_tpu_torch.ops import pipeline
    fused = pipeline.decode_frames_fused

    def decode_frames_fused(words, *a, **k):
        h = max(words.shape[0] // 2, 1)
        raw, ok = fused(words[:h], *a, **k)
        return torch.cat([raw, raw[:words.shape[0] - h]]), ok
    monkeypatch.setattr(pipeline, "decode_frames_fused", decode_frames_fused)


def fault_unrepaired(monkeypatch):
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.ops import pipeline

    def decode_frames_fused(words, cfg, *a, device=None, **k):
        codec = codec_for(cfg, device)
        outs = [codec.decode(w, "none") for w in words]
        return torch.stack([o[0] for o in outs]), outs[0][1]
    monkeypatch.setattr(pipeline, "decode_frames_fused", decode_frames_fused)


# The split's faults are planted in rank 0, whose answer is judged; its
# collectives still run, so that the other ranks keep in step.
def fault_split_altered_answer(monkeypatch):
    from ternary_image_codec_tpu_torch.parallel import mesh
    split = mesh.roundtrip_superframes_dp

    def roundtrip_superframes_dp(*a, **k):
        local, ok = split(*a, **k)
        return flip_first(local), ok
    monkeypatch.setattr(mesh, "roundtrip_superframes_dp",
                        roundtrip_superframes_dp)


def fault_split_flag_flipped(monkeypatch):
    from ternary_image_codec_tpu_torch.parallel import mesh
    split = mesh.roundtrip_superframes_dp

    def roundtrip_superframes_dp(*a, **k):
        local, ok = split(*a, **k)
        return local, ~ok
    monkeypatch.setattr(mesh, "roundtrip_superframes_dp",
                        roundtrip_superframes_dp)


def fault_split_altered_wire(monkeypatch):
    """One body symbol of each encoded micro-batch altered: the paged
    decode repairs it, so the frame and the flags come back right and the
    wire alone shows it."""
    from ternary_image_codec_tpu_torch.ops import encode
    from ternary_image_codec_tpu_torch.ops.pipeline import HEADER_WORDS
    real = encode.encode_superframes

    def encode_superframes(*a, **k):
        w = real(*a, **k).clone()
        w[0, 0, HEADER_WORDS] = (w[0, 0, HEADER_WORDS] + 1) % 27
        return w
    monkeypatch.setattr(encode, "encode_superframes", encode_superframes)


def fault_exchange_left_out(monkeypatch):
    from ternary_image_codec_tpu_torch.parallel import mesh
    real = mesh.gather

    def gather(m, x, *a, **k):
        out = real(m, x, *a, **k).clone()
        out[x.shape[0]:] = 0
        return out
    monkeypatch.setattr(mesh, "gather", gather)


FAULTS = [("p2_8k_luma.rt_clean", fault_altered_wire),
          ("p2_8k_luma.rt_clean", fault_altered_answer),
          ("p2_8k_luma.rt_clean", fault_flag_flipped),
          ("p2_8k_luma.rx_dirty5", fault_altered_answer),
          ("p2_8k_luma.rx_dirty5", fault_flag_flipped),
          ("p2_8k_luma.rx_dirty5", fault_half_batch),
          ("p2_8k_luma.rx_dirty5", fault_unrepaired),
          ("p5_8k_beacon.rx_dirty1", fault_altered_answer),
          ("p5_8k_beacon.rx_dirty1", fault_unrepaired),
          ("p5_8k_beacon.rx_dirty1", fault_flag_flipped),
          ("p2_8k_luma.sfdp4_rt", fault_split_altered_answer),
          ("p2_8k_luma.sfdp4_rt", fault_split_flag_flipped),
          ("p2_8k_luma.sfdp4_rt", fault_split_altered_wire),
          ("p2_8k_luma.sfdp4_rt", fault_exchange_left_out)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, name,
                                          fault):
    bd = tiny.copy(tmp_path)
    assert run(bd, name)["correct"]
    fault(monkeypatch)
    out = run(bd, name)
    assert not out["correct"], out["checks"]
    if fault in (fault_flag_flipped, fault_split_flag_flipped):
        flags = [c["value"] for n, c in out["checks"].items()
                 if n.startswith("requests_")]
        assert flags == [out["attempted"]]
    if fault is fault_split_altered_wire:
        values = {n: c["value"] for n, c in out["checks"].items()}
        assert values["wire_symbols_wrong"] > 0
        assert values["raw_symbols_wrong"] == values["requests_not_ok"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_on_card_at_cell_size(cuda_device, name):
    from t3bench.lib import cell as cells
    chips = cells.load_cell(tiny.BENCH, name)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        out = run(tiny.BENCH, name, dev=cuda_device, seed=seed,
                  control=True, seconds=2)
        assert not out["correct"], out["checks"]
