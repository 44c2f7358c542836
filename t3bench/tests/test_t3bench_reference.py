"""The plain reference agrees with the port on tiny frames on the CPU: the
same wire planes, and the port's decode of the reference's damaged wire
gives what the reference says a decode returns."""
import json
import os

import pytest
import torch

from t3bench.lib import damage, port, traffic
from t3bench.reference import codec as ref
from t3bench.tests.tiny import BENCH, shrink_config

CPU = torch.device("cpu")


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return shrink_config(json.load(f))


@pytest.mark.parametrize("name", ["p2_8k_luma", "p5_8k_beacon"])
def test_reference_is_the_port_on_tiny_frames(name):
    from ternary_image_codec_tpu_torch.codec import codec_for
    from ternary_image_codec_tpu_torch.ops import pipeline
    cfg = config(name)
    raw = traffic.make_frames(cfg, 2 ** 33 + 5, range(2), CPU)
    codec = codec_for(port.encoder_config(cfg), CPU)
    wire = torch.stack([ref.encode(r, cfg) for r in raw])
    assert torch.equal(wire, torch.stack([codec.encode(r) for r in raw]))
    layout, dlayout = pipeline.stream_layouts(port.encoder_config(cfg))
    g = ref.geometry(cfg)
    assert g["H"] == layout.geom.H and g["n_out"] == dlayout.n_out_words
    ev, _ = damage.damage(raw.shape[1], g["total"], 2, D=3, E=8, hdr=0.5,
                          seed=11)
    out, ok = pipeline.decode_frames_fused(
        damage.apply(wire, ev), port.encoder_config(cfg), repair_cap=6,
        wire="planes", device=CPU)
    assert bool(ok)
    want = torch.stack([ref.expected_decode(r, cfg) for r in raw])
    assert torch.equal(out, want)


def test_control_wire_breaks_the_code():
    cfg = config("p2_8k_luma")
    raw = traffic.make_frames(cfg, 3, range(1), CPU)[0]
    assert not torch.equal(ref.encode(raw, cfg, parity=False),
                           ref.encode(raw, cfg))


def test_parity_matrix_makes_codewords():
    for k in (18, 20, 22, 24):
        d = torch.randint(0, 27, (50, k),
                          generator=torch.Generator().manual_seed(k))
        cw = ref.rs_encode(d, k).tolist()
        for c in cw:
            for j in range(1, 27 - k):
                acc = 0
                for i, v in enumerate(c):
                    acc = ref.gf_add(acc, ref.gf_mul(v, ref.gf_pow(3, j * i)))
                assert acc == 0
