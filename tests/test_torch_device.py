"""Entry points run on the card unless the caller asks for the CPU.

Without a ``device`` every entry point takes the current CUDA device; on a
machine with no card it raises a RuntimeError naming the ``device``
argument and never returns CPU tensors.  ``device="cpu"`` runs on the CPU
(the parity tests in the other test_torch_*.py files hold that path
bit-exact against the JAX package), and inputs move to the chosen device.
"""
import numpy as np
import pytest
import torch

import ternary_image_codec_tpu_torch as port
from ternary_image_codec_tpu_torch.codec import codec_for, resolve_device
from ternary_image_codec_tpu_torch.ops import pipeline

CFG = port.EncoderConfig(profile=port.ProfileID.P2_RS26_22,
                         uep=port.uep_luma_priority(), superframe_words=256)


def _raw(n_sf=2):
    r = np.random.default_rng(7)
    t = r.integers(0, 3, size=(n_sf * CFG.superframe_words, 27))
    t[:, 26] = 0
    return (t.reshape(-1, 9, 3) * np.array([1, 3, 9])).sum(-1).astype(np.int8)


def _calls():
    """Each entry point, called without a device."""
    raw = _raw()
    chunks = raw.reshape(2, CFG.superframe_words, 9)
    words = port.encode_stream_superframes(torch.as_tensor(raw), CFG,
                                           device="cpu")
    return {
        "SuperframeCodec": lambda: port.SuperframeCodec(CFG),
        "codec_for": lambda: codec_for(CFG),
        "tables_from_reference": lambda: port.tables_from_reference(
            pipeline.reference_inputs(CFG), CFG),
        "encode_stream_superframes": lambda: port.encode_stream_superframes(
            raw, CFG),
        "decode_stream_superframes": lambda: port.decode_stream_superframes(
            words, CFG, len(raw), strategy="check"),
        "roundtrip_stream": lambda: port.roundtrip_stream(
            torch.as_tensor(chunks), CFG),
    }


ENTRIES = ["SuperframeCodec", "codec_for", "decode_stream_superframes",
           "encode_stream_superframes", "roundtrip_stream",
           "tables_from_reference"]


def test_every_entry_point_listed():
    assert sorted(_calls()) == ENTRIES


@pytest.mark.parametrize("entry", ENTRIES)
def test_default_device_is_the_card(entry):
    call = _calls()[entry]
    if torch.cuda.is_available():
        out = call()
        first = out[0] if isinstance(out, tuple) else out     # codec or tensor
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device"):
            call()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                resolve_device(dev)
    else:
        # an unindexed CUDA device is the current one: one cached codec
        current = torch.device("cuda", torch.cuda.current_device())
        for dev in (None, "cuda", current):
            assert resolve_device(dev) == current
        assert codec_for(CFG) is codec_for(CFG, current)


def test_cpu_when_asked_and_inputs_move():
    """numpy in, CPU tensors out; a CPU codec stays on the CPU."""
    raw = _raw()
    words = port.encode_stream_superframes(raw, CFG, device="cpu")
    assert isinstance(words, torch.Tensor) and words.device.type == "cpu"
    out, ok = port.decode_stream_superframes(words.numpy(), CFG, len(raw),
                                             device="cpu")
    assert out.device.type == "cpu" and bool(ok)
    assert np.array_equal(out.numpy(), raw)
    assert codec_for(CFG, "cpu") is codec_for(CFG, torch.device("cpu"))
    assert codec_for(CFG, "cpu").device.type == "cpu"
