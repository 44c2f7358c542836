"""The single-device entry step (``entry.entry``) against the JAX
package's ``__graft_entry__.entry``, on the CPU at its full 720p size.

``make_raw_words`` draws the reference's words; the step's profile words
(576868, 9) int8 equal the reference step's bit for bit and are the same
on a second call; the port's ``decode_profile_to_raw`` of them equals the
reference's clean, under ``chip_smoke.py`` phase 12's damage pattern and
on its overcap copy: RAW words, header and ok flag.  Tolerance: zero.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import __graft_entry__ as graft
import chip_smoke as cs
from ternary_image_codec_tpu.ops import pipeline as jpipe
from ternary_image_codec_tpu_torch import entry as E
from ternary_image_codec_tpu_torch.ops import pipeline as tpipe

CPU = "cpu"


@pytest.mark.parametrize("n, seed", [(1, 0), (36, 3), (1000, 7),
                                     (E.N_RAW, 0)])
def test_make_raw_words(n, seed):
    got = E.make_raw_words(n, seed)
    assert got.dtype == np.int8 and got.shape == (n, 9)
    assert np.array_equal(got, graft._make_raw_words(n, seed))


@pytest.fixture(scope="module")
def steps():
    """(reference words, port words, port step, port raw) of the step."""
    jfn, (jraw,) = graft.entry()
    fn, (raw,) = E.entry(device=CPU)
    assert np.array_equal(raw.numpy(), np.asarray(jraw))
    return np.asarray(jfn(jraw)), fn(raw), fn, raw


def test_step_matches_reference(steps):
    want, got, _fn, raw = steps
    assert raw.device.type == "cpu" and raw.shape == (E.N_RAW, 9)
    assert got.dtype == torch.int8 and got.shape == (576868, 9)
    assert np.array_equal(got.numpy(), want)


def test_step_leaves_no_state(steps):
    _want, got, fn, raw = steps
    again = fn(raw)
    assert torch.equal(again, got)
    assert again.data_ptr() != got.data_ptr()


@pytest.fixture(scope="module")
def damaged(steps):
    _want, got, _fn, _raw = steps
    dirty, overcap = cs.entry_damage(torch, got)
    return {"clean": got, "damaged": dirty, "overcap": overcap}


def test_damage_pattern(steps, damaged):
    """Phase 12's damage: ``ENTRY_BLOCKS`` codewords in each band of
    ``ENTRY_BANDS`` (the beacon band among them), one header cell, beacon
    cells; the overcap copy adds t+1 cells to one codeword."""
    got = steps[1]
    assert E.CFG.beacon.band_slot in cs.ENTRY_BANDS
    diff = (damaged["damaged"] != got).nonzero().tolist()
    assert sum(r < tpipe.HEADER_WORDS for r, _b in diff) == 1
    body_bands = {b for r, b in diff if r >= tpipe.HEADER_WORDS}
    assert body_bands == set(cs.ENTRY_BANDS)
    p = E.CFG.beacon.words_period
    cells = [r - tpipe.HEADER_WORDS for r, b in diff
             if r >= tpipe.HEADER_WORDS and b == E.CFG.beacon.band_slot
             and (r - tpipe.HEADER_WORDS) % p == 0]
    assert len(cells) == cs.ENTRY_BEACON_CELLS
    extra = (damaged["overcap"] != damaged["damaged"]).nonzero().tolist()
    k = tpipe.build_encode_layout(E.CFG, E.N_RAW).geom.ks[cs.ENTRY_BANDS[0]]
    assert len(extra) == (26 - k) // 2 + 1
    assert {b for _r, b in extra} == {cs.ENTRY_BANDS[0]}
    assert len({(r - tpipe.HEADER_WORDS) // 26 for r, _b in extra}) == 1


@pytest.mark.parametrize("case, want_ok", [("clean", True),
                                           ("damaged", True),
                                           ("overcap", False)])
def test_decode_back_matches_reference(steps, damaged, case, want_ok):
    raw = steps[3]
    words = damaged[case]
    jout, jhdr, jok = jpipe.decode_profile_to_raw(jnp.asarray(words.numpy()))
    out, hdr, ok = tpipe.decode_profile_to_raw(words, device=CPU)
    assert ok == jok == want_ok
    assert dataclasses.asdict(hdr) == dataclasses.asdict(jhdr)
    assert np.array_equal(out.numpy(), np.asarray(jout))
    if want_ok:
        assert torch.equal(out[:E.N_RAW], raw)
