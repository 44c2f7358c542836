"""K2's plain twin (``rs.correct_pm_ref``) vs the JAX package's RS decoders.

Same codewords, made with numpy from a seed, go through the port and
through ``rs.decode_dig`` and the Pallas kernel ``rs_pallas.decode_dig_fused``
(interpret mode, tile shrunk to 128 as tests/test_rs_pallas.py does).
Tolerance: zero.  ok flags must be equal everywhere, data equal where ok
(a failed block carries whatever its correction produced), and every block
with <= t errors must decode to its original data.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ternary_image_codec_tpu.ops import rs as jrs
from ternary_image_codec_tpu.ops import rs_pallas
from ternary_image_codec_tpu_torch.ops import gf27, rs, rs_cuda

NBLK = 60


def _codewords(k, seed=None):
    """(data (B, k), received (B, 26), n_errors (B,)): block i carries
    i % (t + 2) symbol errors, so t and t + 1 error blocks both occur."""
    r = np.random.default_rng(k if seed is None else seed)
    t = (26 - k) // 2
    data = r.integers(0, 27, size=(NBLK, k))
    cw = rs.np_encode(data, k)
    nerr = np.arange(NBLK) % (t + 2)
    for bi in range(NBLK):
        for p in r.choice(26, size=nerr[bi], replace=False):
            cw[bi, p] = (cw[bi, p] + 1 + r.integers(0, 25)) % 27
    return data, cw, nerr


def _check(k, data, nerr, got, got_ok, want, want_ok):
    assert np.array_equal(got_ok, want_ok)
    assert np.array_equal(got[want_ok], want[want_ok])
    within = nerr <= (26 - k) // 2
    assert got_ok[within].all()
    orig = gf27.np_sym_to_dig(data)
    assert np.array_equal(got[within], orig[within])


@pytest.mark.parametrize("k", [18, 20, 22, 24])
def test_correct_ref_matches_xla_decoder(k):
    data, cw, nerr = _codewords(k)
    dig = gf27.np_sym_to_dig(cw).astype(np.int8)
    want, want_ok = jrs.decode_dig(jnp.asarray(dig), k)
    got, got_ok = rs.decode_dig(torch.as_tensor(dig), k)
    want, want_ok = np.asarray(want), np.asarray(want_ok)
    _check(k, data, nerr, got.numpy(), got_ok.numpy(), want, want_ok)
    # the twin reproduces failed blocks' data too (same algebra)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [22, 24])
def test_correct_ref_matches_pallas_kernel(k, monkeypatch):
    monkeypatch.setattr(rs_pallas, "_TILE", 128)
    rs_pallas.decode_dig_fused.clear_cache()
    data, cw, nerr = _codewords(k, seed=100 + k)
    dig = gf27.np_sym_to_dig(cw).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        want, want_ok = rs_pallas.decode_dig_fused(jnp.asarray(dig), k)
    got, got_ok = rs.decode_dig(torch.as_tensor(dig), k)
    _check(k, data, nerr, got.numpy(), got_ok.numpy(), np.asarray(want),
           np.asarray(want_ok))


@pytest.mark.parametrize("k,page,cap", [(18, 16, 2), (22, 8, None)])
def test_paged_decode_matches_reference(k, page, cap):
    """decode_paged_pm_bk: page capacity, slot-gather merge and overflow
    pages (uncorrected data, ok=False) as the reference's."""
    _data, cw, _nerr = _codewords(k, seed=7)
    recv_bk = gf27.np_sym_to_dig(cw).transpose(2, 0, 1).astype(np.int8)
    want, want_ok = jrs.decode_paged_pm_bk(jnp.asarray(recv_bk), k,
                                           page=page, max_dirty_pages=cap)
    got, got_ok = rs.decode_paged_pm_bk(torch.as_tensor(recv_bk), k,
                                        page=page, max_dirty_pages=cap)
    assert np.array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_overcap_pattern_is_flagged():
    """The fixed beyond-capacity pattern the chip smoke test injects (GF(27)
    errors 1, 1, 2 at coefficients 0..2 of a k=22 codeword) fails in both
    packages: decoding failure depends only on the error pattern."""
    cw = rs.np_encode(np.random.default_rng(3).integers(0, 27, (1, 22)), 22)
    cw[0, :3] = gf27.np_gf_add(cw[0, :3], [1, 1, 2])
    dig = gf27.np_sym_to_dig(cw).astype(np.int8)
    _, want_ok = jrs.decode_dig(jnp.asarray(np.repeat(dig, NBLK, 0)), 22)
    _, got_ok = rs.decode_dig(torch.as_tensor(dig), 22)
    assert not bool(np.asarray(want_ok)[0]) and not bool(got_ok[0])


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        rs_cuda.rs_correct(torch.zeros((3, 26, 4), dtype=torch.int8), 22)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [18, 20, 22, 24])
def test_kernel_matches_twin(k, cuda_device):
    data, cw, nerr = _codewords(k)
    pm = torch.as_tensor(gf27.np_sym_to_dig(cw).transpose(2, 1, 0)
                         .astype(np.int8)).contiguous().to(cuda_device)
    got, got_ok = rs.correct_pm(pm, k)
    want, want_ok = rs.correct_pm_ref(pm, k)
    assert torch.equal(got_ok, want_ok)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [18, 20, 22, 24])
def test_symbol_encode_decode(k):
    """``rs.encode``/``rs.decode`` (symbols in and out, the decode through
    ``correct_pm``) against the JAX package's ``encode_jit``/``decode_jit``:
    codewords equal, ok flags equal, data equal where ok."""
    data, recv, nerr = _codewords(k, seed=100 + k)
    cw = rs.encode(torch.as_tensor(data.astype(np.int8)), k)
    assert cw.dtype == torch.int8
    assert np.array_equal(cw.numpy(), np.asarray(jrs.encode_jit(
        jnp.asarray(data.astype(np.int8)), k)))
    got, got_ok = rs.decode(torch.as_tensor(recv.astype(np.int8)), k)
    want, want_ok = jrs.decode_jit(jnp.asarray(recv.astype(np.int8)), k)
    got, got_ok = got.numpy(), got_ok.numpy()
    want, want_ok = np.asarray(want), np.asarray(want_ok)
    assert got.dtype == np.int8 and got.shape == (NBLK, k)
    assert np.array_equal(got_ok, want_ok)
    assert np.array_equal(got[want_ok], want[want_ok])
    within = nerr <= (26 - k) // 2
    assert got_ok[within].all()
    assert np.array_equal(got[within], data[within])
