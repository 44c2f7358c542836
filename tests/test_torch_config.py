"""The port's copy of config.py against the JAX package's, name by name.

Every public name of the reference module has its twin in the port's:
constants equal, enum members equal by name and value, dataclass fields
and defaults equal, and every function equal over its whole domain.
"""
import dataclasses
import enum
import inspect

import pytest

from ternary_image_codec_tpu import config as jconfig
from ternary_image_codec_tpu_torch import config as tconfig

PUBLIC = sorted(n for n in vars(jconfig) if not n.startswith("_")
                and getattr(getattr(jconfig, n), "__module__", jconfig.__name__)
                == jconfig.__name__)


def _plain(v):
    """A config value as plain data, so the two packages' classes compare."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, _plain(getattr(v, f.name)))
                      for f in dataclasses.fields(v)))
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name, v.value)
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def test_same_public_names():
    assert PUBLIC
    for name in PUBLIC:
        assert hasattr(tconfig, name), name
    ported = sorted(n for n in vars(tconfig) if not n.startswith("_")
                    and getattr(getattr(tconfig, n), "__module__",
                                tconfig.__name__) == tconfig.__name__)
    assert ported == PUBLIC


@pytest.mark.parametrize("name", PUBLIC)
def test_public_name_matches(name):
    ref, got = getattr(jconfig, name), getattr(tconfig, name)
    if isinstance(ref, type) and issubclass(ref, enum.Enum):
        assert [(m.name, m.value) for m in ref] == \
            [(m.name, m.value) for m in got]
        assert got.__mro__[1:] == ref.__mro__[1:]          # IntEnum alike
    elif isinstance(ref, type) and dataclasses.is_dataclass(ref):
        rf, gf = dataclasses.fields(ref), dataclasses.fields(got)
        assert [f.name for f in rf] == [f.name for f in gf]
        assert got.__dataclass_params__.frozen == ref.__dataclass_params__.frozen
        for f, g in zip(rf, gf):
            assert _plain(f.default) == _plain(g.default), f.name
            assert (f.default_factory is dataclasses.MISSING) == \
                (g.default_factory is dataclasses.MISSING), f.name
            if f.default_factory is not dataclasses.MISSING:
                assert _plain(f.default_factory()) == \
                    _plain(g.default_factory()), f.name
    elif callable(ref):
        assert inspect.signature(ref).parameters.keys() == \
            inspect.signature(got).parameters.keys()
    else:
        assert _plain(ref) == _plain(got)


def test_rs_params_for_every_profile():
    for p in jconfig.ProfileID:
        ref = jconfig.rs_params_for(p)
        got = tconfig.rs_params_for(tconfig.ProfileID(p.value))
        assert (ref.n, ref.k, ref.r, ref.t) == (got.n, got.k, got.r, got.t)
    assert _plain(jconfig.HEADER_RS) == _plain(tconfig.HEADER_RS)


def test_subword_functions_every_mode():
    for m in jconfig.SubwordMode:
        tm = tconfig.SubwordMode(m.value)
        assert jconfig.payload_len_for(m) == tconfig.payload_len_for(tm)
        assert jconfig.std_res_for(m) == tconfig.std_res_for(tm)
        assert _plain(jconfig.centered_window(m)) == \
            _plain(tconfig.centered_window(tm))


def test_beacon_symbol_over_a_grid():
    for p in jconfig.ProfileID:
        for s in range(-3, 12):
            for h in range(-2, 7):
                ref = jconfig.encode_beacon_symbol(
                    jconfig.BeaconPayload(p, s, h))
                got = tconfig.encode_beacon_symbol(tconfig.BeaconPayload(
                    tconfig.ProfileID(p.value), s, h))
                assert ref == got, (p, s, h)


def test_uep_helpers():
    for idx in range(4):
        assert jconfig.uep_uniform(idx).band_profile == \
            tconfig.uep_uniform(idx).band_profile
    assert jconfig.uep_luma_priority().band_profile == \
        tconfig.uep_luma_priority().band_profile
    with pytest.raises(ValueError):
        tconfig.UEPLayout((1,) * 8)


def test_int_enums_compare_across_packages():
    assert tconfig.ProfileID.P2_RS26_22 == jconfig.ProfileID.P2_RS26_22
    assert tconfig.SubwordMode.S21 == jconfig.SubwordMode.S21
    # the dataclasses are the port's own classes
    assert tconfig.EncoderConfig is not jconfig.EncoderConfig
