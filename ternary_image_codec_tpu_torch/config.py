"""Configuration types of the PyTorch/CUDA port.

A copy of the JAX package's ``ternary_image_codec_tpu/config.py``, whole
and unchanged but for this docstring, so that the port imports nothing of
that package.  ``tests/test_torch_config.py`` holds the two copies equal:
enum members, dataclass fields and defaults, and every function over its
domain.  The enums are ``IntEnum`` and compare equal across the packages;
the dataclasses are distinct classes.

These mirror the reference codec's config surface (enums, layouts, seeds)
as plain Python dataclasses/enums. They are *static* configuration: the
port's layouts and codecs are cached per frozen config.

Reference parity:
  - ProfileID / RSParams:   old/include/ternary_image_codec_v6_min.hpp:34-56
  - UEPLayout helpers:      old/include/ternary_image_codec_v6_min.hpp:59-72
  - Tile2D/Scrambler/Beacon old/include/ternary_image_codec_v6_min.hpp:73-113
  - SubwordMode/StdRes:     old/include/ternary_image_codec_v6_min.hpp:117-152
    (S15 resolution frozen to the documented 854x480 from the old tree /
    old/documentation.txt:95; the new tree's 960x540 variant is exposed as
    S15_ALT_RES for interop.)
  - Encoder/Decoder config: old/include/ternary_image_codec_v6_min.hpp:861-884
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

TRITS_PER_WORD = 27
SYM_PER_WORD = 9
NUM_BANDS = 9


class ProfileID(enum.IntEnum):
    """RS profile selector (old/include/ternary_image_codec_v6_min.hpp:34)."""

    P1_RS26_24 = 0
    P2_RS26_22 = 1
    P3_RS26_20 = 2
    P4_RS26_18 = 3
    P5_RS26_22_2D = 4
    RAW_MODE = 0xFF


@dataclasses.dataclass(frozen=True)
class RSParams:
    n: int = 26
    k: int = 22

    @property
    def r(self) -> int:
        return self.n - self.k

    @property
    def t(self) -> int:
        return (self.n - self.k) // 2


def rs_params_for(p: ProfileID) -> RSParams:
    """old/include/ternary_image_codec_v6_min.hpp:39-56."""
    table = {
        ProfileID.P1_RS26_24: RSParams(26, 24),
        ProfileID.P2_RS26_22: RSParams(26, 22),
        ProfileID.P3_RS26_20: RSParams(26, 20),
        ProfileID.P4_RS26_18: RSParams(26, 18),
        ProfileID.P5_RS26_22_2D: RSParams(26, 22),
    }
    return table.get(p, RSParams(26, 22))


HEADER_RS = RSParams(26, 18)


@dataclasses.dataclass(frozen=True)
class UEPLayout:
    """Per-band profile indices 0..3 -> P1..P4 (one band per symbol slot)."""

    band_profile: Tuple[int, ...] = (1,) * NUM_BANDS

    def __post_init__(self):
        if len(self.band_profile) != NUM_BANDS:
            raise ValueError("UEPLayout needs exactly 9 band profiles")


def uep_uniform(idx: int = 1) -> UEPLayout:
    """old/include/ternary_image_codec_v6_min.hpp:64-67."""
    return UEPLayout(tuple([idx % 4] * NUM_BANDS))


def uep_luma_priority() -> UEPLayout:
    """Bands 0,3,6 (luma-heavy slots) get stronger protection (P3).

    old/include/ternary_image_codec_v6_min.hpp:68-72.
    """
    prof = [1] * NUM_BANDS
    prof[0] = prof[3] = prof[6] = 2
    return UEPLayout(tuple(prof))


@dataclasses.dataclass(frozen=True)
class Tile2D:
    w: int = 0
    h: int = 0


@dataclasses.dataclass(frozen=True)
class ScramblerSeed:
    a: int = 1
    b: int = 1
    s0: int = 1


@dataclasses.dataclass(frozen=True)
class SparseBeaconCfg:
    words_period: int = 0
    band_slot: int = 0
    enabled: bool = False


class CosetID(enum.IntEnum):
    C0 = 0
    C1 = 1
    C2 = 2


class SubwordMode(enum.IntEnum):
    """N useful trits per 27-trit word."""

    S27 = 27
    S24 = 24
    S21 = 21
    S18 = 18
    S15 = 15


def payload_len_for(m: SubwordMode) -> int:
    return int(m)


# Documented standard resolutions (old/documentation.txt:95, old tree S15=854x480).
STD_RES = {
    SubwordMode.S27: (7680, 4320),
    SubwordMode.S24: (3840, 2160),
    SubwordMode.S21: (1920, 1080),
    SubwordMode.S18: (1280, 720),
    SubwordMode.S15: (854, 480),
}

# The new-tree header variant maps S15 to 960x540
# (include/ternary_image_codec_v6_min.hpp:61); kept for interop.
S15_ALT_RES = (960, 540)


def std_res_for(m: SubwordMode) -> Tuple[int, int]:
    return STD_RES.get(m, STD_RES[SubwordMode.S27])


@dataclasses.dataclass(frozen=True)
class ActiveWindow:
    x0: int
    y0: int
    w: int
    h: int


def centered_window(m: SubwordMode) -> ActiveWindow:
    """Centered active window in the S27 (8K) canvas.

    old/include/ternary_image_codec_v6_min.hpp:147-152.
    """
    bw, bh = std_res_for(SubwordMode.S27)
    tw, th = std_res_for(m)
    return ActiveWindow((bw - tw) // 2, (bh - th) // 2, tw, th)


@dataclasses.dataclass(frozen=True)
class BeaconPayload:
    profile: ProfileID
    frame_seq_mod: int
    health_flags: int


def encode_beacon_symbol(b: BeaconPayload) -> int:
    """(p + 5s + 15h) mod 27 (old/include/ternary_image_codec_v6_min.hpp:107-113)."""
    p = int(b.profile) & 0xFF
    s = b.frame_seq_mod % 5
    h = b.health_flags % 3
    return (p + 5 * s + 15 * h) % 27


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """old/include/ternary_image_codec_v6_min.hpp:862-873."""

    profile: ProfileID = ProfileID.P2_RS26_22
    uep: UEPLayout = dataclasses.field(default_factory=uep_uniform)
    tile: Tile2D = Tile2D()
    seed: ScramblerSeed = ScramblerSeed(1, 1, 1)
    beacon: SparseBeaconCfg = SparseBeaconCfg()
    superframe_words: int = 8192
    subword: SubwordMode = SubwordMode.S27
    centered: bool = True
    coset: CosetID = CosetID.C0


@dataclasses.dataclass(frozen=True)
class SuperframeHeader:
    """Decoded superframe header fields.

    old/include/ternary_image_codec_v6_min.hpp:155-171.
    """

    magic: int = 0x0A2
    version: int = 1
    profile: ProfileID = ProfileID.P2_RS26_22
    uep: UEPLayout = dataclasses.field(default_factory=uep_uniform)
    tile: Tile2D = Tile2D()
    seed: ScramblerSeed = ScramblerSeed(1, 1, 1)
    band_map_hash: int = 0
    frame_seq: int = 0
    beacon: SparseBeaconCfg = SparseBeaconCfg()
    subword: SubwordMode = SubwordMode.S27
    centered: bool = True
    coset: CosetID = CosetID.C0
