"""Prototype profile routing: dispatch and meta JSON.

The JAX package's profiles.py: the reference's codec_profiles layer
(include/codec_profiles.hpp:46-99, src/codec_profiles.cpp:21-205) with
runtime profile availability.  The reference's meta JSON comes from a .cpp
that does not compile (src/codec_profiles.cpp:140-142, :194-196); the
evidently intended well-formed JSON is written, byte for byte the JAX
package's.  The prototypes run on the device (ops/proto.py); the trits
come back to the host, where the base-243 packing runs in numpy.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from .io.legacy_containers import ProtoProfile
from .ops import proto as P
from .ops.trits import np_base243_to_trits, np_trits_to_base243

VER_HAAR = "haar_v0.1.0"
VER_ANISO = "aniso_rc_v0.1.0"


@dataclasses.dataclass(frozen=True)
class ProtoConfig:
    """include/codec_profiles.hpp:49-66 plus the extension fields the
    reference's .cpp references (haar_sketch*, rc_keep_LL_u8, rc_normalize,
    src/codec_profiles.cpp:90-94, :158-159)."""
    profile: ProtoProfile = ProtoProfile.NONE
    haar_tile: int = 8
    haar_thresh: int = 6
    haar_sketch_size: int = 32
    haar_sketch_down: int = 256
    haar_radial_bins: int = 8
    haar_angle_bins: int = 8
    haar_keep_ll_u8: bool = True
    rc_block: int = 32
    rc_angles: int = 8
    rc_tern_z: float = 1.2
    rc_keep_ll_u8: bool = True
    rc_normalize: bool = True
    pack_base243: bool = True


def encode_prototype_available(p: ProtoProfile) -> bool:
    """Runtime availability (the reference gates at compile time,
    src/codec_profiles.cpp:21-40)."""
    return p in (ProtoProfile.HAAR_TERNARY, ProtoProfile.ANISO_RC)


def describe_prototype_build() -> str:
    """src/codec_profiles.cpp:48-66 JSON shape."""
    protos = [{"id": 1, "name": "HaarTernary", "version": VER_HAAR},
              {"id": 2, "name": "AnisoRC", "version": VER_ANISO}]
    return json.dumps({"prototypes": protos}, indent=2)


def pack_base243_from_balanced(bal) -> np.ndarray:
    """5 balanced trits -> one byte, the tail zero-padded
    (include/proto_noentropy.hpp:69-81)."""
    u = np.clip(np.asarray(bal, dtype=np.int64).reshape(-1), -1, 1) + 1
    return np_trits_to_base243(u)[0]


def unpack_base243_to_balanced(by, n_trits: int) -> np.ndarray:
    """include/proto_noentropy.hpp:82-92."""
    u = np_base243_to_trits(np.asarray(by, dtype=np.uint8), n_trits)
    return u.astype(np.int8) - 1


def _fmt_float(x: float) -> str:
    """std::ostream float formatting: 6 significant digits, no trailing
    zeros, so the meta JSON has the reference's text form."""
    return f"{x:.6g}"


def _counts(bal: np.ndarray, packed: Optional[np.ndarray]) -> str:
    ntr = bal.size
    return ('"counts":{'
            f'"n_trits":{ntr},"tail_trits":{ntr % 5},'
            f'"packed_bytes":{packed.size if packed is not None else (ntr + 4) // 5},'
            '"exact_n_trits":true}}')


def _bool(b: bool) -> str:
    return "true" if b else "false"


def encode_prototype_ternary(rgb, cfg: ProtoConfig, device=None
                             ) -> Tuple[np.ndarray, Optional[np.ndarray], str]:
    """(h, w, 3) uint8 RGB -> (balanced trits int8, packed bytes | None,
    meta JSON), all on the host; the prototype runs on ``device``
    (default the current CUDA device).  src/codec_profiles.cpp:70-205
    dispatch and meta schema."""
    if not encode_prototype_available(cfg.profile):
        raise ValueError(f"prototype profile not available: {cfg.profile}")

    if cfg.profile == ProtoProfile.HAAR_TERNARY:
        params = P.ProtoParams(
            tile=cfg.haar_tile, sketch_size=cfg.haar_sketch_size,
            sketch_down=cfg.haar_sketch_down,
            radial_bins=cfg.haar_radial_bins, angle_bins=cfg.haar_angle_bins,
            thresh=cfg.haar_thresh, keep_ll_u8=cfg.haar_keep_ll_u8)
        _ll, tiles, _tx, _ty = P.proto_tile_haar_ternary(rgb, params, device)
        sketch = P.proto_spectral_sketch(rgb, params, device)
        tiles, sketch = tiles.cpu().numpy(), sketch.cpu().numpy()
        bal = np.concatenate([tiles, sketch]).astype(np.int8)
        packed = pack_base243_from_balanced(bal) if cfg.pack_base243 else None
        meta = (
            '{"proto":"HaarTernary","version":"' + VER_HAAR + '",'
            '"params":{'
            f'"tile":{params.tile},"thresh":{params.thresh},'
            f'"sketchSize":{params.sketch_size},"sketchDown":{params.sketch_down},'
            f'"radialBins":{params.radial_bins},"angleBins":{params.angle_bins},'
            f'"keep_LL_u8":{_bool(params.keep_ll_u8)}'
            '},'
            '"layout":{"order":"tiles_then_sketch",'
            f'"ofs_tiles":0,"len_tiles":{tiles.size},'
            f'"ofs_sketch":{tiles.size},"len_sketch":{sketch.size},'
            '"balanced":true},' + _counts(bal, packed))
        return bal, packed, meta

    params = P.AnisoRCParams(
        block=cfg.rc_block, angles=cfg.rc_angles,
        tern_thresh_z=cfg.rc_tern_z, keep_ll_u8=cfg.rc_keep_ll_u8,
        normalize_proj=cfg.rc_normalize)
    art = P.proto_aniso_rc_encode(rgb, params, device)
    bal = art.trits.cpu().numpy().astype(np.int8)
    packed = pack_base243_from_balanced(bal) if cfg.pack_base243 else None
    meta = (
        '{"proto":"AnisoRC","version":"' + VER_ANISO + '",'
        '"params":{'
        f'"block":{params.block},"angles":{params.angles},'
        f'"z_thresh":{_fmt_float(params.tern_thresh_z)},'
        f'"keep_LL_u8":{_bool(params.keep_ll_u8)},'
        f'"normalize_proj":{_bool(params.normalize_proj)}'
        '},'
        '"layout":{"order":"trits_only",'
        f'"trits_per_block":{art.trits_per_block},'
        '"balanced":true},' + _counts(bal, packed))
    return bal, packed, meta
