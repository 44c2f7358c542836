"""The system under test's side of a configuration: the port's
``EncoderConfig`` of a configuration file."""
from __future__ import annotations


def encoder_config(cfg: dict):
    from ternary_image_codec_tpu_torch.config import (
        CosetID, EncoderConfig, ProfileID, ScramblerSeed, SparseBeaconCfg,
        SubwordMode, Tile2D, UEPLayout)
    bc = cfg["beacon"]
    return EncoderConfig(
        profile=ProfileID(cfg["profile_id"]),
        uep=UEPLayout(tuple(cfg["uep_band_profile"])),
        tile=Tile2D(*cfg["tile"]),
        seed=ScramblerSeed(*cfg["scrambler_seed"]),
        beacon=SparseBeaconCfg(words_period=bc["words_period"],
                               band_slot=bc["band_slot"],
                               enabled=bc["enabled"]),
        superframe_words=cfg["superframe_words"],
        subword=SubwordMode[cfg["subword"]],
        centered=cfg["centered"],
        coset=CosetID(cfg["coset"]))
