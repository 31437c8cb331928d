"""Datagen configuration.

The port's copy of ``chatts_tpu/datagen/config.py``: the same numpy code, so a seed
gives the same bits in both packages.

The reference re-reads ``config/datagen_config.yaml`` at import time in every
module (e.g. reference: chatts/ts_generator/generate.py:28-30,
chatts/ts_generator/local_changes.py:25-26) — one ``yaml.safe_load`` per
constant, no schema.  Here it is one frozen dataclass loaded once, with a
loader that accepts the reference YAML schema.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class DatagenConfig:
    # Feature flags (reference: config/datagen_config.yaml keys of the same
    # names, consumed at generate.py:28-30 and local_changes.py:25-26).
    enable_multiple_trend: bool = True
    enable_multiple_seasonal: bool = True
    enable_multiple_noise: bool = True
    enable_drop_prompt: bool = True
    local_change_verbose: bool = False
    # Pipeline knobs (reference: config/datagen_config.yaml).
    num_cpus: int = 8
    dryrun: bool = False
    encoding_method: str = "no"  # training data uses raw values

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DatagenConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_yaml(cls, path: str) -> "DatagenConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})


DEFAULT = DatagenConfig()
