"""Sparse-attention configs (port of fastdm_tpu/sparse/config.py), read from
the reference's JSON files (e.g. examples/sparse/radial_attn_wan.json); keys
a config does not know are ignored, as in JAX."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, ClassVar, Dict, Type


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    sparse_algorithm: str = "radial"
    block_size: int = 128
    dense_layers: int = 0
    dense_steps: int = 0

    _registry: ClassVar[Dict[str, Type["SparseConfig"]]] = {}

    @classmethod
    def register(cls, name: str):
        def deco(sub):
            SparseConfig._registry[name.lower()] = sub
            return sub

        return deco

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SparseConfig":
        algo = data.get("sparse_algorithm", "radial")
        target = SparseConfig._registry.get(algo.lower(), cls)
        names = {f.name for f in dataclasses.fields(target)}
        return target(**{k: v for k, v in data.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "SparseConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


@SparseConfig.register("radial")
@dataclasses.dataclass(frozen=True)
class RadialAttnConfig(SparseConfig):
    decay_factor: float = 1.0
    model_type: str = "wan"  # wan | hunyuan
