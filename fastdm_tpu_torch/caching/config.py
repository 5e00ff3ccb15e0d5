"""Cache config dataclasses (port of fastdm_tpu/caching/config.py): TeaCache,
FBCache and DiCache, read from the reference's JSON configs unchanged (its
'negtive_*' spellings included; keys a config does not know are ignored, as
in JAX)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, ClassVar, Dict, Tuple, Type


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    cache_algorithm: str = "teacache"
    enable_caching: bool = False
    threshold: float = 0.2
    negtive_cache: bool = False  # dual pos/neg state for two-forward CFG models

    _registry: ClassVar[Dict[str, Type["CacheConfig"]]] = {}

    @classmethod
    def register(cls, name: str):
        def deco(sub):
            CacheConfig._registry[name.lower()] = sub
            return sub

        return deco

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "CacheConfig":
        algo = data.get("cache_algorithm")
        if algo is None:
            raise ValueError("cache_algorithm must be specified")
        target = CacheConfig._registry.get(algo.lower())
        if target is None:
            raise ValueError(f"unknown cache_algorithm {algo!r}; available: "
                             f"{sorted(CacheConfig._registry)}")
        names = {f.name for f in dataclasses.fields(target) if not f.name.startswith("_")}
        kwargs = {k: v for k, v in data.items() if k in names}
        for k in ("coefficients", "negtive_coefficients"):
            if isinstance(kwargs.get(k), list):
                kwargs[k] = tuple(kwargs[k])
        return target(**kwargs)

    @classmethod
    def from_json(cls, path: str) -> "CacheConfig":
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


@CacheConfig.register("teacache")
@dataclasses.dataclass(frozen=True)
class TeaCacheConfig(CacheConfig):
    coefficients: Tuple[float, ...] = ()
    negtive_coefficients: Tuple[float, ...] = ()  # the negative CFG stream's polynomial


@CacheConfig.register("dicache")
@dataclasses.dataclass(frozen=True)
class DiCacheConfig(CacheConfig):
    probe_depth: int = 1
    ret_ratio: float = 0.2
    rel_l1_distance_algo: str = "delta_y"  # delta_y | delta_minus


@CacheConfig.register("fbcache")
@dataclasses.dataclass(frozen=True)
class FBCacheConfig(CacheConfig):
    warmup_steps: int = 6
