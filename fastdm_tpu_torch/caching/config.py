"""Cache config dataclasses (port of fastdm_tpu/caching/config.py), read from
the reference's JSON configs (keys it does not know are ignored, as in JAX).
This slice carries TeaCache for the one-forward-per-step FLUX loop; the
negative-stream CFG keys, FBCache and DiCache arrive with later slices, and
the last two names raise here."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, ClassVar, Dict, Tuple, Type

_LATER = ("fbcache", "dicache")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    cache_algorithm: str = "teacache"
    enable_caching: bool = False
    threshold: float = 0.2

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
        if algo.lower() in _LATER:
            raise NotImplementedError(
                f"cache_algorithm {algo!r} is not in this slice of the port (teacache is)")
        target = CacheConfig._registry.get(algo.lower())
        if target is None:
            raise ValueError(f"unknown cache_algorithm {algo!r}; available: "
                             f"{sorted(CacheConfig._registry)}")
        names = {f.name for f in dataclasses.fields(target) if not f.name.startswith("_")}
        kwargs = {k: v for k, v in data.items() if k in names}
        if isinstance(kwargs.get("coefficients"), list):
            kwargs["coefficients"] = tuple(kwargs["coefficients"])
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
