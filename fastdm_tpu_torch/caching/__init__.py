"""Step-skipping caches (TeaCache / FBCache / DiCache), decided on the host."""

from fastdm_tpu_torch.caching.config import (  # noqa: F401
    CacheConfig,
    DiCacheConfig,
    FBCacheConfig,
    TeaCacheConfig,
)
from fastdm_tpu_torch.caching.xcaching import AutoCache, cache_init_state, cached_run  # noqa: F401
