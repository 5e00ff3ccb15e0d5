"""Step-skipping caches: TeaCache, FBCache, DiCache (port of
fastdm_tpu/caching/xcaching.py).

The JAX package keeps the skip decision on the device (lax.cond inside the
denoise scan). PyTorch runs eagerly, so the port takes the branch on the host
and syncs once per step and stream for it (one .item(); none on a forced
step), as the upstream FastDM does. The decision logic is the reference's,
in float32:
  * TeaCache: probe = block 0's modulated input; its rel-L1 distance to the
    previous probe, rescaled by the fitted polynomial, accumulates until
    `threshold`; step 0 always computes.
  * FBCache: probe = block 0's output, its rel-L1 distance accumulates;
    steps <= warmup_steps always compute.
  * DiCache: probe = the first probe_depth blocks' output; the error is its
    rel-L1 distance to the previous probe (delta_y), or |delta_y - delta_x|
    with delta_x its distance to the previous step's input (delta_minus);
    steps <= int(ret_ratio * total_steps) always compute.
A computed step stores residual = output - input. A skipped step replays it:
TeaCache and FBCache on the raw input (FBCache discards block 0's output),
DiCache on the probe output, extrapolated from its last two residuals with
gamma clipped to [1, 1.5] once it holds two.

Integration contract (used by flux_forward_cached and wan_forward_cached):
    probe_fn(hidden, encoder) -> (probe_tensor, (h', e'))   # always runs
    rest_fn(h', e')           -> out_hidden                 # computed steps only
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from fastdm_tpu_torch.caching.config import (
    CacheConfig,
    DiCacheConfig,
    FBCacheConfig,
    TeaCacheConfig,
)
from fastdm_tpu_torch.device import resolve_device

Tensor = torch.Tensor
State = Dict[str, Tensor]


def _rel_l1(a: Tensor, b: Tensor) -> Tensor:
    a32, b32 = a.float(), b.float()
    return (a32 - b32).abs().mean() / b32.abs().mean().clamp_min(1e-12)


def _check(cfg: CacheConfig) -> None:
    if not isinstance(cfg, (TeaCacheConfig, FBCacheConfig, DiCacheConfig)):
        raise ValueError(f"unknown cache config {type(cfg).__name__}")


def cache_init_state(cfg: CacheConfig, hidden_shape, probe_shape, dtype=torch.bfloat16,
                     device="cuda") -> State:
    """Zero-initialized cache state of one stream: the image-stream hidden
    (B, S, D) and the probe tensor shapes. The skip and window counters are
    host integers."""
    _check(cfg)
    device = resolve_device(device)
    st = {
        "accum": torch.zeros((), dtype=torch.float32, device=device),
        "prev_probe": torch.zeros(probe_shape, dtype=dtype, device=device),
        "prev_residual": torch.zeros(hidden_shape, dtype=dtype, device=device),
        "skips": 0,
    }
    if isinstance(cfg, DiCacheConfig):
        # the two most recent computed residuals, for the extrapolation
        st["residual_m1"] = torch.zeros(hidden_shape, dtype=dtype, device=device)
        st["residual_m2"] = torch.zeros(hidden_shape, dtype=dtype, device=device)
        st["window_count"] = 0
        st["prev_input"] = torch.zeros(hidden_shape, dtype=dtype, device=device)  # delta_minus
    return st


def _polyval(coeffs, x: Tensor) -> Tensor:
    """Horner in float32, coefficient order highest power first (jnp.polyval)."""
    c = torch.tensor(coeffs, dtype=torch.float32, device=x.device)
    y = torch.zeros_like(x)
    for i in range(c.numel()):
        y = y * x + c[i]
    return y


def _decide(cfg: CacheConfig, state: State, error: Tensor, step: int,
            total_steps: int) -> Tuple[bool, Tensor]:
    """(should_compute, new_accum) from this step's error; syncs once unless
    the step is forced."""
    if isinstance(cfg, TeaCacheConfig):
        accum_cand = state["accum"] + _polyval(cfg.coefficients or (1.0, 0.0), error)
        forced = step == 0
    elif isinstance(cfg, FBCacheConfig):
        accum_cand = state["accum"] + error
        forced = step <= cfg.warmup_steps
    else:
        accum_cand = state["accum"] + error
        forced = step <= int(cfg.ret_ratio * total_steps)
    should = forced or bool((accum_cand >= cfg.threshold).item())
    new_accum = torch.zeros_like(accum_cand) if should else accum_cand
    return should, new_accum


def _dicache_replay(state: State) -> Tensor:
    """The residual a DiCache skip adds: the two-point extrapolation of the
    last two computed residuals, gamma = mean|r2| / mean|r1 - r2| clipped to
    [1, 1.5], once the window holds two; else the last residual."""
    if state["window_count"] < 2:
        return state["prev_residual"]
    r1, r2 = state["residual_m1"], state["residual_m2"]
    gamma = (r2.float().abs().mean() / (r1 - r2).float().abs().mean().clamp_min(1e-12)
             ).clamp(1.0, 1.5)
    return r2 + (gamma * (r1 - r2).float()).to(r1.dtype)


def cached_run(
    cfg: CacheConfig, state: State, step: int, total_steps: int, hidden: Tensor,
    encoder: Tensor, probe_fn: Callable, rest_fn: Callable,
) -> Tuple[Tensor, State]:
    """Run one denoiser step under the cache policy -> (out_hidden, new_state)."""
    _check(cfg)
    probe, (h_after, e_after) = probe_fn(hidden, encoder)
    if isinstance(cfg, TeaCacheConfig):
        error = _rel_l1(probe, state["prev_probe"])
    elif isinstance(cfg, DiCacheConfig) and cfg.rel_l1_distance_algo == "delta_minus":
        # both deltas measure from the current probe output: delta_x against
        # the previous step's input, delta_y against its probe output
        error = (_rel_l1(probe, state["prev_probe"]) - _rel_l1(probe, state["prev_input"])).abs()
    else:
        error = _rel_l1(probe, state["prev_probe"])
    should, new_accum = _decide(cfg, state, error, step, total_steps)
    new_state = dict(state)
    if should:
        out = rest_fn(h_after, e_after)
        residual = (out - hidden).to(state["prev_residual"].dtype)
        new_state["prev_residual"] = residual
        if isinstance(cfg, DiCacheConfig):
            new_state["residual_m2"] = state["residual_m1"]
            new_state["residual_m1"] = residual
            new_state["window_count"] = state["window_count"] + 1
    else:
        if isinstance(cfg, DiCacheConfig):
            out = (h_after + _dicache_replay(state)).to(hidden.dtype)
        else:
            out = (hidden + state["prev_residual"]).to(hidden.dtype)
        new_state["skips"] = state["skips"] + 1
    new_state["accum"] = new_accum
    new_state["prev_probe"] = probe.to(state["prev_probe"].dtype)
    if isinstance(cfg, DiCacheConfig):
        new_state["prev_input"] = hidden.to(state["prev_input"].dtype)
    return out, new_state


def negative_stream_config(cfg: CacheConfig) -> CacheConfig:
    """The config of the negative CFG stream: TeaCache with a fitted negative
    polynomial rescales that stream's distances with it; every other config
    is shared by both streams."""
    if isinstance(cfg, TeaCacheConfig) and cfg.negtive_coefficients:
        return dataclasses.replace(cfg, coefficients=cfg.negtive_coefficients)
    return cfg


class AutoCache:
    """Config-driven factory (fastdm_tpu/caching/xcaching.py:196-226): holds
    the frozen config; the state of a stream is made by `init_state` and
    carried by the caller between steps."""

    def __init__(self, config: CacheConfig):
        self.config = config

    @classmethod
    def from_dict(cls, data) -> "AutoCache":
        return cls(CacheConfig.from_dict(data))

    @classmethod
    def from_json(cls, path: str) -> "AutoCache":
        return cls(CacheConfig.from_json(path))

    def init_state(self, hidden_shape, probe_shape, dtype=torch.bfloat16,
                   device="cuda") -> State:
        return cache_init_state(self.config, hidden_shape, probe_shape, dtype, device)

    def run(self, state: State, step: int, total_steps: int, hidden: Tensor, encoder: Tensor,
            probe_fn: Callable, rest_fn: Callable) -> Tuple[Tensor, State]:
        return cached_run(self.config, state, step, total_steps, hidden, encoder, probe_fn,
                          rest_fn)
