"""Step-skipping cache, TeaCache (port of fastdm_tpu/caching/xcaching.py).

The JAX package keeps the skip decision on the device (lax.cond inside the
denoise scan). PyTorch runs eagerly, so the port takes the branch on the host
and syncs once per step for it (one .item()), as the upstream FastDM does.
The decision logic is the reference's, bit for bit in float32: probe = block
0's modulated input; its rel-L1 distance to the previous probe, rescaled by
the fitted polynomial, accumulates until `threshold`, and every step below it
replays the previous residual. Step 0 always computes.

Integration contract (used by flux_forward_cached):
    probe_fn(hidden, encoder) -> (probe_tensor, (h', e'))   # always runs
    rest_fn(h', e')           -> out_hidden                 # computed steps only
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from fastdm_tpu_torch.caching.config import CacheConfig, TeaCacheConfig
from fastdm_tpu_torch.device import resolve_device

Tensor = torch.Tensor
State = Dict[str, Tensor]


def _rel_l1(a: Tensor, b: Tensor) -> Tensor:
    a32, b32 = a.float(), b.float()
    return (a32 - b32).abs().mean() / b32.abs().mean().clamp_min(1e-12)


def _check(cfg: CacheConfig) -> None:
    if not isinstance(cfg, TeaCacheConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__} is not in this slice of the port (TeaCache is)")


def cache_init_state(cfg: CacheConfig, hidden_shape, probe_shape, dtype=torch.bfloat16,
                     device="cuda") -> State:
    """Zero-initialized cache state of one stream: the image-stream hidden
    (B, S, D) and the probe tensor shapes."""
    _check(cfg)
    device = resolve_device(device)
    return {
        "accum": torch.zeros((), dtype=torch.float32, device=device),
        "prev_probe": torch.zeros(probe_shape, dtype=dtype, device=device),
        "prev_residual": torch.zeros(hidden_shape, dtype=dtype, device=device),
        "skips": 0,
    }


def _polyval(coeffs, x: Tensor) -> Tensor:
    """Horner in float32, coefficient order highest power first (jnp.polyval)."""
    c = torch.tensor(coeffs, dtype=torch.float32, device=x.device)
    y = torch.zeros_like(x)
    for i in range(c.numel()):
        y = y * x + c[i]
    return y


def _decide(cfg: TeaCacheConfig, state: State, probe: Tensor, step: int) -> Tuple[bool, Tensor]:
    """(should_compute, new_accum); syncs once unless the step is forced."""
    rel = _rel_l1(probe, state["prev_probe"])
    accum_cand = state["accum"] + _polyval(cfg.coefficients or (1.0, 0.0), rel)
    should = step == 0 or bool((accum_cand >= cfg.threshold).item())
    new_accum = torch.zeros_like(accum_cand) if should else accum_cand
    return should, new_accum


def cached_run(
    cfg: CacheConfig, state: State, step: int, total_steps: int, hidden: Tensor,
    encoder: Tensor, probe_fn: Callable, rest_fn: Callable,
) -> Tuple[Tensor, State]:
    """Run one denoiser step under the cache policy -> (out_hidden, new_state).
    total_steps is part of the contract for the warmup-based algorithms."""
    _check(cfg)
    del total_steps
    probe, (h_after, e_after) = probe_fn(hidden, encoder)
    should, new_accum = _decide(cfg, state, probe, step)
    new_state = dict(state)
    if should:
        out = rest_fn(h_after, e_after)
        new_state["prev_residual"] = (out - hidden).to(state["prev_residual"].dtype)
    else:
        out = (hidden + state["prev_residual"]).to(hidden.dtype)
        new_state["skips"] = state["skips"] + 1
    new_state["accum"] = new_accum
    new_state["prev_probe"] = probe.to(state["prev_probe"].dtype)
    return out, new_state

