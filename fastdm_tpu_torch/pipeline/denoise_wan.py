"""Wan denoise loops (port of the Wan part of
fastdm_tpu/pipeline/denoise_more.py: _warmup_scans :402-423,
make_wan_denoiser :426-496 and make_wan_dual_phase_denoiser :854-1019,
uncached).

True classifier-free guidance: two forwards per step (text, then negative
text), combined in float32. Python loops take the place of lax.scan /
lax.cond; the radial sparse mask is skipped on the first dense-warmup steps.
Wan2.2-A14B's two experts run phase-split: the boundary step comes from the
sigma ladder (the high-noise expert runs while sigma >= boundary_ratio), and
the scheduler state carries across the phase boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fastdm_tpu_torch.models.wan import WanConfig, WanTransformer, wan_forward

Tensor = torch.Tensor


def dense_warmup_cut(dense_warmup_steps: int, num_steps: int) -> int:
    """Steps [0, cut) run dense. Clamped to [0, num_steps], as _warmup_scans:
    a radial config's dense_steps may exceed the step count."""
    return min(max(int(dense_warmup_steps), 0), num_steps)


def expert_boundary_step(sigmas: np.ndarray, num_steps: int, boundary_ratio: float) -> int:
    """The first step run by the low-noise expert: the number of steps whose
    sigma is >= boundary_ratio (the ladder descends)."""
    return int(np.sum(np.asarray(sigmas)[:num_steps] >= boundary_ratio))


def _make_step(cfg: WanConfig, scheduler, num_steps: int, sparse_mask, dense_cut: int,
               do_cfg: bool):
    sigmas = np.asarray(scheduler.sigmas, np.float32)

    def step(params: WanTransformer, guidance: float, latents: Tensor, state, step_i: int,
             pos_text: Tensor, neg_text: Tensor, cos: Tensor, sin: Tensor):
        b = latents.shape[0]
        t = torch.full((b,), float(sigmas[step_i] * np.float32(1000.0)), dtype=torch.float32,
                       device=latents.device)
        mask = None if step_i < dense_cut else sparse_mask
        x = latents.to(torch.bfloat16)

        def one(text):
            return wan_forward(params, cfg, x, t, text, rope_cos=cos, rope_sin=sin,
                               sparse_mask=mask).float()

        out = one(pos_text)
        if do_cfg:
            neg = one(neg_text)
            out = neg + guidance * (out - neg)
        return scheduler.step(out, step_i, latents, state, num_steps)

    return step


def make_wan_denoiser(cfg: WanConfig, scheduler, num_steps: int, guidance_scale: float = 5.0,
                      dense_warmup_steps: int = 0):
    """One expert. Returns run(params, latents (B, C, F, H, W) float32,
    pos_text, neg_text (B, text_len, text_dim), cos, sin, sparse_mask) ->
    (latents, skips = 0). With guidance_scale <= 1 the negative branch is not
    run. The scheduler is a UniPCMultistepScheduler (the Wan default)."""

    @torch.inference_mode()
    def run(params: WanTransformer, latents: Tensor, pos_text: Tensor, neg_text: Tensor,
            cos: Tensor, sin: Tensor, sparse_mask=None) -> Tuple[Tensor, int]:
        step = _make_step(cfg, scheduler, num_steps, sparse_mask,
                          dense_warmup_cut(dense_warmup_steps, num_steps), guidance_scale > 1.0)
        state = scheduler.init_state(latents)
        for i in range(num_steps):
            latents, state = step(params, guidance_scale, latents, state, i, pos_text, neg_text,
                                  cos, sin)
        return latents, 0

    return run


def make_wan_dual_phase_denoiser(cfg: WanConfig, scheduler, num_steps: int,
                                 guidance_scale: float, guidance_scale_2: Optional[float],
                                 boundary_ratio: float, dense_warmup_steps: int = 0):
    """Wan2.2-A14B: the high-noise expert (params) on steps [0, b) with
    guidance_scale, the low-noise expert (params_2) on [b, num_steps) with
    guidance_scale_2 (default: guidance_scale), b =
    expert_boundary_step(...). Returns run(params, params_2, latents,
    pos_text, neg_text, cos, sin, sparse_mask) -> (latents, skips = 0); the
    run's per-expert step counts are left in run.phase_steps."""
    g2 = guidance_scale if guidance_scale_2 is None else guidance_scale_2
    b_step = expert_boundary_step(scheduler.sigmas, num_steps, boundary_ratio)

    @torch.inference_mode()
    def run(params: WanTransformer, params_2: WanTransformer, latents: Tensor,
            pos_text: Tensor, neg_text: Tensor, cos: Tensor, sin: Tensor,
            sparse_mask=None) -> Tuple[Tensor, int]:
        # CFG on or off for both phases by the first scale, as in JAX
        step = _make_step(cfg, scheduler, num_steps, sparse_mask,
                          dense_warmup_cut(dense_warmup_steps, num_steps), guidance_scale > 1.0)
        state = scheduler.init_state(latents)
        for i in range(num_steps):
            expert, g = (params, guidance_scale) if i < b_step else (params_2, g2)
            latents, state = step(expert, g, latents, state, i, pos_text, neg_text, cos, sin)
        return latents, 0

    run.phase_steps = (b_step, num_steps - b_step)
    return run
