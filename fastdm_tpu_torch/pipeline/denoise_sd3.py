"""SD3 / SD3.5 denoise loop (port of fastdm_tpu/pipeline/denoise_more.py
make_sd3_denoiser).

The JAX package jits the loop into one lax.scan; here it is a Python loop over
eager PyTorch ops under torch.inference_mode(), with a step cache's branch
taken on the host once per step. Classifier-free guidance runs the negative
and positive halves as one batch of 2B ([neg; pos], the diffusers order)
through one forward, which shares ONE cache state (the reference's SD3.5
cache configs set negtive_cache=false).
"""

from __future__ import annotations

from typing import Tuple

import torch

from fastdm_tpu_torch.models.sd35 import SD3Config, SD3Transformer, sd3_forward, \
    sd3_forward_cached
from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler

Tensor = torch.Tensor


def make_sd3_denoiser(cfg: SD3Config, scheduler: FlowMatchEulerScheduler, num_steps: int,
                      guidance_scale: float = 7.0, cache_cfg=None, start_step: int = 0):
    """Returns run(params, latents (B, C, H, W) f32, embeds (2B, S, D) [neg;
    pos], pooled (2B, P), pos_embed (1, N, D)) -> (latents, skips).

    FlowMatch-Euler (the SD3 scheduler uses shift 3.0); the model's timestep
    is sigma * 1000. Without CFG (guidance_scale <= 1) the conditioning has
    batch B. start_step > 0 is SDEdit img2img: the caller seeds the latents at
    sigmas[start_step] and the loop runs the remaining steps."""
    do_cfg = guidance_scale > 1.0
    cached = cache_cfg is not None and cache_cfg.enable_caching

    @torch.inference_mode()
    def run(params: SD3Transformer, latents: Tensor, prompt_embeds: Tensor, pooled: Tensor,
            pos_embed: Tensor) -> Tuple[Tensor, int]:
        b, bb = latents.shape[0], prompt_embeds.shape[0]
        if cached:
            from fastdm_tpu_torch.caching.xcaching import cache_init_state

            p = cfg.patch_size
            hshape = (bb, (latents.shape[2] // p) * (latents.shape[3] // p), cfg.inner_dim)
            state = cache_init_state(cache_cfg, hshape, hshape, device=latents.device)
        for step in range(start_step, num_steps):
            # the f32 sigma times 1000, rounded once to f32 as JAX's product
            t = torch.full((bb,), float(scheduler.sigmas[step]) * 1000.0, dtype=torch.float32,
                           device=latents.device)
            x = (torch.cat([latents, latents]) if do_cfg else latents).to(torch.bfloat16)
            if cached:
                out, state = sd3_forward_cached(params, cfg, cache_cfg, state, step, num_steps,
                                                x, prompt_embeds, pooled, t, pos_embed)
            else:
                out = sd3_forward(params, cfg, x, prompt_embeds, pooled, t, pos_embed)
            out = out.float()
            if do_cfg:
                neg, pos = out[:b], out[b:]
                out = neg + guidance_scale * (pos - neg)
            latents = scheduler.step(out, step, latents)
        return latents, state["skips"] if cached else 0

    return run
