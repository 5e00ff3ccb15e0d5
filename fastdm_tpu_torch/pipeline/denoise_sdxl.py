"""SDXL denoise loop (port of fastdm_tpu/pipeline/denoise_more.py
make_sdxl_denoiser).

The JAX package jits the loop into one lax.scan; here it is a Python loop over
eager PyTorch ops under torch.inference_mode(). Classifier-free guidance runs
the negative and positive halves as one batch of 2B ([neg; pos], the
diffusers order), as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastdm_tpu_torch.models.sdxl import SDXLConfig, SDXLUNet, sdxl_forward
from fastdm_tpu_torch.pipeline.schedulers import EulerDiscreteScheduler

Tensor = torch.Tensor


def make_sdxl_denoiser(cfg: SDXLConfig, scheduler: EulerDiscreteScheduler, num_steps: int,
                       guidance_scale: float = 5.0, start_step: int = 0):
    """Returns run(params, latents (B, 4, H, W) f32, embeds (2B, 77, 2048),
    pooled (2B, 1280), time_ids (2B, 6), ip_embeds=None) -> (latents, 0).

    Epsilon-prediction Euler. Without CFG (guidance_scale <= 1) the
    conditioning has batch B. start_step > 0 is SDEdit img2img: the caller
    seeds latents as z_image + noise * sigmas[start_step]."""
    do_cfg = guidance_scale > 1.0

    @torch.inference_mode()
    def run(params: SDXLUNet, latents: Tensor, prompt_embeds: Tensor, pooled: Tensor,
            time_ids: Tensor, ip_embeds: Optional[Tensor] = None) -> Tuple[Tensor, int]:
        b = latents.shape[0]
        for step in range(start_step, num_steps):
            t = torch.full((prompt_embeds.shape[0],), float(scheduler.timesteps[step]),
                           dtype=torch.float32, device=latents.device)
            inp = scheduler.scale_model_input(latents, step)
            if do_cfg:
                inp = torch.cat([inp, inp])
            out = sdxl_forward(params, cfg, inp.to(torch.bfloat16), t, prompt_embeds, pooled,
                               time_ids, ip_embeds=ip_embeds).float()
            if do_cfg:
                neg, pos = out[:b], out[b:]
                out = neg + guidance_scale * (pos - neg)
            latents = scheduler.step(out, step, latents)
        return latents, 0

    return run
