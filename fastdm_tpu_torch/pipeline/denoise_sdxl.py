"""SDXL denoise loops (port of fastdm_tpu/pipeline/denoise_more.py
make_sdxl_denoiser and make_sdxl_cn_denoiser).

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


def make_sdxl_cn_denoiser(cfg: SDXLConfig, scheduler: EulerDiscreteScheduler, num_steps: int,
                          guidance_scale: float = 5.0, conditioning_scale: float = 1.0,
                          guess_mode: bool = False):
    """SDXL + ControlNet loop. Returns run(params, cn_params, latents (B, 4,
    H, W) f32, embeds (2B, ..), pooled (2B, ..), time_ids (2B, 6), cn_cond
    (B, 3, 8H, 8W) in [0, 1]) -> (latents, 0).

    The ControlNet runs on a batch of 2B under CFG, else B; under
    guess_mode it sees only the positive (second) half's conditioning, with
    logspace-scaled residuals, and the negative half gets zero residuals (the
    diffusers convention). The CFG combine and the Euler step are
    make_sdxl_denoiser's."""
    from fastdm_tpu_torch.models.controlnets import sdxl_controlnet_forward

    do_cfg = guidance_scale > 1.0
    cn_batch = 1 if (guess_mode or not do_cfg) else 2

    @torch.inference_mode()
    def run(params: SDXLUNet, cn_params, latents: Tensor, prompt_embeds: Tensor,
            pooled: Tensor, time_ids: Tensor, cn_cond: Tensor) -> Tuple[Tensor, int]:
        b = latents.shape[0]
        cnd = cn_cond.to(torch.bfloat16)
        cn_cnd = torch.cat([cnd] * cn_batch) if cn_batch > 1 else cnd
        sl = slice(b, None) if (do_cfg and guess_mode) else slice(None)
        for step in range(num_steps):
            t = torch.full((prompt_embeds.shape[0],), float(scheduler.timesteps[step]),
                           dtype=torch.float32, device=latents.device)
            inp = scheduler.scale_model_input(latents, step)
            cn_inp = torch.cat([inp] * cn_batch) if cn_batch > 1 else inp
            down, mid = sdxl_controlnet_forward(
                cn_params, cfg, cn_inp.to(torch.bfloat16), t[sl], prompt_embeds[sl],
                pooled[sl], time_ids[sl], cn_cnd, conditioning_scale=conditioning_scale,
                guess_mode=guess_mode)
            if do_cfg and guess_mode:
                down = [torch.cat([torch.zeros_like(d), d]) for d in down]
                mid = torch.cat([torch.zeros_like(mid), mid])
            if do_cfg:
                inp = torch.cat([inp, inp])
            out = sdxl_forward(params, cfg, inp.to(torch.bfloat16), t, prompt_embeds, pooled,
                               time_ids, down_block_additional_residuals=down,
                               mid_block_additional_residual=mid).float()
            if do_cfg:
                neg, pos = out[:b], out[b:]
                out = neg + guidance_scale * (pos - neg)
            latents = scheduler.step(out, step, latents)
        return latents, 0

    return run
