"""FLUX denoise loops (port of fastdm_tpu/pipeline/denoise.py make_flux_denoiser,
make_flux_kontext_denoiser, make_flux_cn_denoiser with expand_cn_samples,
and the latent packing helpers).

The JAX package jits the whole N-step loop into one lax.scan; here it is a
Python loop over eager PyTorch ops under torch.inference_mode(), with the
TeaCache branch taken on the host once per step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastdm_tpu_torch.models.flux import FluxConfig, FluxTransformer, cn_sample_interval, \
    flux_forward, flux_forward_cached
from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler

Tensor = torch.Tensor


def make_flux_denoiser(cfg: FluxConfig, scheduler: FlowMatchEulerScheduler, num_steps: int,
                       cache_cfg=None, guidance_scale: float = 3.5, start_step: int = 0):
    """Returns run(params, latents, encoder, pooled, cos, sin) -> (latents, skips).

    latents: (B, S_img, in_channels) packed float32; the conditioning is
    already encoded. FLUX-dev is guidance-distilled: the scale enters through
    the guidance embedding, one forward per step. start_step > 0 is SDEdit
    img2img: the caller noises the encoded image to sigmas[start_step] and
    the loop runs the remaining steps. A step cache counts steps from the
    loop's start, as JAX's FLUX loop does (the reference reads
    scheduler.step_index, which restarts at 0 on the truncated schedule), so
    TeaCache's forced first step and FBCache / DiCache's warmup fire there."""

    @torch.inference_mode()
    def run(params: FluxTransformer, latents: Tensor, encoder: Tensor, pooled: Tensor,
            cos: Tensor, sin: Tensor) -> Tuple[Tensor, int]:
        b = latents.shape[0]
        guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=latents.device)
        cached = cache_cfg is not None and cache_cfg.enable_caching
        if cached:
            from fastdm_tpu_torch.caching.xcaching import cache_init_state

            hidden_shape = (b, latents.shape[1], cfg.inner_dim)
            state = cache_init_state(cache_cfg, hidden_shape, hidden_shape,
                                     device=latents.device)
        for step in range(start_step, num_steps):
            t = torch.full((b,), float(scheduler.sigmas[step]), dtype=torch.float32,
                           device=latents.device)
            x = latents.to(torch.bfloat16)
            if cached:
                out, state = flux_forward_cached(
                    params, cfg, cache_cfg, state, step - start_step, num_steps, x, encoder,
                    pooled, t, cos, sin, guidance=guidance)
            else:
                out = flux_forward(params, cfg, x, encoder, pooled, t, cos, sin,
                                   guidance=guidance)
            latents = scheduler.step(out, step, latents)
        return latents, state["skips"] if cached else 0

    return run


def expand_cn_samples(samples: Optional[Tensor], num_layers: int) -> Optional[Tensor]:
    """(L_cn, B, S, D) ControlNet residuals -> one per transformer layer,
    layer i taking samples[i // ceil(num_layers / L_cn)] (the diffusers
    interval indexing). flux_forward indexes the short stack the same way
    in place, so the loop below passes it unexpanded."""
    if samples is None or num_layers == 0:
        return None
    interval = cn_sample_interval(samples, num_layers)
    return samples[torch.arange(num_layers, device=samples.device) // interval]


def make_flux_cn_denoiser(cfg: FluxConfig, cn_cfg, scheduler: FlowMatchEulerScheduler,
                          num_steps: int, guidance_scale: float = 3.5,
                          conditioning_scale: float = 1.0, control_mode: Optional[int] = None):
    """FLUX + ControlNet loop: every step the ControlNet runs on the current
    latents and its residuals go into the FLUX blocks, layer i taking
    residual i // ceil(num_layers / L_cn). No step cache (as in JAX).

    Returns run(params, cn_params, latents (B, S, C) f32, cn_cond, encoder,
    pooled, cos, sin) -> (latents, 0); cn_cond is the packed latent hint (B,
    S, C) or, for a raw-hint ControlNet, the (B, 3, H, W) image in [-1, 1].
    With control_mode (a union checkpoint) the ControlNet's text stream has
    one more token, whose rope id is zero like every FLUX text id: its
    cos / sin are row 0 duplicated in front of the base ones."""
    from fastdm_tpu_torch.models.controlnets import flux_controlnet_forward

    @torch.inference_mode()
    def run(params: FluxTransformer, cn_params, latents: Tensor, cn_cond: Tensor,
            encoder: Tensor, pooled: Tensor, cos: Tensor, sin: Tensor) -> Tuple[Tensor, int]:
        b = latents.shape[0]
        guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=latents.device)
        cnd = cn_cond.to(torch.bfloat16)
        if control_mode is not None and cn_params.controlnet_mode_embedder is None:
            raise ValueError("control_mode was given but the ControlNet has no "
                             "controlnet_mode_embedder: not a union checkpoint")
        cn_cos, cn_sin = cos, sin
        if control_mode is not None:
            cn_cos, cn_sin = torch.cat([cos[:1], cos]), torch.cat([sin[:1], sin])
        for step in range(num_steps):
            t = torch.full((b,), float(scheduler.sigmas[step]), dtype=torch.float32,
                           device=latents.device)
            h = latents.to(torch.bfloat16)
            bs, sbs = flux_controlnet_forward(
                cn_params, cn_cfg, h, cnd, encoder, pooled, t, cn_cos, cn_sin,
                guidance=guidance if cn_cfg.guidance_embeds else None,
                conditioning_scale=conditioning_scale, control_mode=control_mode)
            out = flux_forward(params, cfg, h, encoder, pooled, t, cos, sin, guidance=guidance,
                               controlnet_block_samples=bs, controlnet_single_block_samples=sbs)
            latents = scheduler.step(out, step, latents)
        return latents, 0

    return run


def make_flux_kontext_denoiser(cfg: FluxConfig, scheduler: FlowMatchEulerScheduler,
                               num_steps: int, cache_cfg=None, guidance_scale: float = 2.5):
    """FLUX-Kontext editing loop: the clean reference-image tokens follow the
    noise tokens every step (their rope ids sit on id-planes 1, 2, ...), and
    only the first S outputs, the noise part, are denoised.

    Returns run(params, latents (B, S, C), ref_tokens (B, S_ref, C), encoder,
    pooled, cos, sin) -> (latents, 0); cos / sin cover txt + S + S_ref. It
    runs no step cache: cache_cfg is taken and ignored, as in JAX."""
    del cache_cfg

    @torch.inference_mode()
    def run(params: FluxTransformer, latents: Tensor, ref_tokens: Tensor, encoder: Tensor,
            pooled: Tensor, cos: Tensor, sin: Tensor) -> Tuple[Tensor, int]:
        b, s, _ = latents.shape
        guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=latents.device)
        ref = ref_tokens.to(torch.bfloat16)
        for step in range(num_steps):
            t = torch.full((b,), float(scheduler.sigmas[step]), dtype=torch.float32,
                           device=latents.device)
            x = torch.cat([latents.to(torch.bfloat16), ref], dim=1)
            out = flux_forward(params, cfg, x, encoder, pooled, t, cos, sin,
                               guidance=guidance)[:, :s]
            latents = scheduler.step(out, step, latents)
        return latents, 0

    return run


def flux_pack_latents(x: Tensor) -> Tensor:
    """(B, C, H, W) latent -> (B, H/2*W/2, C*4) packed tokens (FLUX layout)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def flux_unpack_latents(x: Tensor, height_tokens: int, width_tokens: int) -> Tensor:
    """(B, S, C*4) -> (B, C, H, W)."""
    b, _, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, height_tokens, width_tokens, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, height_tokens * 2, width_tokens * 2)
