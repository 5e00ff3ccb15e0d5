"""Qwen-Image denoise loops (port of fastdm_tpu/pipeline/denoise_more.py
make_qwen_denoiser and make_qwen_edit_denoiser).

The JAX package jits the loop into one lax.scan; here it is a Python loop over
eager PyTorch ops under torch.inference_mode(), with a step cache's branch
taken on the host once per step and stream. Qwen uses true CFG: two forwards
per step, the positive and the negative conditioning, each with its own
cache state (the negative one under negative_stream_config).
"""

from __future__ import annotations

from typing import Tuple

import torch

from fastdm_tpu_torch.caching.config import TeaCacheConfig
from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, QwenImageTransformer, \
    qwen_forward, qwen_forward_cached
from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler

Tensor = torch.Tensor


def make_qwen_denoiser(cfg: QwenImageConfig, scheduler: FlowMatchEulerScheduler, num_steps: int,
                       true_cfg_scale: float = 4.0, cache_cfg=None):
    """Returns run(params, latents (B, S, C) f32 packed, pos_embeds (B, T, D),
    neg_embeds (B, T, D), cos, sin) -> (latents, skips summed over both
    streams).

    FlowMatch-Euler (dynamic shift from the token count, set by the caller);
    the model's timestep is the raw sigma. true_cfg_scale <= 1 runs the
    positive forward only; neg_embeds may then equal pos_embeds."""
    do_cfg = true_cfg_scale > 1.0
    cached = cache_cfg is not None and cache_cfg.enable_caching

    @torch.inference_mode()
    def run(params: QwenImageTransformer, latents: Tensor, pos_embeds: Tensor,
            neg_embeds: Tensor, cos: Tensor, sin: Tensor) -> Tuple[Tensor, int]:
        b = latents.shape[0]
        st_pos = st_neg = neg_cfg = None
        if cached:
            from fastdm_tpu_torch.caching.xcaching import cache_init_state, \
                negative_stream_config

            neg_cfg = negative_stream_config(cache_cfg)
            img = (b, latents.shape[1], cfg.inner_dim)
            probe = ((b, pos_embeds.shape[1], cfg.inner_dim)
                     if isinstance(cache_cfg, TeaCacheConfig) else img)
            st_pos, st_neg = (cache_init_state(cache_cfg, img, probe, device=latents.device)
                              for _ in range(2))

        def forward(embeds, stream_cfg, state, step, x, t):
            if cached:
                return qwen_forward_cached(params, cfg, stream_cfg, state, step, num_steps, x,
                                           embeds, t, cos, sin)
            return qwen_forward(params, cfg, x, embeds, t, cos, sin), state

        for step in range(num_steps):
            t = torch.full((b,), float(scheduler.sigmas[step]), dtype=torch.float32,
                           device=latents.device)
            x = latents.to(torch.bfloat16)
            pos, st_pos = forward(pos_embeds, cache_cfg, st_pos, step, x, t)
            out = pos.float()
            if do_cfg:
                neg, st_neg = forward(neg_embeds, neg_cfg, st_neg, step, x, t)
                neg = neg.float()
                out = neg + true_cfg_scale * (out - neg)
            latents = scheduler.step(out, step, latents)
        return latents, (st_pos["skips"] + st_neg["skips"]) if cached else 0

    return run


def make_qwen_edit_denoiser(cfg: QwenImageConfig, scheduler: FlowMatchEulerScheduler,
                            num_steps: int, true_cfg_scale: float = 4.0, cache_cfg=None):
    """Qwen-Image-Edit loop (fastdm_tpu/pipeline/denoise_more.py:303-399): the
    clean VAE-encoded source tokens follow the noise tokens every step (their
    rope ids are qwen_rope_cos_sin's extra_shapes entries), and only the
    first S outputs, the noise part, are denoised.

    Returns run(params, latents (B, S, C) f32, src_tokens (B, S_src, C),
    pos_embeds, neg_embeds, cos, sin) -> (latents, skips summed over both
    streams); cos / sin must cover txt + S + S_src. Under a cache the two
    streams' states span noise and source tokens (the negative one under
    negative_stream_config); TeaCache probes the text stream."""
    do_cfg = true_cfg_scale > 1.0
    cached = cache_cfg is not None and cache_cfg.enable_caching

    @torch.inference_mode()
    def run(params: QwenImageTransformer, latents: Tensor, src_tokens: Tensor,
            pos_embeds: Tensor, neg_embeds: Tensor, cos: Tensor, sin: Tensor
            ) -> Tuple[Tensor, int]:
        b, s, _ = latents.shape
        expect = pos_embeds.shape[1] + s + src_tokens.shape[1]
        if cos.shape[0] != expect:
            raise ValueError(
                f"rope covers {cos.shape[0]} tokens but the edit sequence has {expect} (txt "
                f"{pos_embeds.shape[1]} + noise {s} + source {src_tokens.shape[1]}); build "
                "qwen_rope_cos_sin with extra_shapes for the source images")
        src = src_tokens.to(torch.bfloat16)
        st_pos = st_neg = neg_cfg = None
        if cached:
            from fastdm_tpu_torch.caching.xcaching import cache_init_state, \
                negative_stream_config

            neg_cfg = negative_stream_config(cache_cfg)
            full = (b, s + src.shape[1], cfg.inner_dim)
            probe = ((b, pos_embeds.shape[1], cfg.inner_dim)
                     if isinstance(cache_cfg, TeaCacheConfig) else full)
            st_pos, st_neg = (cache_init_state(cache_cfg, full, probe, device=latents.device)
                              for _ in range(2))

        def forward(embeds, stream_cfg, state, step, x, t):
            if cached:
                out, state = qwen_forward_cached(params, cfg, stream_cfg, state, step,
                                                 num_steps, x, embeds, t, cos, sin)
            else:
                out = qwen_forward(params, cfg, x, embeds, t, cos, sin)
            return out[:, :s].float(), state

        for step in range(num_steps):
            t = torch.full((b,), float(scheduler.sigmas[step]), dtype=torch.float32,
                           device=latents.device)
            x = torch.cat([latents.to(torch.bfloat16), src], dim=1)
            out, st_pos = forward(pos_embeds, cache_cfg, st_pos, step, x, t)
            if do_cfg:
                neg, st_neg = forward(neg_embeds, neg_cfg, st_neg, step, x, t)
                out = neg + true_cfg_scale * (out - neg)
            latents = scheduler.step(out, step, latents)
        return latents, (st_pos["skips"] + st_neg["skips"]) if cached else 0

    return run
