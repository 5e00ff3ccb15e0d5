"""Wan denoise loops (port of the Wan part of
fastdm_tpu/pipeline/denoise_more.py: _warmup_scans :402-423,
make_wan_denoiser :426-496, make_wan_cached_denoiser :499-647,
make_wan_ti2v_denoiser :740-851 and make_wan_dual_phase_denoiser :854-1019).

True classifier-free guidance: two forwards per step (text, then negative
text), combined in float32. Python loops take the place of lax.scan /
lax.cond; the radial sparse mask is skipped on the first dense-warmup steps.
Wan2.2-A14B's two experts run phase-split: the boundary step comes from the
sigma ladder (the high-noise expert runs while sigma >= boundary_ratio), and
the scheduler state carries across the phase boundary. Under FBCache or
DiCache each forward is wan_forward_cached with a (pos, neg) pair of cache
states (the negative stream on negative_stream_config); the dual loop makes a
fresh pair at the start of each expert's phase, and step indices stay global
(the warmup tests compare them). Image-to-video: the t2v loops take `cond`,
channels concatenated to the latents every step (Wan i2v: a 4-channel frame
mask and the encoded first frame); the TI2V loop (Wan2.2-TI2V-5B) re-pins the
clean encoded first latent frame every step and gives its tokens timestep 0
through the per-token timestep. Wan2.1-I2V's CLIP image tokens
(encoder_image) go to every forward of the one-expert loops, the same tokens
for both CFG branches; the dual-expert loop refuses them, as the JAX engine
does (fastdm_tpu/engine.py:1546-1551). The scheduler is UniPC (stateful) or
FlowMatch-Euler. The loops return the number of skipped forwards.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fastdm_tpu_torch.models.wan import WanConfig, WanTransformer, wan_forward, \
    wan_forward_cached

Tensor = torch.Tensor


def dense_warmup_cut(dense_warmup_steps: int, num_steps: int) -> int:
    """Steps [0, cut) run dense. Clamped to [0, num_steps], as _warmup_scans:
    a radial config's dense_steps may exceed the step count."""
    return min(max(int(dense_warmup_steps), 0), num_steps)


def expert_boundary_step(sigmas: np.ndarray, num_steps: int, boundary_ratio: float) -> int:
    """The first step run by the low-noise expert: the number of steps whose
    sigma is >= boundary_ratio (the ladder descends)."""
    return int(np.sum(np.asarray(sigmas)[:num_steps] >= boundary_ratio))


def _sched_init(scheduler, latents: Tensor):
    """The scheduler's state: UniPC's history, or None for FlowMatch-Euler."""
    return scheduler.init_state(latents) if hasattr(scheduler, "init_state") else None


def _sched_step(scheduler, out: Tensor, step_i: int, sample: Tensor, state, num_steps: int):
    """(prev_sample, new state) for a stateful (UniPC) or stateless (Euler)
    scheduler, as the JAX scheduler_step."""
    if hasattr(scheduler, "init_state"):
        return scheduler.step(out, step_i, sample, state, num_steps)
    return scheduler.step(out, step_i, sample), state


def _make_guided(cfg: WanConfig, num_steps: int, do_cfg: bool, cache_cfg=None):
    """guided(params, guidance, x, t, step_i, pos_text, neg_text, cos, sin,
    mask, caches, image=None) -> the float32 CFG velocity of the bf16 input x
    at timestep t; `caches`, a [pos, neg] list of cache states, is updated in
    place under a step cache; `image`, CLIP image tokens, conditions both
    branches."""
    if cache_cfg is not None:
        from fastdm_tpu_torch.caching.xcaching import negative_stream_config

        stream_cfgs = (cache_cfg, negative_stream_config(cache_cfg))

    def guided(params: WanTransformer, guidance: float, x: Tensor, t: Tensor, step_i: int,
               pos_text: Tensor, neg_text: Tensor, cos: Tensor, sin: Tensor, mask, caches,
               image: Optional[Tensor] = None):
        def one(text, stream: int):
            if cache_cfg is None:
                return wan_forward(params, cfg, x, t, text, image, rope_cos=cos, rope_sin=sin,
                                   sparse_mask=mask).float()
            out, caches[stream] = wan_forward_cached(
                params, cfg, stream_cfgs[stream], caches[stream], step_i, num_steps, x, t, text,
                image, rope_cos=cos, rope_sin=sin, sparse_mask=mask)
            return out.float()

        out = one(pos_text, 0)
        if do_cfg:
            neg = one(neg_text, 1)
            out = neg + guidance * (out - neg)
        return out

    return guided


def _make_step(cfg: WanConfig, scheduler, num_steps: int, sparse_mask, dense_cut: int,
               do_cfg: bool, cache_cfg=None):
    sigmas = np.asarray(scheduler.sigmas, np.float32)
    guided = _make_guided(cfg, num_steps, do_cfg, cache_cfg)

    def step(params: WanTransformer, guidance: float, latents: Tensor, state, step_i: int,
             pos_text: Tensor, neg_text: Tensor, cos: Tensor, sin: Tensor, caches=None,
             cond: Optional[Tensor] = None, image: Optional[Tensor] = None):
        """One step; cond (i2v) is concatenated to the latents' channels,
        image (Wan2.1-I2V's CLIP tokens) conditions the cross-attention."""
        b = latents.shape[0]
        t = torch.full((b,), float(sigmas[step_i] * np.float32(1000.0)), dtype=torch.float32,
                       device=latents.device)
        mask = None if step_i < dense_cut else sparse_mask
        x = latents if cond is None else torch.cat([latents, cond.float()], dim=1)
        out = guided(params, guidance, x.to(torch.bfloat16), t, step_i, pos_text, neg_text, cos,
                     sin, mask, caches, image)
        return _sched_step(scheduler, out, step_i, latents, state, num_steps)

    return step


def _fresh_caches(cfg: WanConfig, cache_cfg, latents: Tensor):
    """A zeroed [pos, neg] pair of cache states for `latents`' token count."""
    from fastdm_tpu_torch.caching.xcaching import cache_init_state

    if cache_cfg is None:
        return None
    b, _, f, h, w = latents.shape
    pt, ph, pw = cfg.patch_size
    shape = (b, (f // pt) * (h // ph) * (w // pw), cfg.inner_dim)
    return [cache_init_state(cache_cfg, shape, shape, device=latents.device) for _ in range(2)]


def _skips(caches) -> int:
    return 0 if caches is None else sum(c["skips"] for c in caches)


def make_wan_denoiser(cfg: WanConfig, scheduler, num_steps: int, guidance_scale: float = 5.0,
                      dense_warmup_steps: int = 0):
    """One expert. Returns run(params, latents (B, C, F, H, W) float32,
    pos_text, neg_text (B, text_len, text_dim), cos, sin, sparse_mask,
    cond=None, encoder_image=None) -> (latents, skips = 0); cond (B, C_cond,
    F, H, W), the i2v conditioning channels, is concatenated to the latents
    every step; encoder_image (B, S_img, image_dim), Wan2.1-I2V's CLIP
    tokens, conditions both CFG branches of every forward. With
    guidance_scale <= 1 the negative branch is not run. The scheduler is a
    UniPCMultistepScheduler (the Wan default) or a FlowMatchEulerScheduler."""
    return make_wan_cached_denoiser(cfg, scheduler, num_steps, None, guidance_scale,
                                    dense_warmup_steps)


def make_wan_cached_denoiser(cfg: WanConfig, scheduler, num_steps: int, cache_cfg,
                             guidance_scale: float = 5.0, dense_warmup_steps: int = 0):
    """One expert under FBCache / DiCache (cache_cfg; None runs uncached):
    run(params, latents, pos_text, neg_text, cos, sin, sparse_mask,
    cond=None, encoder_image=None) -> (latents, skipped forwards of both CFG
    streams); the cached forwards carry the image tokens in the context, as
    JAX's (fastdm_tpu/pipeline/denoise_more.py:499-650)."""

    @torch.inference_mode()
    def run(params: WanTransformer, latents: Tensor, pos_text: Tensor, neg_text: Tensor,
            cos: Tensor, sin: Tensor, sparse_mask=None, cond: Optional[Tensor] = None,
            encoder_image: Optional[Tensor] = None) -> Tuple[Tensor, int]:
        step = _make_step(cfg, scheduler, num_steps, sparse_mask,
                          dense_warmup_cut(dense_warmup_steps, num_steps), guidance_scale > 1.0,
                          cache_cfg)
        state = _sched_init(scheduler, latents)
        caches = _fresh_caches(cfg, cache_cfg, latents)
        for i in range(num_steps):
            latents, state = step(params, guidance_scale, latents, state, i, pos_text, neg_text,
                                  cos, sin, caches, cond, encoder_image)
        return latents, _skips(caches)

    return run


def make_wan_dual_phase_denoiser(cfg: WanConfig, scheduler, num_steps: int,
                                 guidance_scale: float, guidance_scale_2: Optional[float],
                                 boundary_ratio: float, dense_warmup_steps: int = 0,
                                 cache_cfg=None):
    """Wan2.2-A14B: the high-noise expert (params) on steps [0, b) with
    guidance_scale, the low-noise expert (params_2) on [b, num_steps) with
    guidance_scale_2 (default: guidance_scale), b =
    expert_boundary_step(...); under a step cache (cache_cfg) each phase
    starts from a fresh (pos, neg) pair of cache states. Returns run(params,
    params_2, latents, pos_text, neg_text, cos, sin, sparse_mask, cond=None)
    -> (latents, skipped forwards), cond as in make_wan_denoiser; the run's
    per-expert step counts are left in run.phase_steps."""
    g2 = guidance_scale if guidance_scale_2 is None else guidance_scale_2
    b_step = expert_boundary_step(scheduler.sigmas, num_steps, boundary_ratio)

    @torch.inference_mode()
    def run(params: WanTransformer, params_2: WanTransformer, latents: Tensor,
            pos_text: Tensor, neg_text: Tensor, cos: Tensor, sin: Tensor,
            sparse_mask=None, cond: Optional[Tensor] = None,
            encoder_image: Optional[Tensor] = None) -> Tuple[Tensor, int]:
        if encoder_image is not None:
            raise NotImplementedError(
                "CLIP image conditioning with the dual-expert phase loop is not wired (no "
                "released checkpoint combines them), as in the JAX engine")
        # CFG on or off for both phases by the first scale, as in JAX
        step = _make_step(cfg, scheduler, num_steps, sparse_mask,
                          dense_warmup_cut(dense_warmup_steps, num_steps), guidance_scale > 1.0,
                          cache_cfg)
        state = _sched_init(scheduler, latents)
        skips = 0
        for lo, hi, expert, g in ((0, b_step, params, guidance_scale),
                                  (b_step, num_steps, params_2, g2)):
            caches = _fresh_caches(cfg, cache_cfg, latents)
            for i in range(lo, hi):
                latents, state = step(expert, g, latents, state, i, pos_text, neg_text, cos,
                                      sin, caches, cond)
            skips += _skips(caches)
        return latents, skips

    run.phase_steps = (b_step, num_steps - b_step)
    return run


def make_wan_ti2v_denoiser(cfg: WanConfig, scheduler, num_steps: int,
                           guidance_scale: float = 5.0, cache_cfg=None,
                           dense_warmup_steps: int = 0):
    """Wan2.2-TI2V-5B's image-conditioned loop (cfg.per_token_timestep): every
    step the clean encoded first latent frame(s) `cond` replace the latents'
    first frames, and the timestep is per token, sigma * 1000 masked to 0 on
    those frames' tokens; CFG, FBCache / DiCache on a (pos, neg) pair of
    cache states and the dense warmup as in the t2v loops. Returns
    run(params, latents (B, C, F, H, W), cond (B, C, Fc, H, W), pos_text,
    neg_text, cos, sin, sparse_mask=None) -> (latents with its first Fc
    frames = cond, skipped forwards)."""
    if not cfg.per_token_timestep:
        raise ValueError("the TI2V loop needs a per_token_timestep config")
    sigmas = np.asarray(scheduler.sigmas, np.float32)
    guided = _make_guided(cfg, num_steps, guidance_scale > 1.0, cache_cfg)
    dense_cut = dense_warmup_cut(dense_warmup_steps, num_steps)

    @torch.inference_mode()
    def run(params: WanTransformer, latents: Tensor, cond: Tensor, pos_text: Tensor,
            neg_text: Tensor, cos: Tensor, sin: Tensor, sparse_mask=None) -> Tuple[Tensor, int]:
        b, _, f, h, w = latents.shape
        pt, ph, pw = cfg.patch_size
        per_frame = (h // ph) * (w // pw)
        fc = cond.shape[2]
        # frame-0 tokens (pt == 1: latent frames and token frames agree) get timestep 0
        tmask = (torch.arange((f // pt) * per_frame, device=latents.device) // per_frame
                 > 0).float()[None]
        state = _sched_init(scheduler, latents)
        caches = _fresh_caches(cfg, cache_cfg, latents)
        for i in range(num_steps):
            lat_in = torch.cat([cond.float(), latents[:, :, fc:]], dim=2)
            t = (sigmas[i] * np.float32(1000.0)).item() * tmask
            out = guided(params, guidance_scale, lat_in.to(torch.bfloat16), t.expand(b, -1), i,
                         pos_text, neg_text, cos, sin,
                         None if i < dense_cut else sparse_mask, caches)
            latents, state = _sched_step(scheduler, out, i, lat_in, state, num_steps)
        return torch.cat([cond.float(), latents[:, :, fc:]], dim=2), _skips(caches)

    return run
