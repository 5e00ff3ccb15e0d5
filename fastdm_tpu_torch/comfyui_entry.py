"""ComfyUI forward wrappers (port of fastdm_tpu/comfyui_entry.py).

ComfyUI drives `diffusion_model(x, timestep, context, y, ...)` callables on
torch tensors; these wrappers run the port's forwards on them. The tensors
stay on the device: the inputs move once to the device the params live on
(a no-op when ComfyUI already holds them there, as it does for a model
loaded onto its torch device), and the output comes back on x's device in
x's dtype. The JAX wrappers instead copy every input and output through
numpy on the host.

Step-skipping caches: ComfyUI calls the model once per sampler step (twice
under CFG), so the cache state lives on the wrapper (`HostStepCache`) and
the step index is recovered from the sampler's sigma schedule. Pass
`cache=AutoCache(...)` to the FLUX / SD3 / Qwen wrappers to enable it. As
in the port's denoise loops, the skip decision is taken on the host: one
.item() for the decision, plus one small host read of the sigmas to find
the step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_BF16 = torch.bfloat16


def _params_device(params) -> torch.device:
    """The device of a model's tensors (parameters, else buffers)."""
    for t in params.parameters():
        return t.device
    for t in params.buffers():
        return t.device
    raise ValueError("the params hold no tensor to take a device from")


def _to(t, dev, dtype=_BF16) -> torch.Tensor:
    return t.detach().to(device=dev, dtype=dtype)


def _back(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out.to(device=like.device, dtype=like.dtype)


class HostStepCache:
    """Cache state across per-step ComfyUI calls.

    The step index is recovered by locating the call's sigma in the full
    schedule (transformer_options['sample_sigmas'] against ['sigmas']), and
    the skip state is kept on this object between calls: cached_run returns
    the new state, which persists here. CFG calls at the same step use two
    state slots (positive / negative stream). A step index that moves
    backwards, jumps, or comes with another schedule length starts a new
    run and resets the state."""

    def __init__(self, config):
        from fastdm_tpu_torch.caching.xcaching import negative_stream_config

        self.config = config
        self.neg_config = negative_stream_config(config)
        self.reset()

    def reset(self):
        self.states = [None, None]  # pos / neg CFG stream
        self._last_step = None
        self._total = None
        self._chunk = 0

    @property
    def skips(self) -> int:
        """Step-skips recorded across both CFG streams."""
        return sum(int(st["skips"]) for st in self.states if st is not None)

    @staticmethod
    def step_from_options(transformer_options) -> Optional[tuple]:
        """(step, total) from the sampler's sigma schedule, in one host read
        of the schedule and the current sigma; None when ComfyUI gave no
        sigmas or the sigma is not in the schedule (the caller then runs
        uncached)."""
        all_s = transformer_options.get("sample_sigmas")
        cur = transformer_options.get("sigmas")
        if all_s is None or cur is None:
            return None
        all_s = all_s.detach().reshape(-1).float()
        both = torch.cat([all_s, cur.detach().reshape(-1)[:1].float().to(all_s.device)]).cpu()
        idx = torch.nonzero(both[:-1] == both[-1]).reshape(-1)
        if idx.numel() == 0:
            return None
        # total = the full schedule's length, as the reference's callback
        return int(idx[0]), int(all_s.shape[0])

    def begin(self, step: int, total: Optional[int] = None,
              marker: Optional[int] = None) -> int:
        """Select the state slot of this call; returns its index.

        Within one sampling run the step only repeats (CFG / cond chunks) or
        advances by one, so a backward move, a jump > 1 or another schedule
        length starts a new run and resets the state. The sampler's label
        (`marker`, from cond_or_uncond: 0 cond, 1 uncond) picks the slot
        when given; else chunk 0 of a step is the positive stream (slot 0)
        and every later chunk shares slot 1."""
        if (self._last_step is None or step < self._last_step
                or step > self._last_step + 1
                or (total is not None and self._total is not None
                    and total != self._total)):
            self.reset()
        if step == self._last_step:
            self._chunk += 1
        else:
            self._chunk = 0
        self._last_step = step
        if total is not None:
            self._total = total
        if marker is not None:
            return min(max(int(marker), 0), 1)
        return min(self._chunk, 1)

    @staticmethod
    def marker_from_options(transformer_options) -> Optional[int]:
        """ComfyUI's cond_or_uncond list (0 = cond, 1 = uncond) -> a slot
        marker: a batched [0, 1] call goes to the positive slot, an
        uncond-only call to slot 1; None when absent or unrecognised."""
        cou = transformer_options.get("cond_or_uncond")
        if cou is None:
            return None
        try:
            vals = {int(v) for v in cou}
        except (TypeError, ValueError):
            return None
        if not vals or not vals <= {0, 1}:
            return None
        return 0 if 0 in vals else 1

    def config_for(self, slot: int):
        return self.config if slot == 0 else self.neg_config

    def ensure_state(self, slot: int, hidden_shape, probe_shape, device="cuda"):
        if self.states[slot] is None:
            from fastdm_tpu_torch.caching.xcaching import cache_init_state

            self.states[slot] = cache_init_state(self.config_for(slot), hidden_shape,
                                                 probe_shape, _BF16, device)
        return self.states[slot]

    def dispatch(self, fwd_cached, transformer_options, hshape, pshape,
                 params, cfg, *fwd_args, **fwd_kwargs):
        """One cached forward: recover the step, pick the slot, run
        fwd_cached(params, cfg, cache_cfg, state, step, total, *fwd_args),
        keep the new state. None when the sampler gave no recoverable step
        (the caller then runs the uncached forward)."""
        step_info = self.step_from_options(transformer_options)
        if step_info is None:
            return None
        step, total = step_info
        slot = self.begin(step, total, marker=self.marker_from_options(transformer_options))
        st = self.ensure_state(slot, hshape, pshape, _params_device(params))
        out, st = fwd_cached(params, cfg, self.config_for(slot), st, step, total,
                             *fwd_args, **fwd_kwargs)
        self.states[slot] = st
        return out


def _make_host_cache(cache) -> Optional[HostStepCache]:
    """AutoCache | CacheConfig | None -> HostStepCache (None when off)."""
    if cache is None:
        return None
    config = getattr(cache, "config", cache)
    if not config.enable_caching:
        return None
    return HostStepCache(config)


def pad_to_patch_size(x: torch.Tensor, patch: int = 2):
    """Pad H / W of an NCHW tensor up to the patch multiple, repeating the
    edge -> (padded, (h, w))."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % patch, (-w) % patch
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return x, (h, w)


def _guidance(guidance, t: torch.Tensor, dev) -> torch.Tensor:
    if guidance is not None:
        return _to(guidance, dev, torch.float32)
    return torch.full(t.shape, 3.5, dtype=torch.float32, device=dev)


class ComfyUIFluxForwardWrapper:
    """Callable with ComfyUI's FLUX diffusion_model signature."""

    def __init__(self, params, cfg, cache=None):
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        self.cache = _make_host_cache(cache)
        self._rope_cache = {}

    @torch.inference_mode()
    def __call__(self, x, timestep, context, y, guidance=None, control=None,
                 transformer_options={}, **kwargs):
        from fastdm_tpu_torch.models.flux import flux_forward, flux_forward_cached, \
            flux_rope_cache
        from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents

        dev = self.device
        xp, (h, w) = pad_to_patch_size(_to(x, dev, torch.float32))
        ht, wt = xp.shape[-2] // 2, xp.shape[-1] // 2
        hidden = flux_pack_latents(xp.to(_BF16))
        ctx, pooled = _to(context, dev), _to(y, dev)
        t = _to(timestep, dev, torch.float32)
        g = _guidance(guidance, t, dev)
        key = (ctx.shape[1], ht, wt)
        if key not in self._rope_cache:
            self._rope_cache[key] = flux_rope_cache(self.cfg, ctx.shape[1], ht, wt, device=dev)
        cos, sin = self._rope_cache[key]
        out = None
        if self.cache is not None:
            hshape = (hidden.shape[0], hidden.shape[1], self.cfg.inner_dim)
            out = self.cache.dispatch(flux_forward_cached, transformer_options, hshape, hshape,
                                      self.params, self.cfg, hidden, ctx, pooled, t, cos, sin,
                                      guidance=g)
        if out is None:
            out = flux_forward(self.params, self.cfg, hidden, ctx, pooled, t, cos, sin,
                               guidance=g)
        return _back(flux_unpack_latents(out, ht, wt)[:, :, :h, :w], x)


def _sdxl_pooled(cfg, y: torch.Tensor, dev):
    """ComfyUI packs the pooled text embedding and 6 sinusoid-encoded time
    ids into y; the pooled width comes from the config. Recovering the ids
    from their sinusoids is lossy, so they ride as zeros, as in JAX."""
    pooled_dim = cfg.add_embedding_in_dim - 6 * cfg.addition_time_embed_dim
    pooled = _to(y[:, :pooled_dim], dev)
    return pooled, torch.zeros((y.shape[0], 6), dtype=torch.float32, device=dev)


class ComfyUISDXLForwardWrapper:
    """Callable with ComfyUI's SDXL UNet signature.

    IP-Adapter: when the UNet carries IP-Adapter k|v weights and ComfyUI's
    IPAdapter extension registered an attn2 patch
    (transformer_options["patches_replace"]["attn2"]), the patch's image
    embeddings are routed per cond_or_uncond and used only while the step's
    sigma lies in [sigma_end, sigma_start]."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)

    def _ip_from_options(self, transformer_options, batch):
        """-> (ip_embeds (B, L, D) | None, ip_scale | None) from the attn2
        patch, sigma-gated and cond / uncond routed."""
        opts = transformer_options or {}
        patches = opts.get("patches_replace", {}).get("attn2") or {}
        if not patches or not self.cfg.ip_adapter:
            return None, None
        patch = next(iter(patches.values()))
        kws = getattr(patch, "kwargs", None)
        if kws is None and isinstance(patch, dict):
            kws = patch.get("kwargs")
        if not kws:
            return None, None
        kw = kws[0] if isinstance(kws, (list, tuple)) else kws
        sig = opts.get("sigmas")
        sigma = float(sig.detach().reshape(-1)[0]) if sig is not None else 999999999.9
        s_start = float(kw.get("sigma_start", 999999999.9))
        s_end = float(kw.get("sigma_end", 0.0))
        if not (s_end <= sigma <= s_start):
            return None, None
        cond = kw.get("cond")
        uncond = kw.get("uncond")
        if cond is None:
            return None, None
        cond_t = _to(cond, self.device)
        uncond_t = _to(uncond, self.device) if uncond is not None else torch.zeros_like(cond_t)
        cou = opts.get("cond_or_uncond") or [0]
        per = max(1, batch // len(cou))
        segs = []
        for marker in cou:
            e = uncond_t if int(marker) == 1 else cond_t
            if e.shape[0] == 1 and per > 1:
                e = e.expand(per, *e.shape[1:])
            segs.append(e[:per])
        embeds = torch.cat(segs, dim=0)
        weight = kw.get("weight", self.cfg.ip_adapter_scale)
        try:
            weight = float(weight)
        except (TypeError, ValueError):
            weight = self.cfg.ip_adapter_scale
        return embeds, weight

    @torch.inference_mode()
    def __call__(self, x, timesteps=None, context=None, y=None, control=None,
                 transformer_options={}, **kwargs):
        from fastdm_tpu_torch.models.sdxl import sdxl_forward

        dev = self.device
        sample = _to(x, dev, torch.float32)
        t = _to(timesteps, dev, torch.float32)
        pooled, time_ids = _sdxl_pooled(self.cfg, y, dev)
        ip_embeds, ip_scale = self._ip_from_options(transformer_options, sample.shape[0])
        out = sdxl_forward(self.params, self.cfg, sample, t, _to(context, dev), pooled, time_ids,
                           ip_embeds=ip_embeds, ip_scale=ip_scale)
        return _back(out, x)


class ComfyUISD3ForwardWrapper:
    """Callable with ComfyUI's SD3 MMDiT signature."""

    def __init__(self, params, cfg, cache=None):
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        self.cache = _make_host_cache(cache)
        self._pos_cache = {}

    @torch.inference_mode()
    def __call__(self, x, timestep=None, context=None, y=None,
                 transformer_options={}, **kwargs):
        from fastdm_tpu_torch.models.sd35 import sd3_cropped_pos_embed, sd3_forward, \
            sd3_forward_cached

        dev = self.device
        sample = _to(x, dev, torch.float32)
        h, w = sample.shape[-2:]
        if (h, w) not in self._pos_cache:
            self._pos_cache[(h, w)] = sd3_cropped_pos_embed(
                self.cfg, self.params.pos_embed_table, h, w, device=dev)
        pos = self._pos_cache[(h, w)]
        # ComfyUI hands the flow sigma in [0, 1]; the forward takes 0..1000
        t = _to(timestep, dev, torch.float32) * 1000.0
        ctx, pooled = _to(context, dev), _to(y, dev)
        out = None
        if self.cache is not None:
            p = self.cfg.patch_size
            hshape = (sample.shape[0], (h // p) * (w // p), self.cfg.inner_dim)
            out = self.cache.dispatch(sd3_forward_cached, transformer_options, hshape, hshape,
                                      self.params, self.cfg, sample, ctx, pooled, t, pos)
        if out is None:
            out = sd3_forward(self.params, self.cfg, sample, ctx, pooled, t, pos)
        return _back(out, x)


class ComfyUIQwenForwardWrapper:
    """Callable with ComfyUI's Qwen-Image signature (latents packed as FLUX's)."""

    def __init__(self, params, cfg, cache=None):
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        self.cache = _make_host_cache(cache)
        self._rope_cache = {}

    @torch.inference_mode()
    def __call__(self, x, timestep=None, context=None, attention_mask=None,
                 transformer_options={}, **kwargs):
        from fastdm_tpu_torch.caching.config import TeaCacheConfig
        from fastdm_tpu_torch.models.qwenimage import qwen_forward, qwen_forward_cached, \
            qwen_rope_cos_sin
        from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents

        dev = self.device
        xp, (h, w) = pad_to_patch_size(_to(x, dev, torch.float32))
        ht, wt = xp.shape[-2] // 2, xp.shape[-1] // 2
        hidden = flux_pack_latents(xp.to(_BF16))
        ctx = _to(context, dev)
        t = _to(timestep, dev, torch.float32)
        key = (ht, wt, ctx.shape[1])
        if key not in self._rope_cache:
            self._rope_cache[key] = qwen_rope_cos_sin(self.cfg, 1, ht, wt, ctx.shape[1],
                                                      device=dev)
        cos, sin = self._rope_cache[key]
        out = None
        if self.cache is not None:
            hshape = (hidden.shape[0], hidden.shape[1], self.cfg.inner_dim)
            # Qwen's TeaCache probes the text stream's modulated input
            pshape = ((ctx.shape[0], ctx.shape[1], self.cfg.inner_dim)
                      if isinstance(self.cache.config, TeaCacheConfig) else hshape)
            out = self.cache.dispatch(qwen_forward_cached, transformer_options, hshape, pshape,
                                      self.params, self.cfg, hidden, ctx, t, cos, sin)
        if out is None:
            out = qwen_forward(self.params, self.cfg, hidden, ctx, t, cos, sin)
        return _back(flux_unpack_latents(out, ht, wt)[:, :, :h, :w], x)


class ComfyUISDXLControlnetForwardWrapper:
    """control_model callable for comfy.controlnet.ControlNet: returns the
    {'middle': [mid], 'output': [down...]} residual dict ComfyUI applies to
    the UNet, NCHW as the port computes them."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)

    @torch.inference_mode()
    def __call__(self, x, hint=None, timesteps=None, context=None, y=None, **kwargs):
        from fastdm_tpu_torch.models.controlnets import sdxl_controlnet_forward

        dev = self.device
        pooled, time_ids = _sdxl_pooled(self.cfg, y, dev)
        # the hint is (B, 3, H, W) in [0, 1]
        down, mid = sdxl_controlnet_forward(
            self.params, self.cfg, _to(x, dev, torch.float32),
            _to(timesteps, dev, torch.float32), _to(context, dev), pooled, time_ids,
            _to(hint, dev, torch.float32))
        return {"middle": [_back(mid, x)], "output": [_back(d, x) for d in down]}


class ComfyUIFluxControlnetForwardWrapper:
    """control_model callable for FLUX ControlNets: the per-layer residual
    dict ('input' = dual blocks, 'output' = single blocks). A latent hint
    is packed as the latents are; a raw-hint ControlNet (input_hint_block)
    takes the hint image itself, NCHW, which the JAX wrapper would pack."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg
        self.device = _params_device(params)
        self._rope_cache = {}

    @torch.inference_mode()
    def __call__(self, x, hint=None, timesteps=None, context=None, y=None,
                 guidance=None, **kwargs):
        from fastdm_tpu_torch.models.controlnets import flux_controlnet_forward
        from fastdm_tpu_torch.models.flux import flux_rope_cache
        from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents

        dev = self.device
        xp, _ = pad_to_patch_size(_to(x, dev, torch.float32))
        ht, wt = xp.shape[-2] // 2, xp.shape[-1] // 2
        hidden = flux_pack_latents(xp.to(_BF16))
        if self.params.input_hint_block is not None:
            cnd = _to(hint, dev)
        else:
            hp, _ = pad_to_patch_size(_to(hint, dev, torch.float32))
            cnd = flux_pack_latents(hp.to(_BF16))
        ctx, pooled = _to(context, dev), _to(y, dev)
        t = _to(timesteps, dev, torch.float32)
        g = _guidance(guidance, t, dev)
        key = (ctx.shape[1], ht, wt)
        if key not in self._rope_cache:
            self._rope_cache[key] = flux_rope_cache(self.cfg, ctx.shape[1], ht, wt, device=dev)
        cos, sin = self._rope_cache[key]
        bs, sbs = flux_controlnet_forward(self.params, self.cfg, hidden, cnd, ctx, pooled, t,
                                          cos, sin, guidance=g)
        out = {}
        if bs is not None:
            out["input"] = [_back(bs[i], x) for i in range(bs.shape[0])]
        if sbs is not None:
            out["output"] = [_back(sbs[i], x) for i in range(sbs.shape[0])]
        return out
