"""FastDMEngine — the end-user engine of the port (FLUX text-to-image subset
of fastdm_tpu/engine.py).

    eng = FastDMEngine("/path/to/FLUX.1-dev", architecture="flux",
                       cache_config={"cache_algorithm": "teacache", ...})
    images = eng.generate(prompt_embeds=..., pooled_prompt_embeds=...,
                          height=1024, width=1024, num_inference_steps=25)

Reads a diffusers-layout checkpoint directory (transformer/ and vae/, each
with optional config.json overrides) onto the GPU ("cuda" unless the caller
passes device="cpu"): in bf16, or with use_int8 / use_fp8 the transformer
blocks' linears quantized at load time to W8A8 (quant_mods=True quantizes the
AdaLN modulations too). The T5/CLIP text encoders, int4, img2img/Kontext,
ControlNet and the other model families arrive with later slices and raise
NotImplementedError here.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from fastdm_tpu_torch.caching.config import CacheConfig
from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.loader import TensorSource, as_tensor
from fastdm_tpu_torch.pipeline.schedulers import FlowMatchEulerScheduler, flow_match_shift_mu
from fastdm_tpu_torch.pipeline.vae import VAEConfig, vae_decode, vae_load

ARCHITECTURES = ("flux",)

# per-model VAE configs (diffusers AutoencoderKL variants)
VAE_CONFIGS = {
    "flux": VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159),
}


def _read_json(path):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


class FastDMEngine:
    def __init__(
        self, model_path: str, architecture: str = "flux", use_fp8: bool = False,
        use_int8: bool = False, cache_config: Optional[Union[str, Dict[str, Any]]] = None,
        verbose: bool = True, device="cuda", quant_mods: bool = False,
    ):
        if architecture not in ARCHITECTURES:
            raise NotImplementedError(
                f"architecture {architecture!r} is not in this slice of the port "
                f"(have {ARCHITECTURES})")
        if use_fp8 and use_int8:
            raise ValueError("use_fp8 / use_int8 are mutually exclusive")
        self.quant = "fp8" if use_fp8 else ("int8" if use_int8 else None)
        self.quant_mods = quant_mods
        self.architecture = architecture
        self.model_path = model_path
        self.device = resolve_device(device)
        self.verbose = verbose
        t0 = time.perf_counter()

        self.cache_config: Optional[CacheConfig] = None
        if cache_config is not None:
            self.cache_config = (CacheConfig.from_json(cache_config)
                                 if isinstance(cache_config, str)
                                 else CacheConfig.from_dict(cache_config))
        self._init_flux()
        self._denoisers: Dict[tuple, Any] = {}
        # skip count of the most recent generate() under a step cache
        self.last_cache_skips = 0
        if verbose:
            print(f"FastDMEngine[{architecture}] loaded in {time.perf_counter() - t0:.1f}s "
                  f"({self.quant or 'bf16'}, device={self.device})")

    # ------------------------------------------------------------ loaders

    def _cfg_overrides(self, subdir: str, keys, transforms=None) -> Dict[str, Any]:
        """Model hyperparameters from the checkpoint's config.json, when present."""
        p = os.path.join(self.model_path, subdir, "config.json")
        if not os.path.exists(p):
            return {}
        cj = _read_json(p)
        out = {k: cj[k] for k in keys if cj.get(k) is not None}
        for k, fn in (transforms or {}).items():
            if cj.get(k) is not None:
                out.update(fn(cj[k]))
        return out

    def _init_flux(self) -> None:
        from fastdm_tpu_torch.models.flux import FluxConfig, flux_load

        kw = self._cfg_overrides(
            "transformer",
            ("patch_size", "in_channels", "out_channels", "num_layers", "num_single_layers",
             "attention_head_dim", "num_attention_heads", "joint_attention_dim",
             "pooled_projection_dim", "guidance_embeds"),
            {"axes_dims_rope": lambda v: {"axes_dims_rope": tuple(v)}})
        self.cfg = FluxConfig(quant=self.quant, quant_mods=self.quant_mods, **kw)
        self.params = flux_load(TensorSource.from_path(
            os.path.join(self.model_path, "transformer"), self.device), self.cfg)
        vae_kw = self._cfg_overrides(
            "vae", ("latent_channels", "layers_per_block", "norm_num_groups",
                    "scaling_factor", "shift_factor", "mid_block_add_attention"),
            {"block_out_channels": lambda v: {"block_out_channels": tuple(v)}})
        self.vae_cfg = dataclasses.replace(VAE_CONFIGS[self.architecture], **vae_kw)
        self.vae_params = vae_load(TensorSource.from_path(
            os.path.join(self.model_path, "vae"), self.device), self.vae_cfg)

    # ------------------------------------------------------------ generate

    def generate(self, prompt=None, task: str = "t2i", **kw):
        """Text-to-image (height, width, num_inference_steps, guidance_scale,
        seed, prompt_embeds, pooled_prompt_embeds, output_type)."""
        if task != "t2i" or kw.get("image") is not None:
            raise NotImplementedError(f"task {task!r} is not in this slice of the port (t2i is)")
        kw.pop("image", None)
        return self._generate_flux(prompt, **kw)

    def _device_tensor(self, x, dtype) -> torch.Tensor:
        return as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
            device=self.device, dtype=dtype)

    def _generate_flux(self, prompt=None, height: int = 1024, width: int = 1024,
                       num_inference_steps: int = 25, guidance_scale: float = 3.5,
                       seed: int = 42, prompt_embeds=None, pooled_prompt_embeds=None,
                       output_type: str = "np"):
        from fastdm_tpu_torch.models.flux import flux_rope_cache
        from fastdm_tpu_torch.pipeline.denoise import flux_unpack_latents, make_flux_denoiser

        if prompt_embeds is None or pooled_prompt_embeds is None:
            raise NotImplementedError(
                "the T5/CLIP text encoders are not in this slice of the port; pass "
                "prompt_embeds and pooled_prompt_embeds")
        del prompt
        encoder = self._device_tensor(prompt_embeds, torch.bfloat16)
        pooled = self._device_tensor(pooled_prompt_embeds, torch.bfloat16)
        b = encoder.shape[0]
        ht, wt = height // 16, width // 16
        cos, sin = flux_rope_cache(self.cfg, encoder.shape[1], ht, wt, device=self.device)

        key = ("flux", ht, wt, num_inference_steps, guidance_scale)
        if key not in self._denoisers:
            sched = FlowMatchEulerScheduler.create(
                num_inference_steps, use_dynamic_shifting=True, mu=flow_match_shift_mu(ht * wt))
            self._denoisers[key] = make_flux_denoiser(
                self.cfg, sched, num_inference_steps, self.cache_config, guidance_scale)
        # a seeded torch.Generator: the same seed gives other noise than the
        # JAX engine's jax.random key
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = torch.randn((b, ht * wt, self.cfg.in_channels), generator=gen,
                              device=self.device, dtype=torch.float32)
        latents, skips = self._denoisers[key](self.params, latents, encoder, pooled, cos, sin)
        if self.cache_config is not None:
            self.last_cache_skips = int(skips)
            if self.verbose:
                print(f"cache skipped {self.last_cache_skips} transformer passes")
        if output_type == "latent":
            return latents.cpu().numpy()
        img = vae_decode(self.vae_params, self.vae_cfg, flux_unpack_latents(latents, ht, wt))
        img = (img * 0.5 + 0.5).clamp(0.0, 1.0)
        return (img * 255).round().to(torch.uint8).cpu().numpy()
