"""FastDMEngine — the end-user engine of the port (the FLUX, SD3.5, SDXL and
Qwen-Image text-to-image and the Wan2.1 / Wan2.2 text- and image-to-video
subsets of fastdm_tpu/engine.py).

    eng = FastDMEngine("/path/to/FLUX.1-dev", architecture="flux",
                       use_int4=True, pack_int4=True, quant_mods=True,
                       cache_config={"cache_algorithm": "teacache", ...})
    images = eng.generate(prompt="a photo of a cat", height=1024, width=1024,
                          num_inference_steps=25)
    images = eng.generate(prompt_embeds=..., pooled_prompt_embeds=...,
                          height=1024, width=1024, num_inference_steps=25)

    eng = FastDMEngine("/path/to/stable-diffusion-xl-base-1.0", architecture="sdxl",
                       use_int8=True)
    images = eng.generate(prompt="a photo of a cat", negative_prompt="blurry",
                          height=1024, width=2048, guidance_scale=5.0)

    eng = FastDMEngine("/path/to/stable-diffusion-3.5-medium", architecture="sd35",
                       use_int8=True, cache_config="teacache_sd35.json")
    images = eng.generate(prompt=["a cat", "a dog"], num_images_per_prompt=2,
                          height=1024, width=2048, guidance_scale=7.0)
    images = eng.generate(prompt_embeds=..., pooled_prompt_embeds=...,
                          negative_prompt_embeds=..., negative_pooled_prompt_embeds=...,
                          height=1024, width=2048, guidance_scale=7.0)

    eng = FastDMEngine("/path/to/Qwen-Image", architecture="qwen-image", use_int4=True,
                       pack_int4=True, quant_mods=True)
    images = eng.generate(prompt_embeds=..., height=1024, width=2048, true_cfg_scale=1.0)

    eng = FastDMEngine("/path/to/FLUX.1-Kontext-dev", architecture="flux-kontext", use_int8=True)
    images = eng.generate(task="i2i", image=[ref_uint8_hxwx3, ...], prompt_embeds=...,
                          pooled_prompt_embeds=..., guidance_scale=2.5)

    eng = FastDMEngine("/path/to/Wan2.2-T2V-A14B", architecture="wan2.2-t2v",
                       use_int8=True, sparse_attn_config="radial_attn_wan.json",
                       cache_config="fbcache_wan.json")
    video = eng.generate(prompt="a fox in the snow", negative_prompt="static",
                         height=480, width=832, num_frames=81)

    eng = FastDMEngine("/path/to/Wan2.1-I2V-14B-480P", architecture="wan2.1-i2v",
                       use_int8=True)
    video = eng.generate(task="i2v", image=first_frame_uint8_hxwx3, prompt="a fox runs",
                         height=480, width=832, num_frames=81)

    eng = FastDMEngine("/path/to/stable-diffusion-xl-base-1.0", architecture="sdxl",
                       use_int8=True, ip_adapter_path="/path/to/IP-Adapter/sdxl_models")
    images = eng.generate(prompt="a cat", ip_adapter_image=style_uint8_hxwx3)

    eng = FastDMEngine("/path/to/Wan2.2-TI2V-5B", architecture="wan2.2-ti2v",
                       use_int8=True, cache_config="fbcache_wan.json")
    video = eng.generate(task="ti2v", image=first_frame_uint8_hxwx3,
                         prompt_embeds=..., negative_prompt_embeds=...,
                         height=768, width=768, num_frames=121, num_inference_steps=50)

Reads a diffusers-layout checkpoint directory (transformer/ — and, for the
Wan2.2-A14B dual expert, transformer_2/ — or SDXL's unet/, and vae/, with
their config.json and model_index.json) onto the GPU ("cuda" unless the
caller passes device="cpu"): in bf16, or with use_int8 / use_fp8 the
transformer blocks' linears (SDXL: also proj_in/out and the resnets'
time_emb_proj; SD3.5: also norm_out and proj_out) quantized at load time to
W8A8, or with use_int4 to W4A4 (+ SVDQuant low-rank branch; pack_int4 stores
the int4 values two per byte) (quant_mods=True quantizes the FLUX and
Qwen-Image modulations too). FLUX, SD3.5 and Qwen-Image take TeaCache,
FBCache or DiCache, Wan FBCache or DiCache; SDXL has no step cache (a
cache_config raises). Qwen-Image decodes through the Wan VAE decoder when
vae/config.json carries base_dim (AutoencoderKLQwenImage), else through the
AutoencoderKL. Wan's radial sparse attention runs in the mode
FASTDM_SPARSE_GATHER names: super (the default), fine, coarse or mask. Wan
takes task "t2v", "i2v" (an image: a 4-channel frame mask and the VAE-encoded
first frame concatenated to the latents, Wan2.2-I2V-A14B's in_channels 36)
or, with architecture "wan2.2-ti2v", "ti2v" / "i2v" (Wan2.2-TI2V-5B: the
encoded image pinned as the first latent frame, its tokens at timestep 0);
its scheduler is UniPC, or FlowMatch-Euler with scheduler="euler". A Wan
transformer with the image embedder (Wan2.1-I2V, "wan2.1-i2v" / "wan-i2v":
image_dim and added_kv_proj_dim in transformer/config.json) also conditions
i2v on the CLIP vision tower of image_encoder/: the image's penultimate
hidden states, the same for both CFG branches (one expert only: the
dual-expert loop raises on them, as the JAX engine).
FLUX, SD3.5 and SDXL take an input image (task "i2i", or an image with no
task): SDEdit img2img from the AutoencoderKL-encoded image, noised to the
step that strength sets; architecture "flux-kontext" appends the clean tokens
of one or more reference images instead, and Qwen-Image ("qwen-image-edit")
appends the encoded source images' tokens. vae_tiling / vae_slicing (or
enable_vae_tiling() / enable_vae_slicing()) decode and encode the
AutoencoderKL in tiles or one sample at a time.

FLUX and SDXL take a ControlNet checkpoint directory (controlnet_path; FLUX's
hyperparameters from its config.json) and then generate(control_image=an
(H, W, 3) uint8 hint, controlnet_conditioning_scale=, FLUX's control_mode= for
a union checkpoint, SDXL's guess_mode=); SDXL takes an IP-Adapter checkpoint
(ip_adapter_path, ip_adapter_scale) and then generate(ip_adapter_image=an
(H, W, 3) uint8 image), encoded by the CLIP vision tower of
<model_path>/image_encoder/ (read at the first image), or
generate(ip_adapter_image_embeds=): the CLIP image embeddings, (B, D)
projected for ip-adapter_sdxl or (B, S, hidden) penultimate states for
IP-Adapter-Plus; given embeddings win over an image.

snapshot_path names a quantized-snapshot directory (models/snapshot.py): when
it holds a snapshot, the denoiser modules (transformer, Wan's transformer_2,
SDXL's unet) are read from it onto the device, checked against the engine's
architecture, quant and config and against the checkpoint's weight files
(FASTDM_SNAPSHOT_ALLOW_MISMATCH=1 overrides the last check), and nothing is
quantized; when it is empty, the freshly built modules are written there
after init. save_quantized(dir) writes them at any time. A snapshot is
written by the port and read only by the port; the VAE, ControlNet and
IP-Adapter weights are not in it.

Prompt strings are encoded on the engine's device by the port's own
tokenizers and CLIP / T5 / UMT5 modules in f32 (pipeline/text_encoder.py),
from the checkpoint's tokenizer*/ and text_encoder*/ directories, read at the
first prompt: FLUX (and flux-kontext) CLIP-L + T5 at max_sequence_length
(the constructor's; default 512), SD3.5 CLIP-L + bigG + T5 at 256, SDXL
CLIP-L + bigG, Wan UMT5 at the config's text_len. generate() takes prompt,
negative_prompt (SD3.5 and SDXL encode it, "" when None, only under CFG;
Wan always; FLUX ignores it) and, for FLUX / SD3.5 / SDXL,
num_images_per_prompt; embeddings passed as keywords win over the strings.
A prompt on a checkpoint without those directories raises FileNotFoundError
naming the missing one. Images for the IP-Adapters and Wan2.1-I2V go through
the port's CLIP preprocessing (transformers' pixel_values bit for bit, with
no PIL) and vision tower in f32 on the engine's device (CLIPImageEncoder);
a missing image_encoder/ raises FileNotFoundError naming it.

The Qwen2.5-VL text encoder (Qwen-Image prompts) and the other model
families arrive with later slices and raise NotImplementedError here.
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
from fastdm_tpu_torch.pipeline.text_encoder import CLIPImageEncoder, FluxTextEncoder, \
    SD3TextEncoder, SDXLTextEncoder, WanTextEncoder
from fastdm_tpu_torch.pipeline.vae import VAEConfig, vae_decode, vae_encode, vae_load

# accepted names -> the model family (JAX's ARCH_ALIASES, the loaded subset)
ARCHITECTURES = {"flux": "flux", "flux-dev": "flux", "flux-krea": "flux",
                 "flux-kontext": "flux", "sd35": "sd35", "sd3.5": "sd35", "sdxl": "sdxl",
                 "qwen-image": "qwen", "qwen-image-edit": "qwen", "wan2.2-t2v": "wan",
                 "wan2.2-i2v": "wan", "wan2.2-ti2v": "wan", "wan": "wan", "wan2.1-t2v": "wan",
                 "wan-i2v": "wan", "wan2.1-i2v": "wan"}

# Long-video capacity thresholds (tokens) at which a Wan generate turns on
# FFN token chunking and, for the dual expert, the split-QKV projection; kept
# as the JAX engine's (fastdm_tpu/engine.py:45-46)
_FFN_CHUNK_MIN_TOKENS = 30000
_SPLIT_QKV_MIN_TOKENS = 60000

# per-model VAE configs (diffusers AutoencoderKL variants)
VAE_CONFIGS = {
    "flux": VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159),
    "sd35": VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609),
    "sdxl": VAEConfig(latent_channels=4, scaling_factor=0.13025, shift_factor=0.0),
    "qwen": VAEConfig(latent_channels=16, scaling_factor=1.0, shift_factor=0.0),
}


def wan_capacity_config(cfg, tokens: int, dual: bool):
    """The long-video capacity knobs for a `tokens`-token video, derived per
    generate as the JAX engine does (fastdm_tpu/engine.py:1345-1369): FFN token
    chunks of tokens/8 from _FFN_CHUNK_MIN_TOKENS on, and for the dual expert
    the split-QKV projection from _SPLIT_QKV_MIN_TOKENS on."""
    chunk = tokens // 8 if tokens >= _FFN_CHUNK_MIN_TOKENS and tokens % 8 == 0 else 0
    return dataclasses.replace(
        cfg, ffn_chunk_tokens=chunk,
        split_qkv_proj=bool(chunk) and dual and tokens >= _SPLIT_QKV_MIN_TOKENS)


SPARSE_GATHER_MODES = ("super", "fine", "coarse", "mask")


def wan_sparse_tables(sparse_attn, cfg, tokens: int, num_frame: int, device, mode: str = "super"):
    """The radial sparse tables of a video shape in one of the four modes of
    the JAX engine (fastdm_tpu/engine.py:1384-1452) -> (cfg synced to them,
    the sparse mask wan_forward takes, as tensors on `device`):
      super  -- superblock tables: q tiles of 256 tokens, groups of 32 fine
                blocks (8 superblock entries), fine = the radial config's
                block_size, superblocks of 4;
      fine   -- fine tables at cfg.sparse_gather_fine_blocks (block_q, group)
                with fine = block_size, superblock 1;
      coarse -- coarse lists at cfg.sparse_gather_blocks (block_q, block_k);
      mask   -- the block mask of every head at 128x128 tiles.
    The strict value checks run here, once, on the host's numpy tables; the
    kernel wrappers never read them."""
    from fastdm_tpu_torch.kernels import contracts

    fine = sparse_attn.config.block_size
    sparse_attn.post_init(video_token_num=tokens, num_frame=num_frame)
    what = f"engine.wan {mode} tables"
    if mode in ("super", "fine"):
        bq, grp, sb = (256, 32, 4) if mode == "super" else (*cfg.sparse_gather_fine_blocks[:2], 1)
        cfg = dataclasses.replace(cfg, sparse_gather_fine_blocks=(bq, grp, fine),
                                  sparse_gather_superblock=sb)
        if sb > 1:
            tables = sparse_attn.block_lists_super(bq, grp // sb, sb)
            contracts.check_gather_super(what, *tables, tokens, tokens, bq, grp // sb, fine, sb,
                                         strict=True)
        else:
            tables = sparse_attn.block_lists_fine(bq, grp)
            contracts.check_gather_fine(what, *tables, tokens, tokens, bq, grp, fine,
                                        strict=True)
    elif mode == "coarse":
        bq, bk = cfg.sparse_gather_blocks
        tables = sparse_attn.block_lists(bq, bk)
        contracts.check_gather_lists(what, *tables, tokens, tokens, bq, bk, strict=True)
    elif mode == "mask":
        mask = sparse_attn.block_mask(1, cfg.num_attention_heads, block_tokens=128)
        contracts.check_sparse_mask(what, mask, 1, cfg.num_attention_heads, tokens, tokens, 128,
                                    128, strict=True)
        return cfg, torch.from_numpy(mask).to(device)
    else:
        raise ValueError(f"FASTDM_SPARSE_GATHER={mode!r}: expected one of {SPARSE_GATHER_MODES}")
    return cfg, tuple(torch.from_numpy(t).to(device) for t in tables)


def _read_json(path):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _resize_to_multiple(img: np.ndarray, m: int) -> np.ndarray:
    """An HWC uint8 image resized down to sides divisible by m (the VAE and
    patch granularity), as diffusers' edit pipelines do before encoding
    (fastdm_tpu/engine.py:73-91): a LANCZOS resize with PIL; without PIL a
    center crop, edge-padded first where a side is below m."""
    h, w = img.shape[0], img.shape[1]
    nh, nw = max(m, h // m * m), max(m, w // m * m)
    if (nh, nw) == (h, w):
        return img
    try:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((nw, nh), Image.LANCZOS))
    except ImportError:
        if nh > h or nw > w:
            img = np.pad(img, ((0, max(0, nh - h)), (0, max(0, nw - w)), (0, 0)), mode="edge")
            h, w = img.shape[0], img.shape[1]
        top, left = (h - nh) // 2, (w - nw) // 2
        return img[top:top + nh, left:left + nw]


class FastDMEngine:
    def __init__(
        self, model_path: str, architecture: str = "flux", use_fp8: bool = False,
        use_int8: bool = False, cache_config: Optional[Union[str, Dict[str, Any]]] = None,
        verbose: bool = True, device="cuda", quant_mods: bool = False,
        sparse_attn_config: Optional[Union[str, Dict[str, Any]]] = None,
        use_int4: bool = False, pack_int4: bool = False, scheduler: Optional[str] = None,
        vae_tiling: bool = False, vae_slicing: bool = False,
        controlnet_path: Optional[str] = None, ip_adapter_path: Optional[str] = None,
        ip_adapter_scale: float = 0.6, snapshot_path: Optional[str] = None,
        max_sequence_length: int = 512,
    ):
        if architecture not in ARCHITECTURES:
            raise NotImplementedError(
                f"architecture {architecture!r} is not in this slice of the port "
                f"(have {sorted(ARCHITECTURES)})")
        # the JAX engine's scheduler option (fastdm_tpu/engine.py:125-136): Wan only
        if scheduler not in (None, "unipc", "euler"):
            raise ValueError(f"scheduler must be 'unipc' or 'euler', got {scheduler!r}")
        if scheduler is not None and ARCHITECTURES[architecture] != "wan":
            raise ValueError(f"scheduler={scheduler!r} is only supported for wan; "
                             f"{ARCHITECTURES[architecture]} uses its fixed per-family scheduler")
        self.scheduler_name = scheduler
        # diffusers' enable_vae_tiling / enable_vae_slicing, engine state as in JAX
        self.vae_tiling, self.vae_slicing = vae_tiling, vae_slicing
        # the JAX engine's checks (fastdm_tpu/engine.py:141-176)
        if sum((use_fp8, use_int8, use_int4)) > 1:
            raise ValueError("use_fp8 / use_int8 / use_int4 are mutually exclusive")
        if pack_int4 and not use_int4:
            raise ValueError("pack_int4 requires use_int4")
        self.quant = ("fp8" if use_fp8 else "int8" if use_int8 else
                      ("int4p" if pack_int4 else "int4") if use_int4 else None)
        self.quant_mods = quant_mods
        self.architecture = ARCHITECTURES[architecture]
        self.architecture_full = architecture
        # the JAX engine's family checks (fastdm_tpu/engine.py:249-251,479-481),
        # made before any weight is read
        if controlnet_path is not None and self.architecture not in ("flux", "sdxl"):
            raise ValueError(f"ControlNet is supported for flux/sdxl, not {self.architecture}")
        if ip_adapter_path is not None and self.architecture != "sdxl":
            raise ValueError("ip_adapter_path is supported for sdxl only")
        self.model_path = model_path
        self.device = resolve_device(device)
        self.verbose = verbose
        # the prompt encoder of the family, read at the first prompt; the
        # constructor's max_sequence_length is FLUX's T5 length only
        # (fastdm_tpu/engine.py:107,626), SD3.5 keeps 256 and Wan text_len
        self.max_sequence_length = max_sequence_length
        self.text_encoder = None
        t0 = time.perf_counter()

        self.cache_config: Optional[CacheConfig] = None
        if cache_config is not None:
            self.cache_config = (CacheConfig.from_json(cache_config)
                                 if isinstance(cache_config, str)
                                 else CacheConfig.from_dict(cache_config))
        # the quantized snapshot (models/snapshot.py): a snapshot at
        # snapshot_path gives the denoiser modules straight from its files;
        # an empty snapshot_path receives the freshly built ones after init
        self.snapshot_path = snapshot_path
        self._snapshot_pending: Dict[str, Any] = {}
        self._loaded_trees: Dict[str, Any] = {}
        self._snapshot_manifest = None
        self.sparse_attn = None
        if sparse_attn_config is not None:
            from fastdm_tpu_torch.sparse.xsparse import SparseAttn

            if self.architecture != "wan":
                raise ValueError("sparse_attn_config applies to Wan only")
            self.sparse_attn = (SparseAttn.from_json(sparse_attn_config)
                                if isinstance(sparse_attn_config, str)
                                else SparseAttn.from_dict(sparse_attn_config))
        if self.architecture == "wan":
            from fastdm_tpu_torch.caching.config import DiCacheConfig, FBCacheConfig

            if self.cache_config is not None and not isinstance(
                    self.cache_config, (FBCacheConfig, DiCacheConfig)):
                raise ValueError("Wan caching supports FBCache / DiCache, got "
                                 f"{type(self.cache_config).__name__}")
            self._init_wan()
        elif self.architecture == "sdxl":
            if self.cache_config is not None:
                raise ValueError("the SDXL denoiser has no step cache (the JAX one ignores a "
                                 "cache_config); pass cache_config=None")
            self._init_sdxl()
        elif self.architecture == "sd35":
            self._init_sd35()
        elif self.architecture == "qwen":
            self._init_qwen()
        else:
            self._init_flux()
        # the config a snapshot is checked against and saved with, pinned
        # before the IP-Adapter's replace and generate's runtime tuning
        self._manifest_cfg = self.cfg
        if snapshot_path and self._snapshot_pending:
            self.save_quantized(snapshot_path)
            self._snapshot_pending = {}
        # the optional ControlNet, then the SDXL IP-Adapter (fastdm_tpu/engine.py:240-262)
        self.cn_params = self.cn_cfg = None
        if controlnet_path is not None:
            self._load_controlnet(controlnet_path)
        self.ip_proj = self.image_encoder = None
        if ip_adapter_path is not None:
            from fastdm_tpu_torch.models.sdxl import sdxl_attach_ip_adapter

            self.cfg = dataclasses.replace(self.cfg, ip_adapter_scale=ip_adapter_scale)
            self.ip_proj = sdxl_attach_ip_adapter(
                self.params, TensorSource.from_path(ip_adapter_path, self.device), self.cfg)
            # the CLIP vision tower of an ip_adapter_image, read at the first image
            self.image_encoder = CLIPImageEncoder(
                os.path.join(self.model_path, "image_encoder"), self.device)
        self._denoisers: Dict[tuple, Any] = {}
        # skip count of the most recent generate() under a step cache
        self.last_cache_skips = 0
        if verbose:
            print(f"FastDMEngine[{architecture}] loaded in {time.perf_counter() - t0:.1f}s "
                  f"({self.quant or 'bf16'}, device={self.device})")

    # ------------------------------------------------------------ loaders

    def _load_tree(self, name: str, build_fn):
        """The denoiser module `name` from the snapshot at snapshot_path when
        there is one (checked against this engine's architecture, quant and
        config, then against the checkpoint's weight files), else from
        build_fn, queued for the snapshot when snapshot_path is set
        (fastdm_tpu/engine.py:337-371)."""
        from fastdm_tpu_torch.models import snapshot as snap

        sp = self.snapshot_path
        if sp and snap.is_snapshot(sp):
            if self._snapshot_manifest is None:
                manifest = snap.load_manifest(sp)
                snap.check_compatible(manifest, architecture=self.architecture_full,
                                      quant=self.quant, cfg=self.cfg)
                extra = manifest.get("extra", {})
                base, want = extra.get("model_path"), extra.get("source_files")
                if want is not None:
                    if (snap.source_fingerprint(self.model_path) != want
                            and os.environ.get("FASTDM_SNAPSHOT_ALLOW_MISMATCH") != "1"):
                        raise ValueError(
                            f"snapshot {sp} was built from a checkpoint whose weight files "
                            f"differ from {self.model_path!r} (built from {base!r}); delete "
                            "the snapshot dir to rebuild it, or set "
                            "FASTDM_SNAPSHOT_ALLOW_MISMATCH=1 if the weights are "
                            "known-identical")
                elif base and os.path.realpath(base) != os.path.realpath(self.model_path):
                    print(f"snapshot {sp} was built from {base!r}; serving it for "
                          f"model_path={self.model_path!r} — delete the snapshot dir if the "
                          "weights differ", flush=True)
                self._snapshot_manifest = manifest
            tree = snap.load_tree(sp, name, self._snapshot_manifest, device=self.device)
        else:
            tree = build_fn()
            if sp:
                self._snapshot_pending[name] = tree
        self._loaded_trees[name] = tree
        return tree

    def save_quantized(self, dir_path: str) -> None:
        """Write the loaded, already quantized denoiser modules as a snapshot:
        a later FastDMEngine(..., snapshot_path=dir_path) reads them without
        parsing, fusing or quantizing the checkpoint. The snapshot is the
        port's own; the JAX engine does not read it, nor the port JAX's."""
        from fastdm_tpu_torch.models import snapshot as snap

        trees = dict(self._loaded_trees)
        snap.save_snapshot(dir_path, trees, architecture=self.architecture_full,
                           quant=self.quant, cfg=self._manifest_cfg,
                           extra={"model_path": self.model_path,
                                  "source_files": snap.source_fingerprint(self.model_path)})
        if self.verbose:
            print(f"quantized snapshot written to {dir_path} ({', '.join(sorted(trees))})",
                  flush=True)

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
        self.params = self._load_tree("transformer", lambda: flux_load(TensorSource.from_path(
            os.path.join(self.model_path, "transformer"), self.device), self.cfg))
        self._load_vae()
        self.text_encoder = FluxTextEncoder(self.model_path, self.max_sequence_length,
                                            self.device)

    def _load_vae(self) -> None:
        """The AutoencoderKL of vae/, VAE_CONFIGS[architecture] overridden by
        its config.json. Qwen-Image's own VAE (AutoencoderKLQwenImage, a
        Wan-style causal 3D VAE: base_dim in its config.json) loads as the
        Wan VAE instead, as the JAX engine routes it."""
        if self.architecture == "qwen" and "base_dim" in self._cfg_overrides("vae", ("base_dim",)):
            from fastdm_tpu_torch.pipeline.wan_vae import wan_vae_load

            self.vae_cfg = self._wan_vae_cfg()
            self.vae_params = wan_vae_load(TensorSource.from_path(
                os.path.join(self.model_path, "vae"), self.device), self.vae_cfg)
        else:
            vae_kw = self._cfg_overrides(
                "vae", ("latent_channels", "layers_per_block", "norm_num_groups",
                        "scaling_factor", "shift_factor", "mid_block_add_attention"),
                {"block_out_channels": lambda v: {"block_out_channels": tuple(v)}})
            self.vae_cfg = dataclasses.replace(VAE_CONFIGS[self.architecture], **vae_kw)
            self.vae_params = vae_load(TensorSource.from_path(
                os.path.join(self.model_path, "vae"), self.device), self.vae_cfg)
        self._bind_vae_fns()

    def _bind_vae_fns(self) -> None:
        """Pick self._decode ((B, C, h, w) latents -> (B, H, W, 3)) and
        self._encode ((B, H, W, 3) in [-1, 1] -> latents) from the tiling and
        slicing flags (fastdm_tpu/engine.py:483-590). The Wan-layout VAE runs
        one frame through wan_vae_decode / wan_vae_encode, whole, whatever
        the flags (the JAX engine binds it so at load; its enable_* calls
        would then rebind the AutoencoderKL functions to a Wan config)."""
        from fastdm_tpu_torch.pipeline.vae import vae_decode_sliced, vae_decode_tiled, \
            vae_encode_tiled
        from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig, wan_vae_decode, \
            wan_vae_encode

        cfg = self.vae_cfg
        if isinstance(cfg, WanVAEConfig):
            if self.vae_tiling or self.vae_slicing:
                print("warning: vae tiling/slicing not supported on the 3D (qwen/wan) VAE "
                      "path; running full-frame", flush=True)
            self._decode = lambda p, z: wan_vae_decode(p, cfg, z[:, :, None])[:, 0]
            self._encode = lambda p, x: wan_vae_encode(p, cfg, x[:, None])[:, :, 0]
            return
        if self.vae_tiling:
            self._decode = lambda p, z: vae_decode_tiled(p, cfg, z)
        elif self.vae_slicing:
            self._decode = lambda p, z: vae_decode_sliced(p, cfg, z)
        else:
            self._decode = lambda p, z: vae_decode(p, cfg, z)

        def enc_params(p):
            if "encoder" not in p:
                raise ValueError("this VAE checkpoint has no encoder weights: i2i / edit tasks "
                                 "need the full AutoencoderKL, not a decoder-only one")
            return p["encoder"]

        if self.vae_tiling:
            self._encode = lambda p, x: vae_encode_tiled(enc_params(p), cfg, x)
        else:
            self._encode = lambda p, x: vae_encode(enc_params(p), cfg, x)

    def enable_vae_tiling(self) -> None:
        self.vae_tiling = True
        self._bind_vae_fns()

    def disable_vae_tiling(self) -> None:
        self.vae_tiling = False
        self._bind_vae_fns()

    def enable_vae_slicing(self) -> None:
        self.vae_slicing = True
        self._bind_vae_fns()

    def disable_vae_slicing(self) -> None:
        self.vae_slicing = False
        self._bind_vae_fns()

    def _init_sdxl(self) -> None:
        # the module's SDXLConfig, looked up here so that tests can shrink it;
        # as in JAX, unet/config.json is not read
        from fastdm_tpu_torch.models import sdxl

        self.cfg = sdxl.SDXLConfig(quant=self.quant)
        self.params = self._load_tree("unet", lambda: sdxl.sdxl_load(TensorSource.from_path(
            os.path.join(self.model_path, "unet"), self.device), self.cfg))
        self._load_vae()
        self.text_encoder = SDXLTextEncoder(self.model_path, self.device)

    def _load_controlnet(self, path: str) -> None:
        """A FLUX ControlNet (its config.json's hyperparameters over JAX's
        defaults of 5 dual, 0 single blocks and no guidance embedder; the
        engine's quant) or an SDXL one (the UNet's config), as the JAX
        engine's _load_controlnet (fastdm_tpu/engine.py:448-480)."""
        from fastdm_tpu_torch.models import controlnets

        src = TensorSource.from_path(path, self.device)
        if self.architecture == "flux":
            cj = _read_json(os.path.join(path, "config.json")) \
                if os.path.exists(os.path.join(path, "config.json")) else {}
            kw = {k: cj[k] for k in ("num_layers", "num_single_layers", "guidance_embeds",
                                     "patch_size", "in_channels", "out_channels",
                                     "attention_head_dim", "num_attention_heads",
                                     "joint_attention_dim", "pooled_projection_dim")
                  if cj.get(k) is not None}
            if cj.get("axes_dims_rope") is not None:
                kw["axes_dims_rope"] = tuple(cj["axes_dims_rope"])
            self.cn_cfg = controlnets.FluxControlNetConfig(quant=self.quant, **kw)
            self.cn_params = controlnets.flux_controlnet_load(src, self.cn_cfg)
        else:
            self.cn_cfg = self.cfg
            self.cn_params = controlnets.sdxl_controlnet_load(src, self.cfg)

    def _wan_vae_cfg(self):
        """WanVAEConfig overridden by vae/config.json (diffusers' names)."""
        from fastdm_tpu_torch.pipeline.wan_vae import WanVAEConfig

        return WanVAEConfig(**self._cfg_overrides(
            "vae", ("base_dim", "z_dim", "num_res_blocks", "patch_size", "is_residual"),
            {"latents_mean": lambda v: {"latents_mean": tuple(v)},
             "latents_std": lambda v: {"latents_std": tuple(v)},
             "dim_mult": lambda v: {"dim_mult": tuple(v)},
             # diffusers spells it 'temperal_downsample'
             "temperal_downsample": lambda v: {"temporal_downsample": tuple(v)}}))

    def _init_sd35(self) -> None:
        from fastdm_tpu_torch.models.sd35 import SD3Config, sd3_load

        kw = self._cfg_overrides(
            "transformer",
            ("sample_size", "patch_size", "in_channels", "out_channels", "num_layers",
             "attention_head_dim", "num_attention_heads", "joint_attention_dim",
             "caption_projection_dim", "pooled_projection_dim", "pos_embed_max_size"),
            {"dual_attention_layers": lambda v: {"num_dual_layers": len(v)}})
        self.cfg = SD3Config(quant=self.quant, **kw)
        self.params = self._load_tree("transformer", lambda: sd3_load(TensorSource.from_path(
            os.path.join(self.model_path, "transformer"), self.device), self.cfg))
        self._load_vae()
        self.text_encoder = SD3TextEncoder(self.model_path, device=self.device)

    def _init_qwen(self) -> None:
        from fastdm_tpu_torch.models.qwenimage import QwenImageConfig, qwen_load

        kw = self._cfg_overrides(
            "transformer",
            ("patch_size", "in_channels", "out_channels", "num_layers", "attention_head_dim",
             "num_attention_heads", "joint_attention_dim"),
            {"axes_dims_rope": lambda v: {"axes_dims_rope": tuple(v)}})
        self.cfg = QwenImageConfig(quant=self.quant, quant_mods=self.quant_mods, **kw)
        self.params = self._load_tree("transformer", lambda: qwen_load(TensorSource.from_path(
            os.path.join(self.model_path, "transformer"), self.device), self.cfg))
        self._load_vae()

    def _init_wan(self) -> None:
        from fastdm_tpu_torch.models.wan import WanConfig, wan_load
        from fastdm_tpu_torch.pipeline.wan_vae import wan_vae_load

        kw = self._cfg_overrides(
            "transformer",
            ("num_attention_heads", "attention_head_dim", "in_channels", "out_channels",
             "ffn_dim", "num_layers", "freq_dim", "text_dim", "image_dim",
             "added_kv_proj_dim"),
            {"patch_size": lambda v: {"patch_size": tuple(v)},
             "pos_embed_seq_len": lambda v: {"per_token_timestep": bool(v)}})
        dense_layers = self.sparse_attn.config.dense_layers if self.sparse_attn else 0
        self.cfg = WanConfig(quant=self.quant, dense_layers=dense_layers, **kw)
        # each generate derives its config (capacity knobs, sparse tables) from this one
        self._wan_cfg = self.cfg
        self.params = self._load_tree("transformer", lambda: wan_load(TensorSource.from_path(
            os.path.join(self.model_path, "transformer"), self.device), self.cfg))
        # Wan2.2-A14B: the low-noise expert, both resident (28 GB in int8
        # fits one 80 GB card; the JAX engine's host offload was for 16 GB)
        self.params_2 = None
        if os.path.isdir(os.path.join(self.model_path, "transformer_2")):
            self.params_2 = self._load_tree("transformer_2", lambda: wan_load(
                TensorSource.from_path(os.path.join(self.model_path, "transformer_2"),
                                       self.device), self.cfg))
        index = os.path.join(self.model_path, "model_index.json")
        self.boundary_ratio = (_read_json(index).get("boundary_ratio")
                               if os.path.exists(index) else None)
        self.text_encoder = WanTextEncoder(self.model_path, self.cfg.text_len, self.device)
        # Wan2.1-I2V: a transformer with the image embedder conditions on the
        # CLIP vision tower of image_encoder/ (fastdm_tpu/engine.py:745-758),
        # read at the first image
        self.wan_image_encoder = None
        if self.params.image_embedder is not None:
            self.wan_image_encoder = CLIPImageEncoder(
                os.path.join(self.model_path, "image_encoder"), self.device)
        self.vae_cfg = self._wan_vae_cfg()
        # as the JAX engine: a VAE that does not load leaves generate() with
        # latent output, and says so
        try:
            self.vae_params = wan_vae_load(TensorSource.from_path(
                os.path.join(self.model_path, "vae"), self.device), self.vae_cfg)
        except (NotImplementedError, FileNotFoundError, OSError, KeyError, ValueError) as e:
            print(f"FastDMEngine: the Wan VAE did not load ({e!r}); generate() returns "
                  "latents", flush=True)
            self.vae_params = None

    # ------------------------------------------------------------ generate

    def generate(self, prompt=None, task: Optional[str] = None, **kw):
        """FLUX text-to-image (prompt, height, width, num_inference_steps,
        guidance_scale, seed, num_images_per_prompt, or prompt_embeds and
        pooled_prompt_embeds, output_type), SD3.5 and SDXL text-to-image (the
        same, plus negative_prompt, or negative_prompt_embeds and
        negative_pooled_prompt_embeds, for CFG), Qwen-Image text-to-image
        (height, width, num_inference_steps, guidance_scale or
        true_cfg_scale, seed, prompt_embeds, negative_prompt_embeds for true
        CFG, output_type; prompt strings need the Qwen2.5-VL encoder, not in
        the port yet) or Wan text- and image-to-video (task t2v, i2v or ti2v;
        image, an (H, W, 3) uint8 first frame at height x width; prompt,
        negative_prompt or their embeddings; height, width, num_frames,
        num_inference_steps, guidance_scale, guidance_scale_2, seed,
        output_type). Given embeddings win over the strings.

        The image families take task "i2i" with image, an (H, W, 3) uint8
        array (a list of them for Kontext and Qwen-Image-Edit): FLUX, SD3.5
        and SDXL run SDEdit from the encoded image (strength, default 0.7,
        sets the first step), "flux-kontext" and Qwen-Image the reference /
        source tokens beside the noise; the output takes the (first) image's
        size, resized down to the model's granularity. As the JAX engine: an
        image with task None or "t2i" means i2i (i2v for Wan), "i2i" without
        an image runs t2i, and a Wan task other than i2v / ti2v leaves the
        image out.

        With controlnet_path, FLUX and SDXL take control_image (an (H, W, 3)
        uint8 hint at the output size) and controlnet_conditioning_scale,
        FLUX also control_mode (union checkpoints), SDXL guess_mode; with
        ip_adapter_path, SDXL takes ip_adapter_image (an (H, W, 3) uint8
        image for the CLIP vision tower of image_encoder/) or
        ip_adapter_image_embeds, which win. A Wan2.1-I2V checkpoint's i2v
        conditions on the image's CLIP tokens too."""
        image = kw.get("image")
        if self.architecture == "wan":
            tasks = ("t2v", "i2v", "ti2v")
            task = task or ("i2v" if image is not None else "t2v")
        else:
            tasks = ("t2i", "i2i")
            task = "i2i" if image is not None and task in (None, "t2i") else task or "t2i"
        if task not in tasks:
            raise NotImplementedError(f"task {task!r} is not in this slice of the port "
                                      f"({', '.join(tasks)} are)")
        if self.architecture == "wan":
            return self._generate_wan(prompt, task=task, **kw)
        if task != "i2i":
            kw.pop("image", None)
        return getattr(self, f"_generate_{self.architecture}")(prompt, **kw)

    def _to_uint8(self, x: torch.Tensor) -> np.ndarray:
        """[-1, 1] float -> uint8 in [0, 255] on the host."""
        x = (x * 0.5 + 0.5).clamp(0.0, 1.0)
        return (x * 255).round().to(torch.uint8).cpu().numpy()

    def _device_tensor(self, x, dtype) -> torch.Tensor:
        return as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
            device=self.device, dtype=dtype)

    def _image_tensor(self, image) -> torch.Tensor:
        """An (H, W, 3) uint8 image -> float32 in [-1, 1] on the device."""
        return self._device_tensor(image, torch.float32) / 127.5 - 1.0

    def _encode_image(self, image) -> torch.Tensor:
        """An (H, W, 3) uint8 image -> its (1, C, H/8, W/8) float32 latents
        through the bound VAE encoder."""
        return self._encode(self.vae_params, self._image_tensor(image)[None]).float()

    def _noise(self, shape, seed: int) -> torch.Tensor:
        """Latent noise from a seeded torch.Generator: the same seed gives
        other noise than the JAX engine's jax.random key."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)

    @staticmethod
    def _start_step(num_inference_steps: int, strength: float) -> int:
        """SDEdit's first step (fastdm_tpu/engine.py:912-915)."""
        return min(int(num_inference_steps * (1 - strength)), num_inference_steps - 1)

    def _flux_sched(self, ht: int, wt: int, num_inference_steps: int):
        return FlowMatchEulerScheduler.create(
            num_inference_steps, use_dynamic_shifting=True, mu=flow_match_shift_mu(ht * wt))

    def _generate_flux(self, prompt=None, negative_prompt=None, height: int = 1024,
                       width: int = 1024, num_inference_steps: int = 25,
                       guidance_scale: float = 3.5, seed: int = 42,
                       num_images_per_prompt: int = 1, prompt_embeds=None,
                       pooled_prompt_embeds=None, output_type: str = "np", image=None,
                       strength: float = 0.7, control_image=None,
                       controlnet_conditioning_scale: float = 1.0,
                       control_mode: Optional[int] = None,
                       max_sequence_length: Optional[int] = None):
        """negative_prompt is accepted and unused (FLUX runs no CFG), and a
        per-call max_sequence_length is ignored, the constructor's holding:
        both as the JAX engine, whose FLUX generate takes the one and drops
        the other."""
        from fastdm_tpu_torch.models.flux import flux_rope_cache
        from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents, \
            make_flux_cn_denoiser, make_flux_denoiser, make_flux_kontext_denoiser

        del negative_prompt, max_sequence_length
        self._require_controlnet(control_image)
        encoder, pooled = self._conditioning(prompt, prompt_embeds, pooled_prompt_embeds,
                                             num_images_per_prompt)
        b = encoder.shape[0]
        kontext = image is not None and self.architecture_full == "flux-kontext"
        if image is not None:
            images = list(image) if isinstance(image, (list, tuple)) else [image]
            images = [_resize_to_multiple(np.asarray(im), 16) for im in images]
            if not kontext:
                images = images[:1]  # SDEdit takes one source
            height, width = images[0].shape[0], images[0].shape[1]
        ht, wt = height // 16, width // 16

        if kontext:
            # the references' clean tokens after the noise, one id-plane each
            shapes = tuple((im.shape[0] // 16, im.shape[1] // 16) for im in images)
            cos, sin = flux_rope_cache(self.cfg, encoder.shape[1], ht, wt, ref_tokens_hw=shapes,
                                       device=self.device)
            ref = torch.cat([flux_pack_latents(self._encode_image(im)) for im in images], dim=1)
            ref = ref.expand(b, *ref.shape[1:])
            key = ("flux-kontext", ht, wt, shapes, num_inference_steps, guidance_scale)
            if key not in self._denoisers:
                self._denoisers[key] = make_flux_kontext_denoiser(
                    self.cfg, self._flux_sched(ht, wt, num_inference_steps),
                    num_inference_steps, self.cache_config, guidance_scale)
            latents = self._noise((b, ht * wt, self.cfg.in_channels), seed)
            latents, skips = self._denoisers[key](self.params, latents, ref, encoder, pooled,
                                                  cos, sin)
        elif control_image is not None:
            # ControlNet t2i (JAX's branch comes before SDEdit: an image only
            # sets the size): a latent hint is the encoded image, packed; a
            # raw-hint ControlNet takes the image itself (NCHW, bf16)
            cos, sin = flux_rope_cache(self.cfg, encoder.shape[1], ht, wt, device=self.device)
            if self.cn_params.input_hint_block is not None:
                hint = self._image_tensor(control_image).permute(2, 0, 1)[None].to(torch.bfloat16)
            else:
                hint = flux_pack_latents(self._encode_image(control_image))
            hint = hint.expand(b, *hint.shape[1:])
            key = ("flux-cn", ht, wt, num_inference_steps, guidance_scale,
                   controlnet_conditioning_scale, control_mode)
            if key not in self._denoisers:
                self._denoisers[key] = make_flux_cn_denoiser(
                    self.cfg, self.cn_cfg, self._flux_sched(ht, wt, num_inference_steps),
                    num_inference_steps, guidance_scale, controlnet_conditioning_scale,
                    control_mode)
            latents = self._noise((b, ht * wt, self.cfg.in_channels), seed)
            latents, skips = self._denoisers[key](self.params, self.cn_params, latents, hint,
                                                  encoder, pooled, cos, sin)
        else:
            cos, sin = flux_rope_cache(self.cfg, encoder.shape[1], ht, wt, device=self.device)
            start_step = (self._start_step(num_inference_steps, strength)
                          if image is not None else 0)
            key = ("flux", ht, wt, num_inference_steps, guidance_scale, start_step)
            if key not in self._denoisers:
                # the sigmas stay with their denoiser: mu follows the token count
                sched = self._flux_sched(ht, wt, num_inference_steps)
                self._denoisers[key] = (make_flux_denoiser(
                    self.cfg, sched, num_inference_steps, self.cache_config, guidance_scale,
                    start_step), sched.sigmas)
            run, sigmas = self._denoisers[key]
            latents = self._noise((b, ht * wt, self.cfg.in_channels), seed)
            if image is not None:  # SDEdit: the packed image noised to sigmas[start_step]
                packed = flux_pack_latents(self._encode_image(images[0]))
                sig = float(sigmas[start_step])
                latents = (1.0 - sig) * packed.expand(b, *packed.shape[1:]) + sig * latents
            latents, skips = run(self.params, latents, encoder, pooled, cos, sin)
        self._note_skips(skips)
        if output_type == "latent":
            return latents.cpu().numpy()
        return self._to_uint8(self._decode(self.vae_params, flux_unpack_latents(latents, ht, wt)))

    def _generate_sdxl(self, prompt=None, negative_prompt=None, height: int = 1024,
                       width: int = 1024, num_inference_steps: int = 25,
                       guidance_scale: float = 5.0, seed: int = 42,
                       num_images_per_prompt: int = 1, prompt_embeds=None,
                       pooled_prompt_embeds=None,
                       negative_prompt_embeds=None, negative_pooled_prompt_embeds=None,
                       output_type: str = "np", control_image=None,
                       controlnet_conditioning_scale: float = 1.0, guess_mode: bool = False,
                       ip_adapter_image=None, ip_adapter_image_embeds=None,
                       image=None, strength: float = 0.7):
        from fastdm_tpu_torch.pipeline.denoise_sdxl import make_sdxl_cn_denoiser, \
            make_sdxl_denoiser
        from fastdm_tpu_torch.pipeline.schedulers import EulerDiscreteScheduler

        self._require_controlnet(control_image)
        for name, value in (("ip_adapter_image", ip_adapter_image),
                            ("ip_adapter_image_embeds", ip_adapter_image_embeds)):
            if value is not None and self.ip_proj is None:
                raise ValueError(f"{name} needs an engine loaded with ip_adapter_path")
        embeds, pooled = self._cfg_embeds(guidance_scale, prompt, negative_prompt,
                                          num_images_per_prompt, prompt_embeds,
                                          pooled_prompt_embeds, negative_prompt_embeds,
                                          negative_pooled_prompt_embeds)
        b = embeds.shape[0] // (2 if guidance_scale > 1.0 else 1)
        # as JAX: a ControlNet run ignores image / strength and the IP tokens
        use_cn = control_image is not None
        if use_cn:
            image = None
        if image is not None:
            # sides at the UNet's granularity: 8 pixels a latent, halved at
            # each downsampling stage
            image = _resize_to_multiple(np.asarray(image),
                                        8 * 2 ** (len(self.cfg.block_channels) - 1))
            height, width = image.shape[0], image.shape[1]
        time_ids = torch.tensor([[height, width, 0, 0, height, width]] * embeds.shape[0],
                                dtype=torch.float32, device=self.device)
        lh, lw = height // 8, width // 8
        start_step = self._start_step(num_inference_steps, strength) if image is not None else 0
        key = ("sdxl", lh, lw, num_inference_steps, guidance_scale,
               use_cn and (controlnet_conditioning_scale, guess_mode), start_step)
        if key not in self._denoisers:
            sched = EulerDiscreteScheduler.create(num_inference_steps)
            self._denoisers[key] = (
                make_sdxl_cn_denoiser(self.cfg, sched, num_inference_steps, guidance_scale,
                                      controlnet_conditioning_scale, guess_mode) if use_cn
                else make_sdxl_denoiser(self.cfg, sched, num_inference_steps, guidance_scale,
                                        start_step), sched.init_noise_sigma, sched.sigmas)
        run, init_noise_sigma, sigmas = self._denoisers[key]
        noise = self._noise((b, self.cfg.in_channels, lh, lw), seed)
        if start_step:  # SDEdit (epsilon Euler): z + noise * sigmas[start_step]
            z = self._encode_image(image)
            latents = z.expand(b, *z.shape[1:]) + noise * float(sigmas[start_step])
        else:
            latents = noise * init_noise_sigma
        if use_cn:  # the hint in [0, 1], NCHW
            hint = (self._device_tensor(control_image, torch.float32) / 255.0).permute(2, 0, 1)
            latents, _ = run(self.params, self.cn_params, latents, embeds, pooled, time_ids,
                             hint[None].expand(b, -1, -1, -1))
        else:
            if ip_adapter_image_embeds is None and ip_adapter_image is not None:
                ip_adapter_image_embeds = self._ip_image_embeds(ip_adapter_image,
                                                                num_images_per_prompt)
            latents, _ = run(self.params, latents, embeds, pooled, time_ids,
                             self._ip_tokens(ip_adapter_image_embeds, guidance_scale))
        if output_type == "latent":
            return latents.cpu().numpy()
        return self._to_uint8(self._decode(self.vae_params, latents))

    def _require_controlnet(self, control_image) -> None:
        """A control_image needs a loaded ControlNet (JAX silently ignores it)."""
        if control_image is not None and self.cn_params is None:
            raise ValueError("control_image needs an engine loaded with controlnet_path")

    def _ip_image_embeds(self, image, num_images_per_prompt: int) -> torch.Tensor:
        """The CLIP image embeddings of an ip_adapter_image, as the JAX engine
        routes them (fastdm_tpu/engine.py:1164-1193): IP-Adapter-Plus takes
        the penultimate hidden states, the base adapter the projected
        image_embeds."""
        from fastdm_tpu_torch.layers.ip_adapter import IPAdapterPlusProjection

        plus = isinstance(self.ip_proj, IPAdapterPlusProjection)
        return self.image_encoder.encode(image, num_images_per_prompt, hidden_states=plus)

    def _ip_tokens(self, image_embeds, guidance_scale: float) -> Optional[torch.Tensor]:
        """The IP-Adapter context tokens of the CLIP image embeddings (zeros
        for the negative half under CFG, as diffusers and JAX), or None."""
        if image_embeds is None:
            return None
        with torch.inference_mode():
            tokens = self.ip_proj(self._device_tensor(image_embeds, torch.bfloat16))
        return torch.cat([torch.zeros_like(tokens), tokens]) if guidance_scale > 1.0 else tokens

    def _conditioning(self, prompt, embeds, pooled, num_images_per_prompt: int,
                      which: str = ""):
        """(embeds, pooled) in bf16 on the device: the given embeddings, or
        the prompt encoded by the family's text encoder (FLUX, SD3.5, SDXL;
        given embeddings win, as fastdm_tpu/engine.py:899)."""
        if embeds is not None:
            if pooled is None:
                raise ValueError(f"{which}prompt_embeds needs {which}pooled_prompt_embeds")
            return (self._device_tensor(embeds, torch.bfloat16),
                    self._device_tensor(pooled, torch.bfloat16))
        if prompt is None:
            raise ValueError(f"pass a {which}prompt or {which}prompt_embeds")
        return self.text_encoder.encode(prompt, num_images_per_prompt)

    def _cfg_embeds(self, guidance_scale, prompt, negative_prompt, num_images_per_prompt,
                    prompt_embeds, pooled_prompt_embeds, negative_prompt_embeds,
                    negative_pooled_prompt_embeds):
        """The batched-CFG conditioning of SD3.5 and SDXL: one batch of 2B,
        the negative half first (diffusers order), or the positive B alone
        without CFG. The negative is encoded only under CFG, from
        negative_prompt or "" (fastdm_tpu/engine.py:1048-1051,1103-1106); one
        negative string serves every prompt of the batch."""
        embeds, pooled = self._conditioning(prompt, prompt_embeds, pooled_prompt_embeds,
                                            num_images_per_prompt)
        if guidance_scale > 1.0:
            negative = negative_prompt or ""
            one = negative_prompt_embeds is None and isinstance(negative, str)
            neg, neg_pooled = self._conditioning(
                negative, negative_prompt_embeds, negative_pooled_prompt_embeds,
                1 if one else num_images_per_prompt, "negative_")
            if one:  # one row, serving every positive row
                neg = neg.expand(embeds.shape[0], *neg.shape[1:])
                neg_pooled = neg_pooled.expand(pooled.shape[0], *neg_pooled.shape[1:])
            embeds, pooled = torch.cat([neg, embeds]), torch.cat([neg_pooled, pooled])
        return embeds, pooled

    def _note_skips(self, skips: int) -> None:
        if self.cache_config is not None:
            self.last_cache_skips = int(skips)
            if self.verbose:
                print(f"cache skipped {self.last_cache_skips} transformer passes")

    def _generate_sd35(self, prompt=None, negative_prompt=None, height: int = 1024,
                       width: int = 1024, num_inference_steps: int = 25,
                       guidance_scale: float = 7.0, seed: int = 42,
                       num_images_per_prompt: int = 1, prompt_embeds=None,
                       pooled_prompt_embeds=None,
                       negative_prompt_embeds=None, negative_pooled_prompt_embeds=None,
                       output_type: str = "np", image=None, strength: float = 0.7):
        from fastdm_tpu_torch.models.sd35 import sd3_cropped_pos_embed
        from fastdm_tpu_torch.pipeline.denoise_sd3 import make_sd3_denoiser

        embeds, pooled = self._cfg_embeds(guidance_scale, prompt, negative_prompt,
                                          num_images_per_prompt, prompt_embeds,
                                          pooled_prompt_embeds, negative_prompt_embeds,
                                          negative_pooled_prompt_embeds)
        b = embeds.shape[0] // (2 if guidance_scale > 1.0 else 1)
        if image is not None:  # sides at 8 pixels a latent times the patch
            image = _resize_to_multiple(np.asarray(image), 8 * self.cfg.patch_size)
            height, width = image.shape[0], image.shape[1]
        lh, lw = height // 8, width // 8
        start_step = self._start_step(num_inference_steps, strength) if image is not None else 0
        key = ("sd35", lh, lw, num_inference_steps, guidance_scale, start_step)
        if key not in self._denoisers:
            # the denoiser, its sigmas and the cropped position table, once a resolution
            sched = FlowMatchEulerScheduler.create(num_inference_steps, shift=3.0)
            self._denoisers[key] = (
                make_sd3_denoiser(self.cfg, sched, num_inference_steps, guidance_scale,
                                  self.cache_config, start_step),
                sd3_cropped_pos_embed(self.cfg, self.params.pos_embed_table, lh, lw,
                                      device=self.device), sched.sigmas)
        run, pos_embed, sigmas = self._denoisers[key]
        latents = self._noise((b, self.cfg.in_channels, lh, lw), seed)
        if image is not None:  # SDEdit (flow match): (1 - sigma) z + sigma noise
            z = self._encode_image(image)
            sig = float(sigmas[start_step])
            latents = (1.0 - sig) * z.expand(b, *z.shape[1:]) + sig * latents
        latents, skips = run(self.params, latents, embeds, pooled, pos_embed)
        self._note_skips(skips)
        if output_type == "latent":
            return latents.cpu().numpy()
        return self._to_uint8(self._decode(self.vae_params, latents))

    def _generate_qwen(self, prompt=None, negative_prompt=None, height: int = 1024,
                       width: int = 1024,
                       num_inference_steps: int = 25, guidance_scale: float = 4.0,
                       true_cfg_scale: Optional[float] = None, seed: int = 42,
                       prompt_embeds=None, negative_prompt_embeds=None,
                       output_type: str = "np", image=None):
        """Qwen-Image, and with an image Qwen-Image-Edit: prompt_embeds (and
        negative_prompt_embeds) are then the VL encoder's output on the prompt
        and the images (JAX's encode_with_image)."""
        from fastdm_tpu_torch.models.qwenimage import qwen_rope_cos_sin
        from fastdm_tpu_torch.pipeline.denoise import flux_pack_latents, flux_unpack_latents
        from fastdm_tpu_torch.pipeline.denoise_qwen import make_qwen_denoiser, \
            make_qwen_edit_denoiser

        scale = true_cfg_scale if true_cfg_scale is not None else guidance_scale
        if prompt_embeds is None or (scale > 1.0 and negative_prompt_embeds is None):
            raise NotImplementedError(
                "the Qwen2.5-VL text encoder is not in this slice of the port (ROADMAP.md "
                "section 1 item 5, the Qwen2.5-VL tower); pass prompt_embeds (and, for true "
                "CFG, negative_prompt_embeds)")
        del prompt, negative_prompt
        pos = self._device_tensor(prompt_embeds, torch.bfloat16)
        neg = self._device_tensor(negative_prompt_embeds, torch.bfloat16) if scale > 1.0 \
            else pos
        # pad both to one length
        s = max(pos.shape[1], neg.shape[1])
        pos = torch.nn.functional.pad(pos, (0, 0, 0, s - pos.shape[1]))
        neg = torch.nn.functional.pad(neg, (0, 0, 0, s - neg.shape[1]))
        b = pos.shape[0]
        if image is not None:
            images = list(image) if isinstance(image, (list, tuple)) else [image]
            images = [_resize_to_multiple(np.asarray(im), 16) for im in images]
            height, width = images[0].shape[0], images[0].shape[1]
        ht, wt = height // 16, width // 16
        latents = self._noise((b, ht * wt, self.cfg.in_channels), seed)
        if image is not None:
            # the source images' clean tokens after the noise, entries 1, 2, ... of the rope
            src = torch.cat([flux_pack_latents(self._encode_image(im)) for im in images], dim=1)
            src = src.expand(b, *src.shape[1:])
            extra = tuple((1, im.shape[0] // 16, im.shape[1] // 16) for im in images)
            cos, sin = qwen_rope_cos_sin(self.cfg, 1, ht, wt, s, extra_shapes=extra,
                                         device=self.device)
            key = ("qwen-edit", ht, wt, num_inference_steps, scale, s, src.shape[1])
            if key not in self._denoisers:
                self._denoisers[key] = make_qwen_edit_denoiser(
                    self.cfg, self._flux_sched(ht, wt, num_inference_steps),
                    num_inference_steps, scale, self.cache_config)
            latents, skips = self._denoisers[key](self.params, latents, src, pos, neg, cos, sin)
        else:
            cos, sin = qwen_rope_cos_sin(self.cfg, 1, ht, wt, s, device=self.device)
            key = ("qwen", ht, wt, num_inference_steps, scale, s)
            if key not in self._denoisers:
                self._denoisers[key] = make_qwen_denoiser(
                    self.cfg, self._flux_sched(ht, wt, num_inference_steps),
                    num_inference_steps, scale, self.cache_config)
            latents, skips = self._denoisers[key](self.params, latents, pos, neg, cos, sin)
        self._note_skips(skips)
        if output_type == "latent":
            return latents.cpu().numpy()
        return self._to_uint8(self._decode(self.vae_params, flux_unpack_latents(latents, ht, wt)))

    def _wan_scheduler(self, num_steps: int):
        """UniPC (the Wan default, diffusers' WanPipeline) or FlowMatch-Euler,
        both at shift 5 (fastdm_tpu/engine.py:844-847)."""
        from fastdm_tpu_torch.pipeline.schedulers import UniPCMultistepScheduler

        if (self.scheduler_name or "unipc") == "unipc":
            return UniPCMultistepScheduler.create(num_steps, shift=5.0)
        return FlowMatchEulerScheduler.create(num_steps, shift=5.0)

    def _wan_encode(self, video: torch.Tensor) -> torch.Tensor:
        from fastdm_tpu_torch.pipeline.wan_vae import wan_vae_encode

        if self.vae_params is None:
            raise RuntimeError("Wan image-to-video needs the Wan VAE to encode the "
                               "conditioning frame, but the VAE checkpoint could not be loaded "
                               "(see the message at engine init)")
        return wan_vae_encode(self.vae_params, self.vae_cfg, video)

    def _wan_i2v_latents(self, image, lf: int, lh: int, lw: int, num_frames: int):
        """The i2v conditioning channels (fastdm_tpu/engine.py:1301-1326): a
        4-channel temporal mask (frame 0 visible, packed 4 frames a latent
        frame) and the encoded video of the image followed by num_frames - 1
        zero frames -> (1, 4 + C_z, lf, lh, lw) float32."""
        img = self._image_tensor(image)
        video = torch.cat([img[None], img.new_zeros(num_frames - 1, *img.shape)])[None]
        cond = self._wan_encode(video)
        msk = torch.zeros(1, num_frames, lh, lw, device=self.device)
        msk[:, 0] = 1.0
        msk = torch.cat([msk[:, :1].expand(-1, 4, -1, -1), msk[:, 1:]], dim=1)
        msk = msk.reshape(1, lf, 4, lh, lw).transpose(1, 2)
        return torch.cat([msk, cond], dim=1)

    def _generate_wan(self, prompt=None, negative_prompt=None, task: str = "t2v",
                      height: int = 480, width: int = 832, num_frames: int = 81,
                      num_inference_steps: int = 40, guidance_scale: float = 5.0,
                      guidance_scale_2: Optional[float] = None, seed: int = 42,
                      prompt_embeds=None, negative_prompt_embeds=None,
                      output_type: str = "np", image=None):
        from fastdm_tpu_torch.models.wan import wan_rope_cos_sin
        from fastdm_tpu_torch.pipeline.denoise_wan import (
            make_wan_cached_denoiser,
            make_wan_dual_phase_denoiser,
            make_wan_ti2v_denoiser,
        )
        from fastdm_tpu_torch.pipeline.wan_vae import wan_vae_decode, wan_vae_decode_chunked

        # the negative is always encoded, "" when None (fastdm_tpu/engine.py:1336-1337);
        # given embeddings win
        if prompt_embeds is None and prompt is None:
            raise ValueError("pass a prompt or prompt_embeds")
        pos = (self._device_tensor(prompt_embeds, torch.bfloat16) if prompt_embeds is not None
               else self.text_encoder.encode(prompt))
        neg = (self._device_tensor(negative_prompt_embeds, torch.bfloat16)
               if negative_prompt_embeds is not None
               else self.text_encoder.encode(negative_prompt or ""))
        # 4k+1 frames: the VAE's temporal stride (diffusers does the same)
        num_frames = max(1, 4 * ((num_frames - 1) // 4) + 1)
        # the spatial stride is 8 * patch_size (16 for the Wan2.2-TI2V VAE)
        vs = 8 * self.vae_cfg.patch_size
        lf, lh, lw = (num_frames - 1) // 4 + 1, height // vs, width // vs
        pt, ph, pw = self.cfg.patch_size
        tokens = (lf // pt) * (lh // ph) * (lw // pw)
        self.cfg = wan_capacity_config(self._wan_cfg, tokens, dual=self.params_2 is not None)
        sparse_mask, dense_steps = None, 0
        if self.sparse_attn is not None:
            mode = os.environ.get("FASTDM_SPARSE_GATHER", "super")
            self.cfg, sparse_mask = wan_sparse_tables(self.sparse_attn, self.cfg, tokens,
                                                      lf // pt, self.device, mode)
            dense_steps = self.sparse_attn.config.dense_steps
        cos, sin = wan_rope_cos_sin(self.cfg, lf, lh, lw, device=self.device)

        sched = self._wan_scheduler(num_inference_steps)
        # a seeded torch.Generator: the same seed gives other noise than the
        # JAX engine's jax.random key
        gen = torch.Generator(device=self.device).manual_seed(seed)
        latents = torch.randn((1, self.cfg.out_channels, lf, lh, lw), generator=gen,
                              device=self.device, dtype=torch.float32)
        if self.architecture_full == "wan2.2-ti2v" and image is not None and \
                task in ("i2v", "ti2v"):
            # Wan2.2-TI2V-5B: the encoded image is the first latent frame
            cond = self._wan_encode(self._image_tensor(image)[None, None])
            run = make_wan_ti2v_denoiser(self.cfg, sched, num_inference_steps, guidance_scale,
                                         self.cache_config, dense_steps)
            self.last_phase_steps = (num_inference_steps,)
            latents, skips = run(self.params, latents, cond, pos, neg, cos, sin, sparse_mask)
        else:
            cond = image_tokens = None
            if task == "i2v" and image is not None:
                cond = self._wan_i2v_latents(image, lf, lh, lw, num_frames)
                if self.wan_image_encoder is not None:
                    # Wan2.1-I2V: the CLIP penultimate tokens, the same for both
                    # CFG branches (fastdm_tpu/engine.py:1536-1545)
                    image_tokens = self.wan_image_encoder.encode(image, hidden_states=True)
            if self.params_2 is not None:
                boundary = self.boundary_ratio if self.boundary_ratio is not None else 0.875
                run = make_wan_dual_phase_denoiser(self.cfg, sched, num_inference_steps,
                                                   guidance_scale, guidance_scale_2, boundary,
                                                   dense_steps, cache_cfg=self.cache_config)
                experts = (self.params, self.params_2)
            else:
                run = make_wan_cached_denoiser(self.cfg, sched, num_inference_steps,
                                               self.cache_config, guidance_scale, dense_steps)
                experts = (self.params,)
            self.last_phase_steps = getattr(run, "phase_steps", (num_inference_steps,))
            latents, skips = run(*experts, latents, pos, neg, cos, sin, sparse_mask, cond,
                                 image_tokens)
        self._note_skips(skips)
        if output_type == "latent" or self.vae_params is None:
            return latents.cpu().numpy()
        decode = wan_vae_decode_chunked if lf > 8 else wan_vae_decode
        return self._to_uint8(decode(self.vae_params, self.vae_cfg, latents))
