"""CLIP's vision tower: transformers' CLIPVisionModel and
CLIPVisionModelWithProjection in plain PyTorch (the JAX package runs the
transformers module in torch f32, fastdm_tpu/pipeline/text_encoder.py:336-383:
the SDXL IP-Adapters' image encoder and Wan2.1-I2V's).

The module's attribute names are the checkpoint's (an image_encoder/
directory as save_pretrained writes it, "pre_layrnorm" spelled as there), so
it loads with load_state_dict. The forward is the port's own: the patch
embedding (a conv without bias, as a reshape and a matmul: no TF32 on the
card), the class token and the position table, pre_layrnorm, the pre-LN
layers of clip_text.py without a mask, post_layernorm on the class token and
the optional bias-free visual_projection. `penultimate` is hidden_states[-2]
counted as transformers counts it (hidden_states[0] is pre_layrnorm's
output): the input of the last layer. It runs in the parameters' dtype (f32,
as the reference) and launches no kernel of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.clip_text import _act, _Encoder, _layer_forward
from fastdm_tpu_torch.models.loader import TensorSource

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """transformers' CLIPVisionConfig fields the forward reads (ViT-H/14's
    defaults: Wan2.1-I2V's and ip-adapter-plus_sdxl_vit-h's image_encoder)."""
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    num_channels: int = 3
    projection_dim: int = 1024
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dir(cls, path: str) -> "CLIPVisionConfig":
        with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
            cj = json.load(f)
        cj = cj.get("vision_config", cj)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cj.items() if k in names and v is not None})

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    def to_json(self, projection: bool) -> dict:
        """The config.json transformers reads back for this config."""
        return dict(dataclasses.asdict(self), model_type="clip_vision_model",
                    architectures=["CLIPVisionModelWithProjection" if projection
                                   else "CLIPVisionModel"], torch_dtype="float32")


class CLIPVisionOutput(NamedTuple):
    last_hidden_state: Tensor      # (B, 1 + P, D), the last layer's output
    pooler_output: Tensor          # (B, D), post_layernorm of the class token
    penultimate: Tensor            # (B, 1 + P, D), hidden_states[-2]
    image_embeds: Optional[Tensor]  # (B, projection_dim) with the projection


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, p, p, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, d)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """The parameters of CLIPVisionModel (projection=False) or
    CLIPVisionModelWithProjection; the forward is clip_vision_forward()."""

    def __init__(self, cfg: CLIPVisionConfig, projection: bool = False):
        super().__init__()
        self.cfg, self.projection = cfg, projection
        self.vision_model = _VisionTransformer(cfg)
        if projection:
            self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixel_values: Tensor) -> CLIPVisionOutput:
        return clip_vision_forward(self, pixel_values)


def clip_vision_forward(model: CLIPVisionModel, pixel_values: Tensor) -> CLIPVisionOutput:
    """(B, C, S, S) pixel values at the config's image_size -> CLIPVisionOutput,
    in the parameters' dtype."""
    cfg, vm = model.cfg, model.vision_model
    emb = vm.embeddings
    w = emb.patch_embedding.weight
    b, c, hh, ww = pixel_values.shape
    p, s = cfg.patch_size, cfg.image_size
    if (c, hh, ww) != (cfg.num_channels, s, s):
        raise ValueError(f"the CLIP vision tower takes ({cfg.num_channels}, {s}, {s}) pixel "
                         f"values, got {tuple(pixel_values.shape[1:])}")
    g = s // p
    x = pixel_values.to(device=w.device, dtype=w.dtype)
    # the stride-p conv as a matmul on (C, p, p)-ordered patch vectors
    patches = x.reshape(b, c, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, c * p * p)
    tokens = patches @ w.reshape(w.shape[0], -1).t()
    cls = emb.class_embedding.to(tokens.dtype).expand(b, 1, -1)
    h = torch.cat([cls, tokens], dim=1) + emb.position_embedding.weight[None]
    h = vm.pre_layrnorm(h)
    act = _act(cfg.hidden_act)
    layers = vm.encoder.layers
    penultimate = h
    for i, layer in enumerate(layers):
        if i == len(layers) - 1:
            penultimate = h
        h = _layer_forward(layer, h, None, cfg.num_attention_heads, act)
    pooled = vm.post_layernorm(h[:, 0])
    image_embeds = model.visual_projection(pooled) if model.projection else None
    return CLIPVisionOutput(h, pooled, penultimate, image_embeds)


# ---------------------------------------------------------------- params

# keys a checkpoint may hold that the forward does not read: the position
# ids buffer of older transformers versions
_IGNORED = ("vision_model.embeddings.position_ids",)
PROJECTION = "visual_projection.weight"


def clip_vision_load(src: TensorSource, cfg: CLIPVisionConfig,
                     projection: Optional[bool] = None) -> CLIPVisionModel:
    """A CLIP vision tower from an image_encoder/ checkpoint onto src's device
    in f32 (the reference's torch_dtype). projection=None takes the
    visual_projection when the checkpoint holds one (Wan2.1's
    CLIPVisionModel holds none); False leaves one unread, as transformers'
    CLIPVisionModel does; any other unclaimed tensor raises."""
    if projection is None:
        projection = PROJECTION in src
    with torch.device("meta"):
        model = CLIPVisionModel(cfg, projection)
    sd = {k: src.tensor(k, torch.float32) for k in model.state_dict()}
    for k in _IGNORED + (() if projection else (PROJECTION,)):
        if k in src:
            src.take(k)
    src.assert_consumed()
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()


def clip_vision_init_random(seed: int, cfg: CLIPVisionConfig, projection: bool,
                            device="cuda") -> CLIPVisionModel:
    """Random f32 weights from a torch.Generator seeded with `seed`, drawn on
    `device` (smoke runs): linears and the patch embedding N(0, 1/fan_in),
    biases N(0, 0.02²), the class token and position table N(0, 1),
    LayerNorm weights 1 + N(0, 0.1²), biases 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        model = CLIPVisionModel(cfg, projection)
    sd = {}
    for k, p in model.state_dict().items():
        t = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
        if "norm" in k:
            t = 1.0 + 0.1 * t if k.endswith("weight") else torch.zeros_like(t)
        elif k.endswith("patch_embedding.weight"):
            t = t * p[0].numel() ** -0.5
        elif not k.endswith(("class_embedding", "position_embedding.weight")):
            t = t * (p.shape[-1] ** -0.5 if k.endswith("weight") else 0.02)
        sd[k] = t
    model.load_state_dict(sd, assign=True)
    return model.requires_grad_(False).eval()


def save_image_encoder(model: CLIPVisionModel, path: str, dtype=torch.float32) -> None:
    """A vision tower as an image_encoder/ directory that transformers'
    from_pretrained and clip_vision_load read: model.safetensors in `dtype`,
    config.json and the preprocessor_config.json that CLIP checkpoints ship
    (shortest edge and crop at image_size, OpenAI CLIP's mean and std,
    bicubic)."""
    from safetensors.torch import save_file

    from fastdm_tpu_torch.pipeline.image_processor import BICUBIC, OPENAI_CLIP_MEAN, \
        OPENAI_CLIP_STD

    os.makedirs(path, exist_ok=True)
    save_file({k: v.detach().to(device="cpu", dtype=dtype).contiguous()
               for k, v in model.state_dict().items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(model.cfg.to_json(model.projection), f)
    s = model.cfg.image_size
    with open(os.path.join(path, "preprocessor_config.json"), "w", encoding="utf-8") as f:
        json.dump({"image_processor_type": "CLIPImageProcessor", "do_resize": True,
                   "size": {"shortest_edge": s}, "resample": BICUBIC, "do_center_crop": True,
                   "crop_size": {"height": s, "width": s}, "do_rescale": True,
                   "rescale_factor": 1 / 255, "do_normalize": True,
                   "image_mean": list(OPENAI_CLIP_MEAN), "image_std": list(OPENAI_CLIP_STD),
                   "do_convert_rgb": True}, f)
