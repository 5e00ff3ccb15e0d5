"""Prompt and image encoding on the engine's device (port of the CLIP / T5 /
UMT5 encoders of fastdm_tpu/pipeline/text_encoder.py:29-231 and of its CLIP
image encoder, :336-383).

The JAX package runs transformers' modules on the host CPU in torch f32;
the port runs its own tokenizers (pipeline/tokenizers.py) and modules
(models/clip_text.py, models/t5.py) on the engine's device, also in f32,
from the same diffusers tokenizer*/ and text_encoder*/ directories. Each
class is lazy: nothing is read until the first prompt, so an engine fed
precomputed embeddings never needs the directories, and a prompt on a
checkpoint without them raises FileNotFoundError naming the directory. No
class switches TF32 on. Each returns bf16 tensors on the device, repeated
per num_images_per_prompt as the reference's np.repeat:

  * FluxTextEncoder  -- CLIP-L's pooled token and T5 at max_sequence_length,
    T5 without a padding mask (as the reference);
  * SDXLTextEncoder  -- the penultimate states of CLIP-L and bigG
    concatenated (768 + 1280 = 2048), bigG's projected token pooled;
  * SD3TextEncoder   -- both CLIPs' penultimate states concatenated,
    zero-padded to T5's width and followed along the sequence by T5 at 256
    tokens, unmasked; the two projected tokens concatenated (2048);
  * WanTextEncoder   -- UMT5 at text_len with the padding mask, the
    positions past it zeroed.

CLIPImageEncoder runs the port's CLIP preprocessing
(pipeline/image_processor.py, transformers' pixel_values bit for bit) and
vision tower (models/clip_vision.py) in f32 on an image_encoder/ directory,
lazily as the text classes: the projected image_embeds (the SDXL IP-Adapter)
or the penultimate hidden states (IP-Adapter-Plus, Wan2.1-I2V), bf16 on the
device. A tower without visual_projection (Wan2.1's CLIPVisionModel) raises
on image_embeds, where JAX's CLIPVisionModelWithProjection would project
through randomly initialized weights.

The Qwen2.5-VL tower (QwenImageTextEncoder) is not in the port yet.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.models.clip_text import CLIPTextConfig, clip_text_load
from fastdm_tpu_torch.models.loader import TensorSource
from fastdm_tpu_torch.models.t5 import T5Config, t5_encoder_load
from fastdm_tpu_torch.pipeline.tokenizers import load_tokenizer

Tensor = torch.Tensor


def _subdir(model_path: str, name: str) -> str:
    path = os.path.join(model_path, name)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"prompt encoding needs {name}/ in the checkpoint, but {path!r} is not a "
            "directory; pass precomputed embeddings (prompt_embeds, ...) instead")
    return path


def _ids(tokenizer, prompt, max_length: int, device) -> Tuple[Tensor, Tensor]:
    ids, mask = tokenizer(prompt, max_length)
    return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)


def _bf16(x: Tensor, n: int) -> Tensor:
    return x.repeat_interleave(n, dim=0).to(torch.bfloat16)


class _Lazy:
    """Loads tokenizer*/ and text_encoder*/ pairs on first use. `loaded`
    turns True once they are in place; a caller that assigns the tokenizers
    and modules itself (a smoke run's random full-depth encoders) sets it to
    skip the directories."""

    def __init__(self, model_path: str, device="cuda"):
        self.model_path = model_path
        self.device = resolve_device(device)
        self.loaded = False

    def _tokenizer(self, name: str):
        return load_tokenizer(_subdir(self.model_path, name))

    def _clip(self, name: str, projection: bool):
        path = _subdir(self.model_path, name)
        return clip_text_load(TensorSource.from_path(path, self.device),
                              CLIPTextConfig.from_dir(path), projection)

    def _t5(self, name: str):
        path = _subdir(self.model_path, name)
        return t5_encoder_load(TensorSource.from_path(path, self.device), T5Config.from_dir(path))

    def load(self) -> None:
        if not self.loaded:
            self._load()
            self.loaded = True

    def _clip_states(self, tokenizer, encoder, prompt) -> Tuple[Tensor, Tensor]:
        """(hidden_states[-2], the projected pooled token) of one CLIP."""
        ids, _ = _ids(tokenizer, prompt, 77, self.device)
        out = encoder(ids)
        return out.penultimate, out.text_embeds


class FluxTextEncoder(_Lazy):
    """CLIP-L pooled + T5-XXL sequence embeddings (FLUX)."""

    def __init__(self, model_path: str, max_sequence_length: int = 512, device="cuda"):
        super().__init__(model_path, device)
        self.max_sequence_length = max_sequence_length

    def _load(self) -> None:
        self.tokenizer = self._tokenizer("tokenizer")
        self.text_encoder = self._clip("text_encoder", projection=False)
        self.tokenizer_2 = self._tokenizer("tokenizer_2")
        self.text_encoder_2 = self._t5("text_encoder_2")

    def encode(self, prompt, num_images_per_prompt: int = 1) -> Tuple[Tensor, Tensor]:
        """-> (prompt_embeds (B, L, 4096), pooled (B, 768)), bf16."""
        self.load()
        with torch.inference_mode():
            ids, _ = _ids(self.tokenizer, prompt, 77, self.device)
            pooled = self.text_encoder(ids).pooler_output
            ids2, _ = _ids(self.tokenizer_2, prompt, self.max_sequence_length, self.device)
            embeds = self.text_encoder_2(ids2)
        return _bf16(embeds, num_images_per_prompt), _bf16(pooled, num_images_per_prompt)


class SDXLTextEncoder(_Lazy):
    """Dual CLIP (L + bigG): per-token concat embeds (2048) + bigG pooled (1280)."""

    def _load(self) -> None:
        self.tokenizer = self._tokenizer("tokenizer")
        self.text_encoder = self._clip("text_encoder", projection=False)
        self.tokenizer_2 = self._tokenizer("tokenizer_2")
        self.text_encoder_2 = self._clip("text_encoder_2", projection=True)

    def encode(self, prompt, num_images_per_prompt: int = 1) -> Tuple[Tensor, Tensor]:
        """-> (prompt_embeds (B, 77, 2048), pooled (B, 1280)), bf16."""
        self.load()
        with torch.inference_mode():
            emb1, _ = self._clip_states(self.tokenizer, self.text_encoder, prompt)
            emb2, pooled = self._clip_states(self.tokenizer_2, self.text_encoder_2, prompt)
            embeds = torch.cat([emb1, emb2], dim=-1)
        return _bf16(embeds, num_images_per_prompt), _bf16(pooled, num_images_per_prompt)


class SD3TextEncoder(_Lazy):
    """CLIP-L + CLIP-bigG (pooled concat 2048) + T5 (4096), the CLIP states
    padded to T5's width and placed before T5's along the sequence."""

    def __init__(self, model_path: str, max_sequence_length: int = 256, device="cuda"):
        super().__init__(model_path, device)
        self.max_sequence_length = max_sequence_length

    def _load(self) -> None:
        self.tokenizer = self._tokenizer("tokenizer")
        self.text_encoder = self._clip("text_encoder", projection=True)
        self.tokenizer_2 = self._tokenizer("tokenizer_2")
        self.text_encoder_2 = self._clip("text_encoder_2", projection=True)
        self.tokenizer_3 = self._tokenizer("tokenizer_3")
        self.text_encoder_3 = self._t5("text_encoder_3")

    def encode(self, prompt, num_images_per_prompt: int = 1) -> Tuple[Tensor, Tensor]:
        """-> (prompt_embeds (B, 77 + L, 4096), pooled (B, 2048)), bf16."""
        self.load()
        with torch.inference_mode():
            e1, p1 = self._clip_states(self.tokenizer, self.text_encoder, prompt)
            e2, p2 = self._clip_states(self.tokenizer_2, self.text_encoder_2, prompt)
            ids3, _ = _ids(self.tokenizer_3, prompt, self.max_sequence_length, self.device)
            e3 = self.text_encoder_3(ids3)
            clip = torch.cat([e1, e2], dim=-1)
            clip = F.pad(clip, (0, e3.shape[-1] - clip.shape[-1]))
            embeds = torch.cat([clip, e3], dim=1)
            pooled = torch.cat([p1, p2], dim=-1)
        return _bf16(embeds, num_images_per_prompt), _bf16(pooled, num_images_per_prompt)


class WanTextEncoder(_Lazy):
    """UMT5-XXL sequence embeddings at a fixed text_len (Wan), zero past
    each prompt's tokens."""

    def __init__(self, model_path: str, text_len: int = 512, device="cuda"):
        super().__init__(model_path, device)
        self.text_len = text_len

    def _load(self) -> None:
        self.tokenizer = self._tokenizer("tokenizer")
        self.text_encoder = self._t5("text_encoder")

    def encode(self, prompt, num_videos_per_prompt: int = 1) -> Tensor:
        """-> prompt_embeds (B, text_len, 4096), bf16."""
        self.load()
        with torch.inference_mode():
            ids, mask = _ids(self.tokenizer, prompt, self.text_len, self.device)
            embeds = self.text_encoder(ids, mask) * mask[..., None]
        return _bf16(embeds, num_videos_per_prompt)


class CLIPImageEncoder:
    """The CLIP vision tower of an IP-Adapter or Wan2.1-I2V checkpoint's
    image_encoder/ (a CLIPVisionModelWithProjection, or a CLIPVisionModel
    without the projection) and its preprocessing, read at the first image;
    a missing directory raises FileNotFoundError naming it then. `loaded`
    as in _Lazy: a caller that assigns `model` and `processor` itself sets it."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        self.loaded = False

    def load(self) -> None:
        if self.loaded:
            return
        from fastdm_tpu_torch.models.clip_vision import CLIPVisionConfig, clip_vision_load
        from fastdm_tpu_torch.pipeline.image_processor import CLIPImageProcessor

        if not os.path.isdir(self.path):
            raise FileNotFoundError(
                f"image conditioning needs the CLIP image encoder, but {self.path!r} is not a "
                "directory; pass precomputed image embeddings instead")
        cfg = CLIPVisionConfig.from_dir(self.path)
        self.model = clip_vision_load(TensorSource.from_path(self.path, self.device), cfg)
        self.processor = CLIPImageProcessor.from_dir(self.path, cfg.image_size)
        self.loaded = True

    def encode(self, image, num_images_per_prompt: int = 1,
               hidden_states: bool = False) -> Tensor:
        """An (H, W, 3) uint8 image (or a list of them) -> (N, projection_dim)
        projected image_embeds, or with hidden_states=True the (N, 1 + P,
        hidden) penultimate states, bf16 on the device, each image's row
        repeated num_images_per_prompt times."""
        from fastdm_tpu_torch.models.clip_vision import PROJECTION

        self.load()
        if not hidden_states and not self.model.projection:
            raise ValueError(
                f"the image encoder at {self.path!r} has no {PROJECTION} (a "
                "CLIPVisionModel): its projected image_embeds do not exist; Wan2.1-I2V "
                "conditions on hidden_states=True")
        with torch.inference_mode():
            out = self.model(torch.from_numpy(self.processor(image)).to(self.device))
            emb = out.penultimate if hidden_states else out.image_embeds
        return _bf16(emb, num_images_per_prompt)


def save_text_encoder(model, path: str, dtype=torch.bfloat16) -> None:
    """A CLIP or T5 module as a text_encoder*/ directory (model.safetensors in
    `dtype`, config.json) that transformers' from_pretrained and the port's
    loaders read (synthetic checkpoints)."""
    import json

    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: v.detach().to(device="cpu", dtype=dtype).contiguous()
               for k, v in model.state_dict().items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(model.cfg.to_json(), f)
