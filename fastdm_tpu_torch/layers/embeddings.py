"""Embeddings: timesteps, text projections, RoPE tables and the SD3 2D
sin-cos position table (port of fastdm_tpu/layers/embeddings.py, the parts
FLUX, SD3.5, Qwen-Image, Wan and the SDXL ControlNet use: its addition- and
encoder-projection variants, text / text_image / text_image_proj).

RoPE tables are computed on the host in float64 numpy (positions are fixed
per resolution, so this runs once per generation) and moved to the device as
float32 — the same precision path as the JAX package and the reference's
float64 freqs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.device import resolve_device
from fastdm_tpu_torch.layers.normalization import layer_norm
from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor


def get_timestep_embedding(
    timesteps: Tensor, embedding_dim: int, flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0, scale: float = 1.0, max_period: int = 10000,
) -> Tensor:
    """Sinusoidal timestep embedding of timesteps (N,), float32 math."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear1 -> SiLU -> linear2: the timestep/guidance MLP and, with the same
    shape, FLUX's pooled-text projection (PixArtAlphaTextProjection, silu)."""

    def __init__(self, linear1: QLinear, linear2: QLinear):
        super().__init__()
        self.linear1 = linear1
        self.linear2 = linear2

    def forward(self, x: Tensor) -> Tensor:
        return self.linear2(F.silu(self.linear1(x)))


class PixArtTextProjection(nn.Module):
    """linear1 -> tanh-GELU -> linear2: the Wan text embedder
    (PixArtAlphaTextProjection with act_fn "gelu_tanh", port of
    pixart_text_projection_apply; its SiLU form is TimestepEmbedding)."""

    def __init__(self, linear1: QLinear, linear2: QLinear):
        super().__init__()
        self.linear1 = linear1
        self.linear2 = linear2

    def forward(self, caption: Tensor) -> Tensor:
        return self.linear2(F.gelu(self.linear1(caption), approximate="tanh"))


class CombinedTimestepTextProj(nn.Module):
    """Timestep (+ optional guidance) sinusoid -> MLP, plus pooled-text MLP
    (port of combined_timestep_text_proj_apply)."""

    def __init__(self, timestep_embedder: TimestepEmbedding, text_embedder: TimestepEmbedding,
                 guidance_embedder: Optional[TimestepEmbedding] = None):
        super().__init__()
        self.timestep_embedder = timestep_embedder
        self.text_embedder = text_embedder
        self.guidance_embedder = guidance_embedder

    def forward(self, timestep: Tensor, pooled_projection: Tensor,
                guidance: Optional[Tensor] = None) -> Tensor:
        dt = pooled_projection.dtype
        t_proj = get_timestep_embedding(timestep, 256, flip_sin_to_cos=True,
                                        downscale_freq_shift=0.0)
        emb = self.timestep_embedder(t_proj.to(dt))
        if guidance is not None:
            g_proj = get_timestep_embedding(guidance, 256, flip_sin_to_cos=True,
                                            downscale_freq_shift=0.0)
            emb = emb + self.guidance_embedder(g_proj.to(dt))
        return emb + self.text_embedder(pooled_projection)


class TextImageProjection(nn.Module):
    """Kandinsky-2.1 text + image context: the image embedding expands to
    num_image_text_embeds tokens, prepended to the projected text tokens
    (port of text_image_projection_apply; encoder_hid_dim_type
    "text_image_proj")."""

    def __init__(self, image_embeds: QLinear, text_proj: QLinear,
                 num_image_text_embeds: int = 10):
        super().__init__()
        self.image_embeds, self.text_proj = image_embeds, text_proj
        self.num_image_text_embeds = num_image_text_embeds

    def forward(self, text_embeds: Tensor, image_embeds: Tensor) -> Tensor:
        img = self.image_embeds(image_embeds).reshape(text_embeds.shape[0],
                                                      self.num_image_text_embeds, -1)
        return torch.cat([img, self.text_proj(text_embeds)], dim=1)


class AttentionPooling(nn.Module):
    """One-query attention pooling of a token sequence -> (B, D): the class
    token is mean(x) plus a learned position embedding, q and k are each
    scaled by head_dim^-1/4, the softmax is f32 (port of
    attention_pooling_apply). Plain PyTorch, as the JAX function is plain
    jnp: no sdpa."""

    def __init__(self, positional_embedding: Tensor, q_proj: QLinear, k_proj: QLinear,
                 v_proj: QLinear):
        super().__init__()
        self.positional_embedding = nn.Parameter(positional_embedding, requires_grad=False)
        self.q_proj, self.k_proj, self.v_proj = q_proj, k_proj, v_proj

    def forward(self, x: Tensor, num_heads: int) -> Tensor:
        b, _, d = x.shape
        hd = d // num_heads
        cls = x.mean(dim=1, keepdim=True) + self.positional_embedding.to(x.dtype)
        xa = torch.cat([cls, x], dim=1)

        def heads(t):
            return t.reshape(b, -1, num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(cls)), heads(self.k_proj(xa)), heads(self.v_proj(xa))
        scale = 1.0 / math.sqrt(math.sqrt(hd))
        logits = torch.einsum("bhqc,bhkc->bhqk", q * scale, k * scale)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bhkc->bhqc", w, v).transpose(1, 2).reshape(b, d)


class TextTimeEmbedding(nn.Module):
    """LN -> attention pooling -> proj -> LN (port of
    text_time_embedding_apply; addition_embed_type "text")."""

    def __init__(self, norm1: nn.ParameterDict, pool: AttentionPooling, proj: QLinear,
                 norm2: nn.ParameterDict):
        super().__init__()
        self.norm1, self.pool, self.proj, self.norm2 = norm1, pool, proj, norm2

    def forward(self, hidden_states: Tensor, num_heads: int = 64) -> Tensor:
        h = layer_norm(hidden_states, self.norm1["gamma"], self.norm1["beta"], 1e-5)
        h = self.proj(self.pool(h, num_heads))
        return layer_norm(h, self.norm2["gamma"], self.norm2["beta"], 1e-5)


class TextImageTimeEmbedding(nn.Module):
    """LN(text_proj(text)) + image_proj(image) (port of
    text_image_time_embedding_apply; addition_embed_type "text_image")."""

    def __init__(self, text_proj: QLinear, text_norm: nn.ParameterDict, image_proj: QLinear):
        super().__init__()
        self.text_proj, self.text_norm, self.image_proj = text_proj, text_norm, image_proj

    def forward(self, text_embeds: Tensor, image_embeds: Tensor) -> Tensor:
        txt = layer_norm(self.text_proj(text_embeds), self.text_norm["gamma"],
                         self.text_norm["beta"], 1e-5)
        return txt + self.image_proj(image_embeds)


def rope_1d_freqs(dim: int, pos: np.ndarray, theta: float = 10000.0) -> np.ndarray:
    """(S, dim/2) float64 angles."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.outer(np.asarray(pos, np.float64), inv)


def flux_rope_cos_sin(
    ids, axes_dim: Sequence[int], theta: int = 10000, device="cuda",
) -> Tuple[Tensor, Tensor]:
    """3-axis RoPE tables for FLUX: ids (S, n_axes) position ids ->
    (cos, sin), each (S, sum(axes_dim)/2) float32 on `device`, one entry per
    rotation pair (interleaved application)."""
    ids_np = np.asarray(ids, np.float64)
    a = np.concatenate(
        [rope_1d_freqs(d, ids_np[:, i], theta) for i, d in enumerate(axes_dim)], axis=-1)
    dev = resolve_device(device)
    return (torch.from_numpy(np.cos(a).astype(np.float32)).to(dev),
            torch.from_numpy(np.sin(a).astype(np.float32)).to(dev))


def sincos_pos_embed_2d(embed_dim: int, grid_h: int, grid_w: int, *, base_size=None,
                        interpolation_scale: float = 1.0) -> np.ndarray:
    """2D sin-cos position table of SD3's PatchEmbed, (grid_h * grid_w,
    embed_dim) float64 on the host: the first half of each row encodes the
    column (w goes first, the diffusers convention), the second the row.
    base_size rescales the grid to base_size positions per side;
    interpolation_scale is taken only together with it."""
    gh = np.arange(grid_h, dtype=np.float64)
    gw = np.arange(grid_w, dtype=np.float64)
    if base_size is not None:
        gh = gh / (grid_h / base_size) / interpolation_scale
        gw = gw / (grid_w / base_size) / interpolation_scale
    elif interpolation_scale != 1.0:
        raise ValueError("interpolation_scale requires base_size (diffusers applies them "
                         "together); without it the scale would be silently dropped")
    grid = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid_h, grid_w)

    def one_axis(dim, positions):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", positions.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one_axis(embed_dim // 2, grid[0]),
                           one_axis(embed_dim // 2, grid[1])], axis=1)
