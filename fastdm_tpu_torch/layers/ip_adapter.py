"""IP-Adapter image projections (port of fastdm_tpu/layers/ip_adapter.py):
the CLIP image embedding turned into the context tokens that the SDXL
cross-attention's IP-Adapter branch (models/sdxl.py SDXLAttention.ipadp_kv)
reads.

ImageProjection is one linear to num_tokens tokens and a LayerNorm
(ip-adapter_sdxl); IPAdapterPlusProjection is the Perceiver resampler of
ip-adapter-plus: learned latents read the CLIP penultimate states through
blocks of attention (the sdpa op, the kernel on a CUDA tensor) and an exact
erf-GELU feed-forward. LayerNorms are layers/normalization.py layer_norm with
eps 1e-5; the norms are {"gamma", "beta"} parameter dicts.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.kernels import scaled_dot_product_attention
from fastdm_tpu_torch.layers.normalization import layer_norm
from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor

_LN_EPS = 1e-5


def _ln(x: Tensor, norm) -> Tensor:
    return layer_norm(x, norm["gamma"], norm["beta"], _LN_EPS)


class ImageProjection(nn.Module):
    """CLIP image embedding (B, D) -> (B, num_tokens, C) context tokens
    (port of image_projection_apply)."""

    def __init__(self, proj: QLinear, norm: nn.ParameterDict, num_tokens: int = 4):
        super().__init__()
        self.proj, self.norm, self.num_tokens = proj, norm, num_tokens

    def forward(self, image_embeds: Tensor) -> Tensor:
        x = self.proj(image_embeds).reshape(image_embeds.shape[0], self.num_tokens, -1)
        return _ln(x, self.norm)


def multi_image_projection_apply(projections: Sequence[ImageProjection],
                                 image_embeds: Sequence[Tensor]) -> List[Tensor]:
    """One projection per adapter, each on its (B, N, D) embeddings of N
    images -> (B, N, num_tokens, C) (port of multi_image_projection_apply)."""
    out = []
    for proj, emb in zip(projections, image_embeds):
        b, n = emb.shape[0], emb.shape[1]
        tokens = proj(emb.reshape(b * n, *emb.shape[2:]))
        out.append(tokens.reshape(b, n, *tokens.shape[1:]))
    return out


class ResamplerBlock(nn.Module):
    """One Perceiver resampler block (port of _resampler_block): the latents
    attend to [LN(x); LN(latents)], then an LN + GELU feed-forward, both
    residual."""

    def __init__(self, norm0: nn.ParameterDict, norm1: nn.ParameterDict, q: QLinear,
                 kv: QLinear, out: QLinear, ff_norm: nn.ParameterDict, ff_proj: QLinear,
                 ff_out: QLinear):
        super().__init__()
        self.norm0, self.norm1 = norm0, norm1   # the input's, the latents'
        self.q, self.kv, self.out = q, kv, out
        self.ff_norm, self.ff_proj, self.ff_out = ff_norm, ff_proj, ff_out

    def forward(self, x: Tensor, latents: Tensor, heads: int, head_dim: int) -> Tensor:
        lat_n = _ln(latents, self.norm1)
        q = self.q(lat_n)
        kv = self.kv(torch.cat([_ln(x, self.norm0), lat_n], dim=-2))
        c = q.shape[-1]
        attn = scaled_dot_product_attention(q, kv[..., :c], kv[..., c:], heads, heads, head_dim,
                                            False, head_dim**-0.5)
        latents = self.out(attn.to(latents.dtype)) + latents
        h = F.gelu(self.ff_proj(_ln(latents, self.ff_norm)))
        return self.ff_out(h) + latents


class IPAdapterPlusProjection(nn.Module):
    """IP-Adapter-Plus resampler: CLIP penultimate states (B, S, embed_dims)
    -> (B, num_tokens, C) (port of ip_adapter_plus_projection_apply)."""

    def __init__(self, latents: Tensor, proj_in: QLinear, layers: List[ResamplerBlock],
                 proj_out: QLinear, norm_out: nn.ParameterDict, heads: int = 16,
                 head_dim: int = 64):
        super().__init__()
        self.latents = nn.Parameter(latents, requires_grad=False)  # (1, num_tokens, hidden)
        self.proj_in, self.proj_out, self.norm_out = proj_in, proj_out, norm_out
        self.layers = nn.ModuleList(layers)
        self.heads, self.head_dim = heads, head_dim

    @property
    def num_tokens(self) -> int:
        return self.latents.shape[-2]

    def forward(self, x: Tensor) -> Tensor:
        latents = self.latents.expand(x.shape[0], *self.latents.shape[1:])
        x = self.proj_in(x)
        for block in self.layers:
            latents = block(x, latents, self.heads, self.head_dim)
        return _ln(self.proj_out(latents), self.norm_out)
