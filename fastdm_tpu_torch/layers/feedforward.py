"""FeedForward (port of fastdm_tpu/layers/feedforward.py, with token
chunking) with the JAX module's five activations: the tanh-GELU of the FLUX,
SD3.5, Qwen-Image and Wan blocks ("gelu-approximate"), the GEGLU of the SDXL
blocks ("geglu": hidden * GELU(gate), the gate in the second half of the
projection, through the gelu_and_mul kernel), the exact erf GELU ("gelu"),
diffusers' ApproximateGELU ("geglu-approximate": h * sigmoid(1.702 h) on the
full projection) and SwiGLU ("swiglu": h[:d] * SiLU(h[d:]))."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.kernels import gelu_and_mul
from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor

ACTIVATIONS = ("gelu", "gelu-approximate", "geglu", "geglu-approximate", "swiglu")


class FeedForward(nn.Module):
    def __init__(self, proj: QLinear, out: QLinear):
        super().__init__()
        self.proj = proj
        self.out = out

    def forward(self, x: Tensor, activation_fn: str = "gelu-approximate",
                chunk_tokens: int = 0) -> Tensor:
        """chunk_tokens > 0 and dividing the token count (dim -2): run the
        FFN over token chunks and concatenate. Exact (every op is per row); the
        (tokens, ffn_dim) intermediates then exist at chunk size only."""
        if activation_fn not in ACTIVATIONS:
            raise ValueError(f"unknown activation_fn {activation_fn!r}")
        s = x.shape[-2]
        if chunk_tokens and s > chunk_tokens and s % chunk_tokens == 0:
            return torch.cat([self(x[..., i:i + chunk_tokens, :], activation_fn)
                              for i in range(0, s, chunk_tokens)], dim=-2)
        h = self.proj(x)
        if activation_fn == "gelu":
            h = F.gelu(h)
        elif activation_fn == "gelu-approximate":
            h = F.gelu(h, approximate="tanh")
        elif activation_fn == "geglu":
            h = gelu_and_mul(h)
        elif activation_fn == "geglu-approximate":
            h = h * torch.sigmoid(1.702 * h)
        else:
            d = h.shape[-1] // 2
            h = h[..., :d] * F.silu(h[..., d:])
        return self.out(h)
