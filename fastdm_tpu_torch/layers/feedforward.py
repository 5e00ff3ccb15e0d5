"""FeedForward (port of fastdm_tpu/layers/feedforward.py, with token
chunking): the tanh-GELU activation of the FLUX, SD3.5, Qwen-Image and Wan
blocks and the GEGLU of the SDXL blocks (hidden * GELU(gate), the gate in
the second half of the projection, through the gelu_and_mul kernel). The
other activations of the JAX module arrive with the models that use them."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.kernels import gelu_and_mul
from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor


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
        if activation_fn not in ("gelu-approximate", "geglu"):
            raise NotImplementedError(
                f"activation_fn {activation_fn!r} is not in the port yet (gelu-approximate "
                "and geglu are)")
        s = x.shape[-2]
        if chunk_tokens and s > chunk_tokens and s % chunk_tokens == 0:
            return torch.cat([self(x[..., i:i + chunk_tokens, :], activation_fn)
                              for i in range(0, s, chunk_tokens)], dim=-2)
        h = self.proj(x)
        if activation_fn == "geglu":
            return self.out(gelu_and_mul(h))
        return self.out(F.gelu(h, approximate="tanh"))
