"""FeedForward (port of fastdm_tpu/layers/feedforward.py, the tanh-GELU
activation of the FLUX blocks). The GEGLU family needs the gelu_and_mul kernel
and arrives with the SDXL slice; the other activations and token chunking
arrive with the models that use them."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor


class FeedForward(nn.Module):
    def __init__(self, proj: QLinear, out: QLinear):
        super().__init__()
        self.proj = proj
        self.out = out

    def forward(self, x: Tensor, activation_fn: str = "gelu-approximate") -> Tensor:
        if activation_fn != "gelu-approximate":
            raise NotImplementedError(
                f"activation_fn {activation_fn!r} is not in this slice of the port "
                "(gelu-approximate is)")
        return self.out(F.gelu(self.proj(x), approximate="tanh"))
