"""Normalization layers (port of fastdm_tpu/layers/normalization.py, the FLUX
family). LayerNorm runs in float32 and casts back; the AdaLN modules hold a
QLinear modulation projection and return the modulated input plus the
gate/shift/scale chunks, in the JAX functions' order."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor


def layer_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last dim, no affine (the FLUX blocks' form), in f32
    with the biased variance, one cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), None, None, eps).to(x.dtype)


class AdaLayerNormZero(nn.Module):
    """adaLN-Zero, 6-chunk modulation. forward -> (modulated_x, gate_msa,
    shift_mlp, scale_mlp, gate_mlp) (port of ada_layer_norm_zero)."""

    def __init__(self, linear: QLinear):
        super().__init__()
        self.linear = linear

    def forward(self, x: Tensor, emb: Tensor, eps: float = 1e-6) -> Tuple[Tensor, ...]:
        mod = self.linear(F.silu(emb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        x = layer_norm(x, eps=eps) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return x, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """adaLN-Zero 3-chunk variant of the FLUX single blocks. forward ->
    (modulated_x, gate) (port of ada_layer_norm_zero_single)."""

    def __init__(self, linear: QLinear):
        super().__init__()
        self.linear = linear

    def forward(self, x: Tensor, emb: Tensor, eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
        shift_msa, scale_msa, gate_msa = self.linear(F.silu(emb)).chunk(3, dim=-1)
        x = layer_norm(x, eps=eps) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return x, gate_msa


class AdaLayerNormContinuous(nn.Module):
    """2-chunk (scale, shift) continuous AdaLN of the output head (port of
    ada_layer_norm_continuous)."""

    def __init__(self, linear: QLinear):
        super().__init__()
        self.linear = linear

    def forward(self, x: Tensor, conditioning: Tensor, eps: float = 1e-6) -> Tensor:
        scale, shift = self.linear(F.silu(conditioning).to(x.dtype)).chunk(2, dim=-1)
        return layer_norm(x, eps=eps) * (1 + scale)[:, None, :] + shift[:, None, :]
