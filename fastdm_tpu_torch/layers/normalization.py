"""Normalization layers (port of fastdm_tpu/layers/normalization.py, the FLUX,
SD3.5, Qwen-Image and Wan families). LayerNorm runs in float32 and casts back (fp32_layer_norm
returns the float32 result: the fp32 island the Wan modulation reads); the
AdaLN modules hold a QLinear modulation projection and return the modulated
input plus the gate/shift/scale chunks, in the JAX functions' order."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdm_tpu_torch.layers.qlinear import QLinear

Tensor = torch.Tensor


def layer_norm(x: Tensor, gamma: Optional[Tensor] = None, beta: Optional[Tensor] = None,
               eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last dim in f32 with the biased variance, then the
    optional affine (gamma, beta) in f32, one cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), None, None, eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def fp32_layer_norm(x: Tensor, gamma: Optional[Tensor] = None, beta: Optional[Tensor] = None,
                    eps: float = 1e-5) -> Tensor:
    """layer_norm computed and RETURNED in float32 (no round trip through x's
    dtype): the reference's FP32LayerNorm, whose output feeds the f32
    modulation (fastdm_tpu/layers/normalization.py:36-44)."""
    return layer_norm(x.float(), gamma, beta, eps)


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


class SD35AdaLayerNormZeroX(nn.Module):
    """SD3.5's 9-chunk adaLN of the dual-attention blocks. forward ->
    (modulated_x, gate_msa, shift_mlp, scale_mlp, gate_mlp, modulated_x2,
    gate_msa2) (port of sd35_ada_layer_norm_zero_x). Unlike AdaLayerNormZero
    it casts silu(emb) to x's dtype before the linear; both modulated
    outputs share one layer_norm."""

    def __init__(self, linear: QLinear):
        super().__init__()
        self.linear = linear

    def forward(self, x: Tensor, emb: Tensor, eps: float = 1e-6) -> Tuple[Tensor, ...]:
        mod = self.linear(F.silu(emb).to(x.dtype))
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
         shift_msa2, scale_msa2, gate_msa2) = mod.chunk(9, dim=-1)
        norm_x = layer_norm(x, eps=eps)
        x_mod = norm_x * (1 + scale_msa[:, None]) + shift_msa[:, None]
        x_mod2 = norm_x * (1 + scale_msa2[:, None]) + shift_msa2[:, None]
        return x_mod, gate_msa, shift_mlp, scale_mlp, gate_mlp, x_mod2, gate_msa2


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
