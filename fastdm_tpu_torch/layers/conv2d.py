"""Conv / GroupNorm primitives of the VAE (port of fastdm_tpu/layers/conv2d.py).

PyTorch idiom inside: NCHW activations and (out, in, kh, kw) weights, the
checkpoints' own layout. The numerics follow the JAX package: bf16 operands,
products and sums in f32 with the f32 bias added before one rounding to bf16;
GroupNorm in f32. The convolution runs on the f32 copies of the bf16 operands:
every bf16 value is exact in TF32, so cuDNN's default TF32 path on the card
still forms exact products with f32 accumulation.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def conv2d(params: Dict[str, Tensor], x: Tensor, stride: int = 1) -> Tensor:
    """'SAME'-padded conv (odd kernels), bf16 out."""
    w = params["w"]
    out = F.conv2d(x.float(), w.float(), params["b"].float(), stride=stride,
                   padding=w.shape[-1] // 2)
    return out.to(torch.bfloat16)


def group_norm(params: Optional[Dict[str, Tensor]], x: Tensor, groups: int,
               eps: float = 1e-6) -> Tensor:
    gamma = beta = None
    if params is not None:
        gamma, beta = params["gamma"].float(), params["beta"].float()
    return F.group_norm(x.float(), groups, gamma, beta, eps).to(x.dtype)


def upsample_nearest2x(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")
