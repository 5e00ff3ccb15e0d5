"""Conv / GroupNorm primitives of the VAEs and the SDXL UNet (port of
fastdm_tpu/layers/conv2d.py).

PyTorch idiom inside: NCHW activations and (out, in, kh, kw) weights, the
checkpoints' own layout. The numerics follow the JAX package: bf16 operands,
products and sums in f32 with the f32 bias added before one rounding to bf16;
GroupNorm in f32. The convolution runs on the f32 copies of the bf16 operands:
every bf16 value is exact in TF32, so cuDNN's default TF32 path on the card
still forms exact products with f32 accumulation.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def same_padding(size: int, k: int, stride: int) -> tuple:
    """(before, after) padding of one spatial dim under XLA's "SAME": the
    output has ceil(size / stride) positions, the total padding is split with
    the smaller half first. For stride 1 and an odd kernel that is k // 2 on
    both sides; for the stride-2 3x3 downsampler of an even size it is 0
    before and 1 after (diffusers' Downsample2D pads 1 on both sides)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(params: Dict[str, Tensor], x: Tensor, stride: int = 1,
           padding: Union[str, int] = "SAME") -> Tensor:
    """Conv with bf16 out. padding "SAME" is the JAX package's geometry
    (same_padding; symmetric k // 2 at stride 1); an int pads that many on
    every side."""
    w = params["w"]
    x = x.float()
    if padding == "SAME":
        (top, bottom), (left, right) = (same_padding(x.shape[d], w.shape[d], stride)
                                        for d in (2, 3))
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = 0
    out = F.conv2d(x, w.float(), params["b"].float(), stride=stride, padding=padding)
    return out.to(torch.bfloat16)


def group_norm(params: Optional[Dict[str, Tensor]], x: Tensor, groups: int,
               eps: float = 1e-6) -> Tensor:
    gamma = beta = None
    if params is not None:
        gamma, beta = params["gamma"].float(), params["beta"].float()
    return F.group_norm(x.float(), groups, gamma, beta, eps).to(x.dtype)


def upsample_nearest2x(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")
