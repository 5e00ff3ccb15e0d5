"""QLinear in bf16 (port of fastdm_tpu/layers/qlinear.py, bf16 path).

A QLinear holds w (K, N) — already transposed from the checkpoint's
(out, in) layout — and an optional bias (N,), both bf16. The product is a
plain torch matmul, as the JAX package leaves it to XLA (qlinear.py:301-305):
a bf16 matmul accumulates in f32 and the bias joins before the one rounding
(torch.addmm). The int8/fp8/int4 weight formats need the per-token quantize
and W8A8 GEMM kernels, which arrive with the next slice of the port; asking
for them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

Tensor = torch.Tensor

_LATER = ("QLinear quant={!r} needs the per-token quantize and W8A8 GEMM kernels "
          "(the W8A8 slice of the port); this slice runs bf16 only")


class QLinear(nn.Module):
    def __init__(self, w: Tensor, bias: Optional[Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: Tensor, chunk_tokens: int = 0) -> Tensor:
        return qlinear_apply(self, x, chunk_tokens)


def _check_quant(quant: Optional[str]) -> None:
    if quant not in (None, "bf16"):
        raise NotImplementedError(_LATER.format(quant))


def quantize_weight(w: Tensor, quant: Optional[str], bias: Optional[Tensor] = None) -> QLinear:
    """A (K, N) weight at load time; quant None/"bf16" stores it as bf16."""
    _check_quant(quant)
    return QLinear(w.to(torch.bfloat16).contiguous(),
                   None if bias is None else bias.to(torch.bfloat16))


def fuse_and_quantize(weights: Sequence[Tensor], biases: Sequence[Optional[Tensor]],
                      quant: Optional[str]) -> QLinear:
    """Concatenate fused projections (qkv / qkv+mlp) along N, then store.
    A mixed bias set zero-fills the bias-free segments."""
    w = weights[0] if len(weights) == 1 else torch.cat(list(weights), dim=1)
    bias = None
    if biases and any(b is not None for b in biases):
        segs = [b if b is not None else torch.zeros(wi.shape[1], dtype=torch.float32,
                                                    device=wi.device)
                for b, wi in zip(biases, weights)]
        bias = segs[0] if len(segs) == 1 else torch.cat(segs, dim=0)
    return quantize_weight(w, quant, bias)


def qlinear_random(generator: torch.Generator, in_features: int, out_features: int, *,
                   bias: bool = True, quant: Optional[str] = None, w_std: float = 0.02,
                   device="cuda") -> QLinear:
    """Random QLinear drawn straight into bf16 on `device` (no f32 master):
    w ~ N(0, 1) * w_std, bias ~ N(0, 1) * 0.01, as the JAX qlinear_random."""
    _check_quant(quant)
    w = torch.randn(in_features, out_features, generator=generator, device=device,
                    dtype=torch.bfloat16).mul_(w_std)
    b = None
    if bias:
        b = torch.randn(out_features, generator=generator, device=device,
                        dtype=torch.bfloat16).mul_(0.01)
    return QLinear(w, b)


def qlinear_slice_out(lin: QLinear, start: int, stop: int) -> QLinear:
    """A view of `lin` restricted to output columns [start, stop); exact:
    apply(slice) == apply(full)[..., start:stop]. No weight is copied."""
    return QLinear(lin.w[:, start:stop],
                   None if lin.bias is None else lin.bias[start:stop])


def qlinear_apply(lin: QLinear, x: Tensor, chunk_tokens: int = 0) -> Tensor:
    """y = x @ w (+ bias), x: (..., K) -> (..., N).

    chunk_tokens > 0 (dividing the flattened row count) runs the rows in
    chunks and concatenates: exact, and it bounds the matmul's transients to
    O(chunk * N)."""
    orig_shape = x.shape
    rows = 1
    for s in orig_shape[:-1]:
        rows *= s
    if chunk_tokens and rows > chunk_tokens and rows % chunk_tokens == 0:
        x2 = x.reshape(rows, orig_shape[-1])
        ys = [qlinear_apply(lin, x2[i:i + chunk_tokens]) for i in range(0, rows, chunk_tokens)]
        return torch.cat(ys, dim=0).reshape(*orig_shape[:-1], ys[0].shape[-1])
    w = lin.w
    if w.dtype != torch.bfloat16:
        raise NotImplementedError(_LATER.format(str(w.dtype)))
    x2 = x.reshape(-1, orig_shape[-1])
    w = w.to(x.dtype)
    if lin.bias is not None:
        out = torch.addmm(lin.bias.to(x.dtype), x2, w)
    else:
        out = x2 @ w
    return out.reshape(*orig_shape[:-1], w.shape[-1])
