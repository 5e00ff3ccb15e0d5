"""QLinear in bf16, int8 and fp8 (port of fastdm_tpu/layers/qlinear.py).

A QLinear holds w (K, N) — already transposed from the checkpoint's
(out, in) layout — an optional bias (N,) in bf16 and, for the W8A8 formats,
a per-output-channel f32 scale (N,) and, for int8, the int32 column sums
(N,) of w that the asymmetric-activation epilogue needs (azp_adj).

  bf16: a plain torch matmul, as the JAX package leaves it to XLA
        (qlinear.py:301-305): f32 accumulation, the bias joins before the
        one rounding (torch.addmm).
  int8: weights quantized per channel, symmetric, at load time; activations
        per token, ASYMMETRIC, at each call (quantize_to_int8 with
        symmetric=False), then int8_matmul with the fused dequant epilogue.
  fp8:  the same with e4m3 weights and symmetric per-token e4m3 activations
        (quantize_to_fp8, fp8_matmul).

The quantization mode is carried by the weight dtype, as in JAX. Layout: an
8-bit w is the (K, N) view ``w_t.t()`` of a K-contiguous (N, K) buffer (the
checkpoint's own layout), because the Hopper GEMM reads B K-contiguous
(csrc/w8a8_gemm.cu); shapes and the ops' contract stay JAX's, and
qlinear_slice_out still copies nothing. int4 / int4p (the W4A4 extension)
arrive with their own slice and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from fastdm_tpu_torch.kernels import fp8_matmul, int8_matmul, quantize_to_fp8, quantize_to_int8
from fastdm_tpu_torch.kernels.torch_backend import true_div

Tensor = torch.Tensor

_FP8_MAX = 448.0
_EIGHT_BIT = (torch.int8, torch.float8_e4m3fn)


def _param(t: Optional[Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


def k_contiguous(w: Tensor) -> Tensor:
    """The (K, N) view of a K-contiguous (N, K) buffer holding w (no copy when
    w is already one)."""
    return w.t().contiguous().t()


class QLinear(nn.Module):
    def __init__(self, w: Tensor, bias: Optional[Tensor] = None, scale: Optional[Tensor] = None,
                 colsum: Optional[Tensor] = None):
        super().__init__()
        if w.dtype in _EIGHT_BIT:
            if scale is None or (w.dtype == torch.int8) != (colsum is not None):
                raise ValueError(f"a {w.dtype} QLinear needs scale (and colsum for int8 only)")
            w = k_contiguous(w)
        self.w = _param(w)
        self.bias = _param(bias)
        self.scale = _param(scale)
        self.colsum = _param(colsum)

    def forward(self, x: Tensor, chunk_tokens: int = 0) -> Tensor:
        return qlinear_apply(self, x, chunk_tokens)


def _later(quant: str) -> NotImplementedError:
    return NotImplementedError(
        f"QLinear quant={quant!r} (W4A4) is not in the port yet: it arrives with the int4 "
        "slice, on the s8 GEMM; bf16, int8 and fp8 are")


def quantize_weight(w: Tensor, quant: Optional[str], bias: Optional[Tensor] = None) -> QLinear:
    """Quantize a (K, N) weight at load time: None/"bf16" stores it as bf16,
    "int8" per-channel symmetric (+ colsum), "fp8" per-channel symmetric e4m3
    (fastdm_tpu/layers/qlinear.py:108-135, the same f32 division and rounding)."""
    b = None if bias is None else bias.to(torch.bfloat16)
    if quant in (None, "bf16"):
        return QLinear(w.to(torch.bfloat16).contiguous(), b)
    if quant in ("int4", "int4p"):
        raise _later(quant)
    if quant not in ("int8", "fp8"):
        raise ValueError(f"unsupported quant type {quant!r}")
    w32 = w.float()
    amax = w32.abs().amax(dim=0).clamp_min(1e-12)
    if quant == "int8":
        scale = true_div(amax, 127.0)
        q = torch.round(w32 / scale[None, :]).clamp(-128, 127).to(torch.int8)
        return QLinear(q, b, scale, q.sum(dim=0, dtype=torch.int32))
    scale = true_div(amax, _FP8_MAX)
    q = (w32 / scale[None, :]).clamp(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn)
    return QLinear(q, b, scale)


def fuse_and_quantize(weights: Sequence[Tensor], biases: Sequence[Optional[Tensor]],
                      quant: Optional[str]) -> QLinear:
    """Concatenate fused projections (qkv / qkv+mlp) along N, then quantize.
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
    """Random QLinear drawn straight into its storage dtype on `device` (no f32
    master), as the JAX qlinear_random: bf16 w ~ N(0, 1) * w_std; int8 w
    uniform in [-127, 127] with scale w_std/127; fp8 w = e4m3(clip(N(0, 1) * 150,
    +-448)) with scale w_std/448; bias ~ N(0, 1) * 0.01."""
    k, n = in_features, out_features
    scale = colsum = None
    if quant in (None, "bf16"):
        w = torch.randn(k, n, generator=generator, device=device,
                        dtype=torch.bfloat16).mul_(w_std)
    elif quant == "int8":
        w = torch.randint(-127, 128, (n, k), generator=generator, device=device,
                          dtype=torch.int8).t()
        scale = torch.full((n,), w_std / 127.0, dtype=torch.float32, device=device)
        colsum = w.sum(dim=0, dtype=torch.int32)
    elif quant == "fp8":
        w = torch.randn(n, k, generator=generator, device=device, dtype=torch.bfloat16)
        w = w.mul_(150.0).clamp_(-_FP8_MAX, _FP8_MAX).to(torch.float8_e4m3fn).t()
        scale = torch.full((n,), w_std / _FP8_MAX, dtype=torch.float32, device=device)
    elif quant in ("int4", "int4p"):
        raise _later(quant)
    else:
        raise ValueError(f"unsupported quant type {quant!r}")
    b = None
    if bias:
        b = torch.randn(n, generator=generator, device=device, dtype=torch.bfloat16).mul_(0.01)
    return QLinear(w, b, scale, colsum)


def qlinear_slice_out(lin: QLinear, start: int, stop: int) -> QLinear:
    """A view of `lin` restricted to output columns [start, stop); exact:
    apply(slice) == apply(full)[..., start:stop] (per-token activation
    quantization does not depend on the columns). Weight columns, scale,
    colsum and bias are sliced; no weight is copied (an 8-bit w's columns are
    rows of its (N, K) buffer)."""
    def cut(t: Optional[Tensor]) -> Optional[Tensor]:
        return None if t is None else t[start:stop]

    return QLinear(lin.w[:, start:stop], cut(lin.bias), cut(lin.scale), cut(lin.colsum))


def qlinear_apply(lin: QLinear, x: Tensor, chunk_tokens: int = 0) -> Tensor:
    """y = x @ w (+ bias), x: (..., K) -> (..., N), with per-token activation
    quantization when w is int8 or fp8.

    chunk_tokens > 0 (dividing the flattened row count) runs the rows in
    chunks and concatenates: exact (quantization and epilogue are per row),
    and it bounds the matmul's transients to O(chunk * N)."""
    orig_shape = x.shape
    rows = 1
    for s in orig_shape[:-1]:
        rows *= s
    if chunk_tokens and rows > chunk_tokens and rows % chunk_tokens == 0:
        x2 = x.reshape(rows, orig_shape[-1])
        ys = [qlinear_apply(lin, x2[i:i + chunk_tokens]) for i in range(0, rows, chunk_tokens)]
        return torch.cat(ys, dim=0).reshape(*orig_shape[:-1], ys[0].shape[-1])
    w = lin.w
    x2 = x.reshape(-1, orig_shape[-1])
    if w.dtype == torch.int8:
        xq, xs, xzp = quantize_to_int8(x2, symmetric=False)
        out = int8_matmul(xq, w, xs, lin.scale, x.dtype, lin.colsum, xzp, lin.bias)
    elif w.dtype == torch.float8_e4m3fn:
        xq, xs = quantize_to_fp8(x2)
        out = fp8_matmul(xq, w, xs, lin.scale, x.dtype, lin.bias)
    elif w.dtype == torch.bfloat16:
        w = w.to(x.dtype)
        out = torch.addmm(lin.bias.to(x.dtype), x2, w) if lin.bias is not None else x2 @ w
    else:
        raise NotImplementedError(f"QLinear weight dtype {w.dtype} is not in the port")
    return out.reshape(*orig_shape[:-1], w.shape[-1])
